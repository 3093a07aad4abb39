"""Supercell particle table — replaces the per-cell dense table on the
single-chip fast path for ppc_axis == 1 configs.

The per-cell table (ops/celltable.py) pays one 64-lane row gather per CELL
(2M rows at 128^3) plus a 335 MB mask+transpose.  Binning at
supercell granularity cuts the gather to ncells/prod(F) rows (fatter rows:
Ks*8 lanes, still in the fast >=64-lane regime, and gather cost is
per-TRANSACTION) and shrinks the table ~2.5x:

  supercell slots: (sx, sy, Ks, 8, sz) f32, fields [px,py,pz, vx,vy,vz,
  present, 0], positions in CELL units, z minor; Ks = prod(F)*ppc^3 + 4.

The factor is F = (2, 2, 1): x/y pooled, z untouched — so the z-minor lane
axis keeps its full extent for every consumer, and parity splitting is
only needed along x/y
(4 classes).

Consumers recover per-cell semantics with membership masks (the particle's
cell id floor(p+0.5) is recomputed from the stored position — exact f32
arithmetic, so membership tests match ops/celltable.py bit-for-bit) and run
PARITY-SPLIT along the pooled axes: each (x, y) cell parity aligns with the
supercell pitch, so every window term is a plain aligned slice of the
padded table (no upsampling/repeat of the table is ever materialized).

Reference semantics preserved exactly as in ops/celltable.py:
  - slot order within a supercell = original particle-index order (stable
    sort), so first-member-wins == the reference's min-index tie-break
    (gpComputeClosestParticleNeighbors.hlsl first-wins);
  - P2G face neighborhoods are the reference's {-1,0} x {-1,0,1}^2 cell
    windows (gpTransferParticleVelocitiesU.hlsl:36-59), enforced with
    explicit cell-membership masks (the hat weight alone is nonzero for
    cells the reference's window excludes);
  - overflow (supercell rank >= Ks) is counted and index-captured for the
    same exact bounded corrections (celltable.seed_overflow_correction /
    _overflow_scatter are reused verbatim - they only touch overflow_idx).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from .common import cell_of, rank_ge
from .celltable import _overflow_scatter, seed_overflow_correction  # noqa: F401

F = (2, 2, 1)  # supercell factor per axis (z untouched: keep full lane rows)


def super_k(cfg: SimConfig) -> int:
    """Slots per supercell: nominal seeding density + headroom.  Pooling
    cells averages local density; overflow stays exact via the bounded
    corrections."""
    return F[0] * F[1] * F[2] * cfg.particles_per_cell_axis**3 + 4


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SuperTable:
    """slots: (sx, sy, Ks, 8, sz) f32 (fields as module docstring);
    n_overflow: scalar int32; overflow_idx: (overflow_cap,) int32."""

    slots: Any
    n_overflow: Any
    overflow_idx: Any


def _sdims(cfg: SimConfig):
    return cfg.nx // F[0], cfg.ny // F[1], cfg.nz // F[2]


def build_super_table(
    cfg: SimConfig, pos, vel, ks: int | None = None,
    overflow_cap: int | None = None,
) -> SuperTable:
    """Build the supercell table from positions in METERS.  overflow_cap
    defaults to cfg.overflow_cap (see step3d.overflow_autotune)."""
    Ks = super_k(cfg) if ks is None else ks
    overflow_cap = (
        cfg.overflow_cap if overflow_cap is None else overflow_cap
    )
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    assert nx % F[0] == 0 and ny % F[1] == 0 and nz % F[2] == 0
    sx, sy, sz = _sdims(cfg)
    nsup = sx * sy * sz
    m = jnp.array([nx, ny, nz], jnp.float32)
    pc = pos * m
    n = pc.shape[0]

    cell = cell_of(pc)
    lin = (
        (cell[:, 0] // F[0]) * sy + cell[:, 1] // F[1]
    ) * sz + cell[:, 2] // F[2]

    # Stable single-key sort carrying the particle index (as celltable).
    idx = jnp.arange(n, dtype=jnp.int32)
    lin_s, perm = jax.lax.sort((lin, idx), num_keys=1, is_stable=True)

    payload = jnp.concatenate(
        [pc, vel, jnp.ones((n, 1), jnp.float32), jnp.zeros((n, 1), jnp.float32)],
        axis=1,
    )
    payload_s = payload[perm]

    # Starts via histogram + exclusive cumsum; empty supercells inherit the
    # next occupied start.
    counts = jnp.zeros(nsup, jnp.int32).at[lin].add(1, mode="drop")
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(counts)])

    # ONE (Ks*8)-lane row gather per supercell over the windowed view
    # win[i] = sorted payload rows [i, i+Ks).
    pe = jnp.concatenate([payload_s, jnp.zeros((Ks, 8), jnp.float32)], axis=0)
    win = jnp.concatenate([pe[j : j + n] for j in range(Ks)], axis=1)
    src = jnp.minimum(starts[:nsup], n - 1)
    rows = win[src].reshape(nsup, Ks, 8)

    kk = jnp.arange(Ks, dtype=jnp.int32)
    present = (kk[None, :] < counts[:, None]).astype(jnp.float32)
    rows = rows * present[..., None]
    rows = rows.at[:, :, 6].set(present)
    slots = rows.reshape(sx, sy, sz, Ks, 8).transpose(0, 1, 3, 4, 2)

    n_overflow = (n - jnp.minimum(counts, Ks).sum()).astype(jnp.int32)
    cap = min(overflow_cap, n)

    def find_overflow(_):
        # rank >= Ks iff the key Ks positions earlier is equal (sorted
        # keys) — avoids the 1M-row starts[lin_s] gather (common.rank_ge).
        over = rank_ge(lin_s, Ks)
        (pos_s,) = jnp.nonzero(over, size=cap, fill_value=n)
        return jnp.where(pos_s < n, perm[jnp.minimum(pos_s, n - 1)], n).astype(
            jnp.int32
        )

    overflow_idx = jax.lax.cond(
        n_overflow > 0,
        find_overflow,
        lambda _: jnp.full(cap, n, jnp.int32) + 0 * perm[:1],
        operand=None,
    )
    return SuperTable(slots=slots, n_overflow=n_overflow, overflow_idx=overflow_idx)


def counts_from_super(cfg: SimConfig, st: SuperTable):
    """Per-CELL particle histogram from the supercell table (excludes
    overflow; see celltable.counts_from_table for the overflow addition)."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    slots = st.slots  # (sx, sy, Ks, 8, sz)
    present = slots[:, :, :, 6, :] > 0.0
    cxyz = [
        jnp.floor(slots[:, :, :, ax, :] + 0.5).astype(jnp.int32)
        for ax in range(3)
    ]
    out = jnp.zeros((nx, ny, nz), jnp.int32)
    for px in range(F[0]):
        for py in range(F[1]):
            for pz in range(F[2]):
                xg = (F[0] * jnp.arange(nx // F[0]) + px)[:, None, None, None]
                yg = (F[1] * jnp.arange(ny // F[1]) + py)[None, :, None, None]
                zg = (F[2] * jnp.arange(nz // F[2]) + pz)[None, None, None, :]
                member = (
                    present
                    & (cxyz[0] == xg)
                    & (cxyz[1] == yg)
                    & (cxyz[2] == zg)
                )
                out = out.at[px :: F[0], py :: F[1], pz :: F[2]].set(
                    member.sum(axis=2).astype(jnp.int32)
                )
    return out


# ---------------------------------------------------------------------------
# Level-set seeding (own-cell best candidate) from the supercell table.
# ---------------------------------------------------------------------------

def seed_closest_from_super(cfg: SimConfig, st: SuperTable, far: float):
    """Per-cell own-cell best candidate (phi0, cpos0), bit-identical to
    celltable.seed_closest_from_table: membership is an exact integer test
    on the stored position, d uses the same f32 expression, and ties pick
    the first member slot (= smallest original particle index)."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    r = jnp.float32(cfg.particle_radius)
    slots = st.slots  # (sx, sy, Ks, 8, sz)
    Ks = slots.shape[2]
    px = slots[:, :, :, 0, :]
    py = slots[:, :, :, 1, :]
    pz = slots[:, :, :, 2, :]
    present = slots[:, :, :, 6, :] > 0.0
    cx = jnp.floor(px + 0.5)
    cy = jnp.floor(py + 0.5)
    cz = jnp.floor(pz + 0.5)

    slot_ids = jax.lax.broadcasted_iota(jnp.int32, px.shape, 2)
    zg = (
        F[2] * jnp.arange(nz // F[2], dtype=jnp.float32)
    )[None, None, None, :]

    phi_parts = []
    cpos_parts = []
    for parx in range(F[0]):
        xg = (F[0] * jnp.arange(nx // F[0], dtype=jnp.float32) + parx)[
            :, None, None, None
        ]
        for pary in range(F[1]):
            yg = (F[1] * jnp.arange(ny // F[1], dtype=jnp.float32) + pary)[
                None, :, None, None
            ]
            member = present & (cx == xg) & (cy == yg) & (cz == zg)
            dx = px - xg
            dy = py - yg
            dz = pz - zg
            d = jnp.sqrt(dx * dx + dy * dy + dz * dz) - r
            d = jnp.where(member, d, jnp.inf)
            best = jnp.min(d, axis=2)
            is_best = d == best[:, :, None, :]
            first = jnp.min(jnp.where(is_best, slot_ids, Ks), axis=2)
            onehot = slot_ids == first[:, :, None, :]
            cp = jnp.stack(
                [jnp.where(onehot, c, 0.0).sum(axis=2) for c in (px, py, pz)],
                axis=-1,
            )
            seeded = jnp.isfinite(best)
            phi_parts.append(jnp.where(seeded, best, jnp.inf))
            cpos_parts.append(jnp.where(seeded[..., None], cp, far))

    phi0 = _interleave_xy(phi_parts, (nx, ny, nz))
    cpos0 = _interleave_xy(cpos_parts, (nx, ny, nz), trailing=(3,))
    return phi0, cpos0


def _interleave_xy(parts, dims, trailing=()):
    """parts: length F[0]*F[1] list in (parx, pary) order of
    (sx, sy, nz, *t) arrays -> (nx, ny, nz, *t) with x/y parity
    interleaved (z is not pooled)."""
    nx, ny, nz = dims
    sx, sy = nx // F[0], ny // F[1]
    a = jnp.stack(parts, axis=0).reshape(F[0], F[1], sx, sy, nz, *trailing)
    nt = len(trailing)
    perm = (2, 0, 3, 1, 4) + tuple(5 + i for i in range(nt))
    return a.transpose(perm).reshape(nx, ny, nz, *trailing)


# ---------------------------------------------------------------------------
# P2G transfer from the supercell table.
# ---------------------------------------------------------------------------

def p2g_from_super(cfg: SimConfig, st: SuperTable, pos=None, vel=None, pc=None):
    """Parity-split P2G, same result as celltable.p2g_from_table up to f32
    summation order: every MAC face accumulates hat-weighted velocity from
    the reference's {-1,0} x {-1,0,1}^2 cell neighborhood, with membership
    masks restricting supercell slots to exactly those cells.

    Returns (u, v, w, u_valid, v_valid, w_valid)."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    if pc is None and pos is not None:
        pc = pos * jnp.array([nx, ny, nz], jnp.float32)
    slots = st.slots  # (sx, sy, Ks, 8, sz)
    padded = jnp.pad(slots, ((1, 1), (1, 1), (0, 0), (0, 0), (1, 1)))

    def component(a: int, shape):
        # Parity split along pooled axes (x, y).  For face index
        # f = F*Fi + p along a pooled axis, the needed cells are {f-1, f}
        # (staggered axis a) or {f-1, f, f+1} (normal axes); the supercells
        # covering them are offsets {-1,0} (p=0) / {0} (p=1, staggered) /
        # {0,+1} (p=1, normal).  Along the unpooled z axis the offsets are
        # the plain cell offsets (supercell == cell).
        acc_parts = []
        amt_parts = []
        npar = [
            [(shape[ax] + F[ax] - 1 - p) // F[ax] for p in range(F[ax])]
            for ax in range(3)
        ]

        for parx in range(F[0]):
            for pary in range(F[1]):
                par = (parx, pary, 0)
                fshape = (npar[0][parx], npar[1][pary], shape[2])
                coords = []
                bshape = [
                    (fshape[0], 1, 1, 1),
                    (1, fshape[1], 1, 1),
                    (1, 1, 1, fshape[2]),
                ]
                for ax in range(3):
                    c = (
                        F[ax] * jnp.arange(fshape[ax], dtype=jnp.float32)
                        + par[ax]
                    ) if F[ax] > 1 else jnp.arange(
                        fshape[ax], dtype=jnp.float32
                    )
                    if ax == a:
                        c = c - 0.5
                    coords.append(c.reshape(bshape[ax]))

                acc = jnp.zeros(fshape, jnp.float32)
                amt = jnp.zeros(fshape, jnp.float32)
                offs = []
                for ax in range(3):
                    if F[ax] == 1:
                        offs.append((-1, 0) if ax == a else (-1, 0, 1))
                    elif par[ax] == 0:
                        offs.append((-1, 0))
                    elif ax == a:
                        offs.append((0,))
                    else:
                        offs.append((0, 1))
                for ox in offs[0]:
                    for oy in offs[1]:
                        for oz in offs[2]:
                            win = padded[
                                1 + ox : 1 + ox + fshape[0],
                                1 + oy : 1 + oy + fshape[1],
                                :,
                                :,
                                1 + oz : 1 + oz + fshape[2],
                            ]
                            p3 = (
                                win[:, :, :, 0, :],
                                win[:, :, :, 1, :],
                                win[:, :, :, 2, :],
                            )
                            velc = win[:, :, :, 3 + a, :]
                            wgt = win[:, :, :, 6, :]  # present
                            for ax in range(3):
                                rel = p3[ax] - coords[ax]
                                wgt = wgt * jnp.maximum(0.0, 1.0 - jnp.abs(rel))
                                if F[ax] == 1:
                                    # window == reference window; no mask.
                                    continue
                                # Reference window: cell in {f-1, f}
                                # (staggered) / {f-1, f, f+1} (normal).
                                cell_ax = jnp.floor(p3[ax] + 0.5)
                                if ax == a:
                                    lo = coords[ax] - 0.5  # == f-1
                                    ok = (cell_ax >= lo) & (cell_ax <= lo + 1)
                                else:
                                    ok = jnp.abs(cell_ax - coords[ax]) <= 1.0
                                wgt = wgt * ok
                            acc = acc + (wgt * velc).sum(2)
                            amt = amt + wgt.sum(2)
                acc_parts.append(acc)
                amt_parts.append(amt)

        acc = _interleave_faces_xy(acc_parts, shape)
        amt = _interleave_faces_xy(amt_parts, shape)

        if pc is not None:
            acc, amt = _overflow_scatter(cfg, st, pc, vel, a, shape, acc, amt)

        g = acc / jnp.maximum(amt, jnp.float32(1e-30))
        valid = amt > cfg.zero_thresh
        for edge in (0, (nx, ny, nz)[a]):
            sl = [slice(None)] * 3
            sl[a] = edge
            g = g.at[tuple(sl)].set(0.0)
            valid = valid.at[tuple(sl)].set(True)
        return g, valid

    u, uv = component(0, (nx + 1, ny, nz))
    v, vv = component(1, (nx, ny + 1, nz))
    w, wv = component(2, (nx, ny, nz + 1))
    return u, v, w, uv, vv, wv


def _interleave_faces_xy(parts, shape):
    """parts: length F[0]*F[1] list in (parx, pary) order of per-parity face
    grids (possibly uneven sizes along the staggered axis) -> full `shape`
    face grid (z unpooled)."""
    tgt = tuple((shape[ax] + F[ax] - 1) // F[ax] for ax in range(2))
    padded = []
    for p in parts:
        pad = [(0, tgt[0] - p.shape[0]), (0, tgt[1] - p.shape[1]), (0, 0)]
        padded.append(jnp.pad(p, pad))
    a = jnp.stack(padded, axis=0).reshape(F[0], F[1], tgt[0], tgt[1], shape[2])
    a = a.transpose(2, 0, 3, 1, 4).reshape(
        tgt[0] * F[0], tgt[1] * F[1], shape[2]
    )
    return a[: shape[0], : shape[1], :]
