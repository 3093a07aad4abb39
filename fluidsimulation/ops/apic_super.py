"""Supercell APIC table — the (2,2,1)-pooled binning of ops/supertable.py
applied to the 16-field APIC payload (ops/apic.py::ApicTable).

Why (byte arithmetic): at ppc_axis == 1 the
per-cell ApicTable allocates K = ppc^3 + 4 = 5 slots/cell, so the table is
(ncells, 5, 16) f32 — 671 MB at 128^3 — and the fused union-window P2G
(ops/apic.py::p2g_apic_from_table_fused) reads 54 shifted windows of it.
Pooling 2x2x1 cells (Ks = 4*ppc^3 + 4 = 8 slots/supercell) cuts the table
2.5x (268 MB) and the build's window gather 4x (ncells/4 rows, same
128-lane fast-gather width), and the parity-split quadratic windows read
~0.67x the volume (<= 25 window passes per parity class over a 2.5x
smaller table vs 54 over the full one).  At ppc_axis >= 2 the pooled
windows read ~2x more slots per face than the per-cell table — exactly the
FLIP supertable trade — so the same gate applies
(solver/step3d.py::use_super_table).

Semantics (all inherited from the proven FLIP supertable patterns):

* slot order within a supercell = original particle-index order (stable
  sort) — so level-set seeding from this table is bit-identical to the
  per-cell ApicTable seeding (supertable.seed_closest_from_super reads
  only fields 0-2/6, which are layout-shared; tested).
* The fused P2G needs NO membership masks: quadratic-spline weights
  vanish outside |d| < 1.5 per axis, every enumerated supercell offset is
  a distinct supercell (no double counting), and the per-parity offset
  lists cover the full {-1..2} cell-offset support (proof in
  p2g_apic_from_super_fused).  Unlike FLIP's hat windows there is no
  reference window stricter than the kernel support
  (gpTransferParticleVelocitiesU.hlsl:36-59 has none for splines — APIC
  is an extension family; the spline support IS the window).
* overflow (supercell rank >= Ks) is counted and index-captured for the
  same exact bounded corrections (_apic_overflow_scatter /
  seed_overflow_correction only touch overflow_idx).

Equality: P2G matches the per-cell fused form up to f32 summation order
(slots are grouped 4-cells-per-supercell, so face sums reassociate);
seeding is bit-identical.  Both tested (tests/test_apic_super.py).
"""

from __future__ import annotations

import dataclasses as _dc
from typing import Any as _Any

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from .apic import _finalize_apic_faces, _quad_spline
from .common import cell_of, rank_ge
from .supertable import F, _interleave_xy, _sdims, super_k


@jax.tree_util.register_dataclass
@_dc.dataclass
class ApicSuperTable:
    """slots: (sx, sy, Ks, 16, sz) f32, fields as ApicTable (positions in
    cell units, present at 6); n_overflow: scalar int32; overflow_idx:
    (cap,) int32 particle indices (== N when unused)."""

    slots: _Any
    n_overflow: _Any
    overflow_idx: _Any


def build_apic_super_table(cfg: SimConfig, pos, vel, C,
                           ks: int | None = None,
                           overflow_cap: int | None = None):
    """supertable.build_super_table with the 16-field APIC payload.
    One (Ks*16)-lane row gather per supercell (128 lanes at ppc1 —
    the fast >= 64-lane gather regime)."""
    Ks = super_k(cfg) if ks is None else ks
    if overflow_cap is None:
        overflow_cap = cfg.overflow_cap
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    assert nx % F[0] == 0 and ny % F[1] == 0 and nz % F[2] == 0
    sx, sy, sz = _sdims(cfg)
    nsup = sx * sy * sz
    Fq = 16
    m = jnp.array([nx, ny, nz], jnp.float32)
    pc = pos * m
    n = pc.shape[0]

    cell = cell_of(pc)
    lin = (
        (cell[:, 0] // F[0]) * sy + cell[:, 1] // F[1]
    ) * sz + cell[:, 2] // F[2]

    idx = jnp.arange(n, dtype=jnp.int32)
    lin_s, perm = jax.lax.sort((lin, idx), num_keys=1, is_stable=True)

    payload = jnp.concatenate(
        [pc, vel, jnp.ones((n, 1), jnp.float32), C.reshape(n, 9)], axis=1
    )
    payload_s = payload[perm]

    counts = jnp.zeros(nsup, jnp.int32).at[lin].add(1, mode="drop")
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(counts)])

    pe = jnp.concatenate([payload_s, jnp.zeros((Ks, Fq), jnp.float32)], axis=0)
    win = jnp.concatenate([pe[j: j + n] for j in range(Ks)], axis=1)
    src = jnp.minimum(starts[:nsup], n - 1)
    rows = win[src].reshape(nsup, Ks, Fq)

    kk = jnp.arange(Ks, dtype=jnp.int32)
    present = (kk[None, :] < counts[:, None]).astype(jnp.float32)
    rows = rows * present[..., None]
    rows = rows.at[:, :, 6].set(present)
    slots = rows.reshape(sx, sy, sz, Ks, Fq).transpose(0, 1, 3, 4, 2)

    n_overflow = (n - jnp.minimum(counts, Ks).sum()).astype(jnp.int32)
    cap = min(overflow_cap, n)

    def find_overflow(_):
        over = rank_ge(lin_s, Ks)
        (pos_s,) = jnp.nonzero(over, size=cap, fill_value=n)
        return jnp.where(pos_s < n, perm[jnp.minimum(pos_s, n - 1)],
                         n).astype(jnp.int32)

    overflow_idx = jax.lax.cond(
        n_overflow > 0, find_overflow,
        lambda _: jnp.full(cap, n, jnp.int32) + 0 * perm[:1], operand=None,
    )
    return ApicSuperTable(slots=slots, n_overflow=n_overflow,
                          overflow_idx=overflow_idx)


def p2g_apic_from_super_fused(cfg: SimConfig, table: ApicSuperTable,
                              pos, vel, C):
    """Parity-split fused union-window P2G over the supercell table.

    Same cell-indexed-accumulator trick as p2g_apic_from_table_fused:
    comp k's face at cell c sits at c + 0.5*e_k, so its quadratic-spline
    support is cell offsets {-1..2} along k and {-1..1} along the other
    axes.  Along a pooled axis, output cells of parity p (c = 2s + p)
    reach supercell offsets o covering cell offsets {2o-p, 2o-p+1}:

      p=0: o in {-1,0,1}  covers cells {-2..3}  (superset of {-1..2})
      p=1: o in {0,1}     covers cells {-1..2}  (exact)

    Every enumerated supercell is distinct (each particle contributes at
    most once) and out-of-support slots get zero spline weight, so no
    membership masks are needed.  A comp is skipped for a pass when its
    non-staggered axes can only see cell offsets >= 2 (zero weight) —
    the supercell analogue of the cell form's 54/64 active filter."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    m = jnp.array([nx, ny, nz], jnp.float32)
    pc = pos * m
    sx, sy = nx // F[0], ny // F[1]
    slots = table.slots  # (sx, sy, Ks, 16, sz), sz == nz
    padded = jnp.pad(slots, ((1, 1), (1, 1), (0, 0), (0, 0), (1, 2)))

    cz = jnp.arange(nz, dtype=jnp.float32).reshape(1, 1, 1, nz)
    acc_parts = [[], [], []]
    amt_parts = [[], [], []]

    for parx in range(F[0]):
        cx = (F[0] * jnp.arange(sx, dtype=jnp.float32) + parx
              ).reshape(sx, 1, 1, 1)
        for pary in range(F[1]):
            cy = (F[1] * jnp.arange(sy, dtype=jnp.float32) + pary
                  ).reshape(1, sy, 1, 1)
            fcoords = [
                (cx + 0.5, cy, cz),
                (cx, cy + 0.5, cz),
                (cx, cy, cz + 0.5),
            ]
            shp = (sx, sy, nz)
            accs = [jnp.zeros(shp, jnp.float32) for _ in range(3)]
            amts = [jnp.zeros(shp, jnp.float32) for _ in range(3)]
            xoffs = (-1, 0, 1) if parx == 0 else (0, 1)
            yoffs = (-1, 0, 1) if pary == 0 else (0, 1)
            for ox in xoffs:
                for oy in yoffs:
                    for oz in (-1, 0, 1, 2):
                        # Minimum cell offset this pass can see per axis.
                        mino = (F[0] * ox - parx, F[1] * oy - pary, oz)
                        comps = [k for k in range(3)
                                 if all(mino[ax] <= 1 for ax in range(3)
                                        if ax != k)]
                        if not comps:
                            continue
                        win = padded[
                            1 + ox: 1 + ox + sx,
                            1 + oy: 1 + oy + sy,
                            :, :,
                            1 + oz: 1 + oz + nz,
                        ]
                        px = win[:, :, :, 0, :]
                        py = win[:, :, :, 1, :]
                        pz = win[:, :, :, 2, :]
                        present = win[:, :, :, 6, :]
                        for k in comps:
                            fx, fy, fz = fcoords[k]
                            ddx = fx - px
                            ddy = fy - py
                            ddz = fz - pz
                            wgt = (_quad_spline(ddx) * _quad_spline(ddy)
                                   * _quad_spline(ddz) * present)
                            velc = win[:, :, :, 3 + k, :]
                            c0 = win[:, :, :, 7 + 3 * k, :]
                            c1 = win[:, :, :, 8 + 3 * k, :]
                            c2 = win[:, :, :, 9 + 3 * k, :]
                            val = (velc + c0 * (ddx / m[0])
                                   + c1 * (ddy / m[1]) + c2 * (ddz / m[2]))
                            accs[k] = accs[k] + (wgt * val).sum(2)
                            amts[k] = amts[k] + wgt.sum(2)
            for k in range(3):
                acc_parts[k].append(accs[k])
                amt_parts[k].append(amts[k])

    dims = (nx, ny, nz)
    accs = [_interleave_xy(acc_parts[k], dims) for k in range(3)]
    amts = [_interleave_xy(amt_parts[k], dims) for k in range(3)]
    return _finalize_apic_faces(cfg, table, pc, vel, C, accs, amts)
