"""APIC (Affine Particle-In-Cell) transfer — an extension model family.

The reference implements hybrid PIC/FLIP (gpUpdateParticleVelocities.hlsl,
Simulation.cpp:541); APIC [Jiang et al. 2015] is its canonical successor:
each particle carries an affine velocity matrix C so the transfer preserves
angular momentum exactly and is dissipation-free without FLIP's noise.
This module provides the transfer pair; `solver/apic.py` composes the full
stepper from the existing level-set / projection / advection ops.

Design notes (correctness tier):

* **Quadratic B-spline weights**, not the reference's linear hats: with
  linear kernels APIC's inertia matrix D_p = sum_i w_ip (x_i-x_p)(x_i-x_p)^T
  is position-dependent and singular whenever a particle aligns with a
  node; with quadratic B-splines D_p = (dx^2/4) I identically, so
  C_p = 4 B_p / dx^2 with no solve.  (This is the standard APIC choice.)
* Grids stay MAC-staggered exactly as in the rest of the framework
  (u: (nx+1,ny,nz) faces at pc-x = i-0.5; cell centers at integer pc
  coords — the convention established by ops/p2g.py's hat weights).
* C is stored per velocity component as a row of 3 derivatives:
  C[p, k, :] ~ (d v_k / d x, y, z), shape (N, 3, 3), units 1/s.
* Scatter/gather formulations mirror ops/p2g.py's `_scatter_component`
  (27 offsets instead of 8); this tier matches the CPU-twin math exactly
  and is the oracle for the packed fast paths: the packed 9x32-row G2P
  (g2p_apic_packed), the table-window P2G (build_apic_table /
  p2g_apic_from_table), its fused union-window form
  (p2g_apic_from_table_fused, bit-identical, 54 vs 108 reads), level-set
  seeding from the same table (the ApicTable is field-compatible with
  CellTable seeding) and the free RK3 stage 1 (advect_rk3_pic — vel IS
  the spline sample at pos).  Each replaces 81N element gathers or 162N
  scatter elements by row gathers.  Against PIC/FLIP the step does more
  work by construction: wider spline windows (36 vs 18 cells) and a
  2x-wide table.

Exactness property (tested): affine velocity fields v(x) = v0 + A(x-x0)
round-trip P2G -> G2P unchanged (quadratic B-splines reproduce linears),
and total momentum is conserved by P2G (sum_i w_ip (x_i-x_p) = 0).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.config import SimConfig

# Validity threshold for face weights: quadratic B-spline weights are
# smaller than hats (max 0.75 per axis); faces a particle meaningfully
# touches still accumulate >> 1e-4.
APIC_WEIGHT_THRESH = 1e-4


def _quad_spline(d):
    """Quadratic B-spline value at signed distance d (support |d| < 1.5)."""
    ad = jnp.abs(d)
    inner = 0.75 - ad * ad
    outer = 0.5 * (1.5 - ad) ** 2
    return jnp.where(ad < 0.5, inner, jnp.where(ad < 1.5, outer, 0.0))


def _component_nodes(cfg: SimConfig, pc, comp_axis: int, m_meters=None):
    """Yield (idx3, ok, w, dxm) for the 27 spline nodes of one component.

    pc: (N, 3) positions in cell units (cell centers at integers).
    idx3: list of 3 (N,) int32 node indices; ok: (N,) in-range mask;
    w: (N,) spline weight; dxm: list of 3 (N,) node-minus-particle offsets
    in METERS (x_i - x_p), the APIC lever arm.

    m_meters: per-axis cells-per-meter for the dxm conversion — defaults
    to cfg's dims (unit-cube domain).  Sharded callers working in a
    shifted LOCAL cell frame pass the GLOBAL dims here while cfg carries
    the local extent (parallel/halo_apic.py).
    """
    dims = (cfg.nx, cfg.ny, cfg.nz)
    if m_meters is None:
        m_meters = dims
    t, base = [], []
    for ax in range(3):
        ta = pc[:, ax] + (0.5 if ax == comp_axis else 0.0)
        t.append(ta)
        base.append(jnp.floor(ta - 0.5).astype(jnp.int32))
    for ox in (0, 1, 2):
        for oy in (0, 1, 2):
            for oz in (0, 1, 2):
                offs = (ox, oy, oz)
                idx = [base[ax] + offs[ax] for ax in range(3)]
                ok = jnp.ones(pc.shape[0], bool)
                w = jnp.ones(pc.shape[0], jnp.float32)
                dxm = []
                for ax in range(3):
                    hi = dims[ax] + (1 if ax == comp_axis else 0)
                    ok = ok & (idx[ax] >= 0) & (idx[ax] < hi)
                    d = t[ax] - idx[ax].astype(jnp.float32)
                    w = w * _quad_spline(d)
                    # node_pos - pc = idx - t (cell units) -> meters.
                    dxm.append(-d / jnp.float32(m_meters[ax]))
                yield idx, ok, w, dxm


def p2g_apic(cfg: SimConfig, pos, vel, C):
    """APIC P2G for all three MAC components.

    pos: (N,3) meters; vel: (N,3) m/s; C: (N,3,3) 1/s with C[:,k,:] the
    affine row of component k.  Returns (u, v, w, uv, vv, wv) like
    ops/p2g.py::transfer_to_grid (same boundary-face and validity
    semantics so the downstream extrapolate/project stages are reused
    unchanged).
    """
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    m = jnp.array([nx, ny, nz], jnp.float32)
    pc = pos * m

    out = []
    for comp_axis, shape in (
        (0, (nx + 1, ny, nz)),
        (1, (nx, ny + 1, nz)),
        (2, (nx, ny, nz + 1)),
    ):
        pv = vel[:, comp_axis]
        crow = C[:, comp_axis, :]
        flat_idx, flat_w, flat_val = [], [], []
        sx, sy, sz = shape
        for idx, ok, w, dxm in _component_nodes(cfg, pc, comp_axis):
            val = pv
            for ax in range(3):
                val = val + crow[:, ax] * dxm[ax]
            lin = (idx[0] * sy + idx[1]) * sz + idx[2]
            lin = jnp.where(ok, lin, 0)
            w = jnp.where(ok, w, 0.0)
            flat_idx.append(lin)
            flat_w.append(w)
            flat_val.append(w * val)
        lin = jnp.concatenate(flat_idx)
        w = jnp.concatenate(flat_w)
        vals = jnp.concatenate(flat_val)
        ncells = sx * sy * sz
        acc = jnp.zeros(ncells, jnp.float32).at[lin].add(vals).reshape(shape)
        amt = jnp.zeros(ncells, jnp.float32).at[lin].add(w).reshape(shape)
        g = acc / jnp.maximum(amt, jnp.float32(1e-30))
        valid = amt > APIC_WEIGHT_THRESH
        # Boundary faces: zero and valid (ops/p2g.py semantics).
        if comp_axis == 0:
            g = g.at[0, :, :].set(0.0).at[nx, :, :].set(0.0)
            valid = valid.at[0, :, :].set(True).at[nx, :, :].set(True)
        elif comp_axis == 1:
            g = g.at[:, 0, :].set(0.0).at[:, ny, :].set(0.0)
            valid = valid.at[:, 0, :].set(True).at[:, ny, :].set(True)
        else:
            g = g.at[:, :, 0].set(0.0).at[:, :, nz].set(0.0)
            valid = valid.at[:, :, 0].set(True).at[:, :, nz].set(True)
        out.append((g, valid))

    (u, uv), (v, vv), (w, wv) = out
    return u, v, w, uv, vv, wv


def g2p_apic(cfg: SimConfig, pos, u, v, w):
    """APIC G2P: pure-PIC velocities + affine rows from the same weights.

    Returns (vel, C): vel (N,3) m/s, C (N,3,3) 1/s with
    C[:,k,ax] = 4 * m[ax]^2 * sum_i w_ip v_i (x_i - x_p)[ax]   (= B D^-1,
    D = (1/4) diag(1/m^2) for quadratic B-splines).
    """
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    m = jnp.array([nx, ny, nz], jnp.float32)
    pc = pos * m
    n = pos.shape[0]

    vels, crows = [], []
    for comp_axis, grid in ((0, u), (1, v), (2, w)):
        gflat = grid.reshape(-1)
        shape = grid.shape
        sy, sz = shape[1], shape[2]
        dims_hi = [shape[0], shape[1], shape[2]]
        vk = jnp.zeros(n, jnp.float32)
        brow = [jnp.zeros(n, jnp.float32) for _ in range(3)]
        for idx, _ok, wgt, dxm in _component_nodes(cfg, pc, comp_axis):
            # Clamp addressing (the reference's sampler semantics): weights
            # keep their nominal node positions so partition of unity and
            # interior affine-exactness hold; out-of-range fetches reuse
            # the edge value.
            ic = [jnp.clip(idx[ax], 0, dims_hi[ax] - 1) for ax in range(3)]
            lin = (ic[0] * sy + ic[1]) * sz + ic[2]
            gi = gflat[lin]
            vk = vk + wgt * gi
            for ax in range(3):
                brow[ax] = brow[ax] + wgt * gi * dxm[ax]
        vels.append(vk)
        scale = 4.0 * m * m  # D^-1 per axis
        crows.append(jnp.stack([brow[ax] * scale[ax] for ax in range(3)], -1))

    vel = jnp.stack(vels, axis=-1)
    C = jnp.stack(crows, axis=1)  # (N, 3, 3), rows indexed by component
    return vel, C


# -- packed G2P fast path ----------------------------------------------------
#
# The oracle g2p gathers 27 single elements per component per particle
# (81 x N element-gathers).  All 27 nodes of one component fit in ONE
# PackedPhi9-style row: 3x3 (x,y)-corners x a 32-lane z-window (stride 30
# keeps base_z+2 in-window), so the packed path costs 3 x N ~1.1 KB row
# gathers plus in-register spline math.
# Rows are EDGE-padded (1 low / 2 high per axis) so out-of-range nodes
# reuse the boundary value — exactly the oracle's clamp addressing, with
# the nominal node positions kept in the weights/levers.

_S = 30
_L9 = 32


def pack_mac9(grid):
    """Pack one MAC component grid into (rows, dims, ns).

    rows[(px * (gy+1) + py) * ns + s] holds the 3x3 corner z-segments
    [30s, 30s+32) of the (1,2)-edge-padded grid; px = base_x + 1 for
    base_x in [-1, gx-1] (likewise y); lane l is padded-z index 30s + l,
    i.e. node index 30s + l - 1."""
    gx, gy, gz = grid.shape
    ns = gz // _S + 1
    zhi = _S * (ns - 1) + _L9 - (gz + 1)
    gp = jnp.pad(grid, ((1, 2), (1, 2), (1, zhi)), mode="edge")
    seg = jnp.stack([gp[..., _S * s: _S * s + _L9] for s in range(ns)],
                    axis=-2)  # (gx+3, gy+3, ns, L)
    rows = jnp.stack(
        [seg[dx: dx + gx + 1, dy: dy + gy + 1]
         for dx in range(3) for dy in range(3)],
        axis=3,
    )  # (gx+1, gy+1, ns, 9, L)
    return rows.reshape((gx + 1) * (gy + 1) * ns, 9 * _L9), grid.shape, ns


def g2p_apic_packed(cfg: SimConfig, pos, u, v, w, with_hat: bool = False):
    """g2p_apic via one packed-row gather per component (same math, packed
    reduction order; equality tested to fp tolerance).

    with_hat=True additionally returns khat (N, 3): the HAT (trilinear)
    interpolation of (u, v, w) at pos with core/interp.py's clamp
    semantics, computed from the rows this function already gathered —
    the 2-node hat support per axis is always inside the 3-node quadratic
    window (base = floor(t-0.5); hat nodes are floor(t)/floor(t)+1 ∈
    base+{0,1,2}); matches interp_mac3_packed_vec to ~1 ulp (different
    z-window lanes / summation order), tested in tests/test_apic.py.
    NOT used by the stepper: advect_rk3_pic (stage 1 = state.vel, exact
    for pure-PIC transfers) gets the same saving for free."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    m = jnp.array([nx, ny, nz], jnp.float32)
    pc = pos * m
    n = pos.shape[0]

    vels, crows, hats = [], [], []
    for comp_axis, grid in ((0, u), (1, v), (2, w)):
        rows2d, (gx, gy, gz), ns = pack_mac9(grid)
        t = [pc[:, ax] + (0.5 if ax == comp_axis else 0.0) for ax in range(3)]
        base = [jnp.floor(ta - 0.5).astype(jnp.int32) for ta in t]
        px, py = base[0] + 1, base[1] + 1
        pz = base[2] + 1
        seg = pz // _S
        key = (px * (gy + 1) + py) * ns + seg
        rows = rows2d[key].reshape(n, 9, _L9)

        lane = jax.lax.broadcasted_iota(jnp.float32, (1, _L9), 1)
        # node z coordinate of lane l: 30*seg + l - 1
        znode = jnp.float32(_S) * seg[:, None].astype(jnp.float32) + lane - 1.0
        dz = t[2][:, None] - znode
        wz = _quad_spline(dz)  # auto-zero outside the 3-node support
        # The two z-reductions fuse into one pass over the row gathers as
        # written; with_hat adds hat-weight compute, not an extra pass.
        zred = (rows * wz[:, None, :]).sum(-1)          # (N, 9)
        zred_dz = (rows * (wz * (-dz / m[2]))[:, None, :]).sum(-1)

        wx = [_quad_spline(t[0] - (base[0] + a).astype(jnp.float32))
              for a in range(3)]
        wy = [_quad_spline(t[1] - (base[1] + b).astype(jnp.float32))
              for b in range(3)]
        dxx = [((base[0] + a).astype(jnp.float32) - t[0]) / m[0]
               for a in range(3)]
        dyy = [((base[1] + b).astype(jnp.float32) - t[1]) / m[1]
               for b in range(3)]

        vk = jnp.zeros(n, jnp.float32)
        bx = jnp.zeros(n, jnp.float32)
        by = jnp.zeros(n, jnp.float32)
        bz = jnp.zeros(n, jnp.float32)
        for a in range(3):
            for b in range(3):
                wab = wx[a] * wy[b]
                zc = zred[:, 3 * a + b]
                vk = vk + wab * zc
                bx = bx + wab * dxx[a] * zc
                by = by + wab * dyy[b] * zc
                bz = bz + wab * zred_dz[:, 3 * a + b]
        vels.append(vk)
        scale = 4.0 * m * m
        crows.append(jnp.stack(
            [bx * scale[0], by * scale[1], bz * scale[2]], -1))

        if with_hat:
            # Hat (trilinear) interp of this component from the SAME rows,
            # with core/interp_packed.py's clamp semantics: extended split
            # on the staggered axis, normal split elsewhere.  The 2-node
            # hat support is inside the 3x3x32 window for every clamped
            # coordinate (see docstring); padded replica lanes always get
            # weight exactly 0.
            dims_i = (nx, ny, nz)

            def _hat_corners(ax):
                dim = jnp.float32(dims_i[ax])
                if ax == comp_axis:
                    e = jnp.clip(pc[:, ax] + 0.5, 0.0, dim)
                    i0 = jnp.minimum(jnp.floor(e), dim - 1.0)
                    f = e - i0
                else:
                    nrm = jnp.clip(pc[:, ax], 0.0, dim - 1.0)
                    i0 = jnp.minimum(jnp.floor(nrm), dim - 2.0)
                    f = nrm - i0
                a0 = i0.astype(jnp.int32) - base[ax]
                return [
                    jnp.where(a0 == a, 1.0 - f, 0.0)
                    + jnp.where(a0 + 1 == a, f, 0.0)
                    for a in range(3)
                ]

            wxh = _hat_corners(0)
            wyh = _hat_corners(1)
            if comp_axis == 2:
                q = jnp.clip(pc[:, 2] + 0.5, 0.0, jnp.float32(nz))
            else:
                q = jnp.clip(pc[:, 2], 0.0, jnp.float32(nz - 1))
            wzh = jnp.maximum(0.0, 1.0 - jnp.abs(q[:, None] - znode))
            zred_hat = (rows * wzh[:, None, :]).sum(-1)  # (N, 9)
            hv = jnp.zeros(n, jnp.float32)
            for a in range(3):
                for b in range(3):
                    hv = hv + wxh[a] * wyh[b] * zred_hat[:, 3 * a + b]
            hats.append(hv)

    vel = jnp.stack(vels, axis=-1)
    C = jnp.stack(crows, axis=1)
    if with_hat:
        return vel, C, jnp.stack(hats, axis=-1)
    return vel, C


# -- table-gather P2G fast path ----------------------------------------------
#
# The oracle P2G scatters 2 x 27 x 3 x N elements.  The dense-window form
# eliminates scatter the
# same way celltable.p2g_from_table does for the hat kernel: bin particles
# into a (nx, ny, K, 16, nz) slot table (the celltable windowed build with
# a 16-field payload: pc(3), vel(3), present, C row-major(9)), then every
# MAC face accumulates spline-weighted affine contributions from its
# 4x3x3-cell neighborhood (quadratic-spline support is 1.5 cells, so the
# staggered axis needs offsets {-2,-1,0,+1} and the others {-1,0,+1})
# as dense shifted-window sums.  Overflow particles (> K in a cell) are
# added exactly via the bounded 27-node scatter.

import dataclasses as _dc
from typing import Any as _Any

from .celltable import default_k
from .common import cell_of, rank_ge


@jax.tree_util.register_dataclass
@_dc.dataclass
class ApicTable:
    """slots: (nx, ny, K, 16, nz) f32, fields [px,py,pz, vx,vy,vz, present,
    C00,C01,C02,C10,C11,C12,C20,C21,C22] (positions in cell units);
    n_overflow: scalar; overflow_idx: (cap,) int32 (== N when unused)."""

    slots: _Any
    n_overflow: _Any
    overflow_idx: _Any


def build_apic_table(cfg: SimConfig, pos, vel, C,
                     k: int | None = None, overflow_cap: int | None = None):
    """celltable._build_from_cells with a 16-field payload (see ApicTable).
    overflow_cap defaults to cfg.overflow_cap like the FLIP table build, so
    the demo's --overflow-cap / autotune tiers apply to APIC too."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    K = default_k(cfg) if k is None else k
    if overflow_cap is None:
        overflow_cap = cfg.overflow_cap
    pc = pos * jnp.array([nx, ny, nz], jnp.float32)
    return _build_apic_from_cells((nx, ny, nz), K, pc, vel, C,
                                  overflow_cap=overflow_cap)


def _build_apic_from_cells(dims, K: int, pc, vel, C, valid=None,
                           overflow_cap: int = 4096):
    """Shape-based core of build_apic_table (the celltable._build_from_cells
    pattern): pc in CELL units of a `dims` frame; valid rows optional —
    invalid rows (padding in a sharded shard-local build) are excluded
    from the table, counts, and overflow (parallel/halo_apic.py)."""
    nx, ny, nz = dims
    F = 16
    W = 8 if K <= 8 else 16  # W*F = 128 / 256 lanes: both fast-gather widths
    assert K <= W
    n = pc.shape[0]
    ncells = nx * ny * nz

    cell = cell_of(pc)
    lin = (cell[:, 0] * ny + cell[:, 1]) * nz + cell[:, 2]
    present_in = jnp.ones((n, 1), jnp.float32)
    if valid is not None:
        # Invalid rows sort to the sentinel cell past every real cell.
        lin = jnp.where(valid, lin, ncells)
        present_in = jnp.where(valid[:, None], present_in, 0.0)
    idx = jnp.arange(n, dtype=jnp.int32)
    lin_s, perm = jax.lax.sort((lin, idx), num_keys=1, is_stable=True)

    payload = jnp.concatenate(
        [pc, vel, present_in, C.reshape(n, 9)], axis=1
    )
    payload_s = payload[perm]

    counts = jnp.zeros(ncells, jnp.int32).at[lin].add(1, mode="drop")
    starts = jnp.concatenate([jnp.zeros(1, jnp.int32), jnp.cumsum(counts)])

    pe = jnp.concatenate([payload_s, jnp.zeros((W, F), jnp.float32)], axis=0)
    win = jnp.concatenate([pe[j: j + n] for j in range(W)], axis=1)
    src = jnp.minimum(starts[:ncells], n - 1)
    rows = win[src].reshape(ncells, W, F)[:, :K, :]

    kk = jnp.arange(K, dtype=jnp.int32)
    present = (kk[None, :] < counts[:, None]).astype(jnp.float32)
    rows = rows * present[..., None]
    rows = rows.at[:, :, 6].set(present)
    slots = rows.reshape(nx, ny, nz, K, F).transpose(0, 1, 3, 4, 2)

    n_valid = n if valid is None else valid.sum()
    n_overflow = (n_valid - jnp.minimum(counts, K).sum()).astype(jnp.int32)
    cap = min(overflow_cap, n)

    def find_overflow(_):
        over = rank_ge(lin_s, K) & (lin_s < ncells)
        (pos_s,) = jnp.nonzero(over, size=cap, fill_value=n)
        return jnp.where(pos_s < n, perm[jnp.minimum(pos_s, n - 1)],
                         n).astype(jnp.int32)

    overflow_idx = jax.lax.cond(
        n_overflow > 0, find_overflow,
        lambda _: jnp.full(cap, n, jnp.int32) + 0 * perm[:1], operand=None,
    )
    return ApicTable(slots=slots, n_overflow=n_overflow,
                     overflow_idx=overflow_idx)


def _apic_overflow_scatter(cfg, table, pc, vel, C, comp_axis, shape,
                           acc, amt, m_meters=None):
    """Exact 27-node spline scatter of overflow particles (bounded by cap)."""
    n = pc.shape[0]
    ov = table.overflow_idx
    live = ov < n
    safe = jnp.where(live, ov, 0)
    p = pc[safe]
    pv = vel[safe, comp_axis]
    crow = C[safe, comp_axis, :]

    sx, sy, sz = shape
    lin_all, w_all, val_all = [], [], []
    # Reuse the 27-node generator in the overflow frame.
    for idx, ok, w, dxm in _component_nodes(cfg, p, comp_axis, m_meters):
        ok = ok & live
        val = pv
        for ax in range(3):
            val = val + crow[:, ax] * dxm[ax]
        lin = (idx[0] * sy + idx[1]) * sz + idx[2]
        lin_all.append(jnp.where(ok, lin, 0))
        w = jnp.where(ok, w, 0.0)
        w_all.append(w)
        val_all.append(w * val)
    lin = jnp.concatenate(lin_all)
    w = jnp.concatenate(w_all)
    vals = jnp.concatenate(val_all)
    acc = acc.reshape(-1).at[lin].add(vals).reshape(shape)
    amt = amt.reshape(-1).at[lin].add(w).reshape(shape)
    return acc, amt


def p2g_apic_from_table(cfg: SimConfig, table: ApicTable, pos, vel, C):
    """p2g_apic via dense spline windows over the 16-field slot table
    (+ exact bounded overflow scatter).  Same boundary/validity semantics;
    equality vs the oracle up to summation order."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    m = jnp.array([nx, ny, nz], jnp.float32)
    pc = pos * m
    slots = table.slots  # (nx, ny, K, 16, nz)
    padded = jnp.pad(slots, ((2, 2), (2, 2), (0, 0), (0, 0), (2, 2)))

    out = []
    for comp_axis, shape in (
        (0, (nx + 1, ny, nz)),
        (1, (nx, ny + 1, nz)),
        (2, (nx, ny, nz + 1)),
    ):
        coords = []
        bshape = [(shape[0], 1, 1, 1), (1, shape[1], 1, 1),
                  (1, 1, 1, shape[2])]
        for ax, n_face in enumerate(shape):
            c = jnp.arange(n_face, dtype=jnp.float32)
            if ax == comp_axis:
                c = c - 0.5  # face position in cell units
            coords.append(c.reshape(bshape[ax]))

        acc = jnp.zeros(shape, jnp.float32)
        amt = jnp.zeros(shape, jnp.float32)
        offs_axis = (-2, -1, 0, 1)
        offs_other = (-1, 0, 1)
        rng = [offs_axis if ax == comp_axis else offs_other
               for ax in range(3)]
        for ox in rng[0]:
            for oy in rng[1]:
                for oz in rng[2]:
                    win = padded[
                        2 + ox: 2 + ox + shape[0],
                        2 + oy: 2 + oy + shape[1],
                        :, :,
                        2 + oz: 2 + oz + shape[2],
                    ]
                    velc = win[:, :, :, 3 + comp_axis, :]
                    present = win[:, :, :, 6, :]
                    dx = coords[0] - win[:, :, :, 0, :]
                    dy = coords[1] - win[:, :, :, 1, :]
                    dz = coords[2] - win[:, :, :, 2, :]
                    wgt = (_quad_spline(dx) * _quad_spline(dy)
                           * _quad_spline(dz) * present)
                    c0 = win[:, :, :, 7 + 3 * comp_axis, :]
                    c1 = win[:, :, :, 8 + 3 * comp_axis, :]
                    c2 = win[:, :, :, 9 + 3 * comp_axis, :]
                    val = (velc + c0 * (dx / m[0]) + c1 * (dy / m[1])
                           + c2 * (dz / m[2]))
                    acc = acc + (wgt * val).sum(2)
                    amt = amt + wgt.sum(2)

        acc, amt = _apic_overflow_scatter(
            cfg, table, pc, vel, C, comp_axis, shape, acc, amt
        )
        g = acc / jnp.maximum(amt, jnp.float32(1e-30))
        valid = amt > APIC_WEIGHT_THRESH
        if comp_axis == 0:
            g = g.at[0, :, :].set(0.0).at[nx, :, :].set(0.0)
            valid = valid.at[0, :, :].set(True).at[nx, :, :].set(True)
        elif comp_axis == 1:
            g = g.at[:, 0, :].set(0.0).at[:, ny, :].set(0.0)
            valid = valid.at[:, 0, :].set(True).at[:, ny, :].set(True)
        else:
            g = g.at[:, :, 0].set(0.0).at[:, :, nz].set(0.0)
            valid = valid.at[:, :, 0].set(True).at[:, :, nz].set(True)
        out.append((g, valid))

    (u, uv), (v, vv), (w, wv) = out
    return u, v, w, uv, vv, wv


def extrapolate_rings(g, valid, rings: int = 2):
    """Multi-ring velocity extrapolation (kept as a MEASURED NEGATIVE for
    the APIC stepper — see the hypothesis trail).

    Hypothesis: the quadratic spline's 1.5-cell support reads faces the
    reference's one-ring rule leaves at zero, causing surface drag.
    Measured: wiring rings=2 into step_apic left the spinning-ball L_y
    decay BIT-IDENTICAL — and the reason
    is structural: the same spline weights define both transfer
    directions, so every face G2P reads with nonzero weight was itself
    P2G-weighted and is already valid; extrapolated faces only feed
    advection/projection, which stay inside the covered region.  The
    APIC-vs-FLIP L_y gap (0.79 vs 0.85 at t=0.2 s) is instead the
    per-step full grid re-sampling (spline filtering at the free
    surface), which FLIP's (1-alpha)=0.95 old-velocity keep shields.
    Drops the HLSL OOB-counts-as-valid-zero quirk; never-reached faces
    are 0."""
    from .common import shift

    g = jnp.where(valid, g, 0.0)
    for _ in range(rings):
        num = jnp.zeros(g.shape, jnp.float32)
        tot = jnp.zeros(g.shape, jnp.float32)
        for axis in range(3):
            for s in (-1, 1):
                nb_ok = shift(valid, axis, s, False)
                nb_val = shift(g, axis, s, 0.0)
                num = num + nb_ok
                tot = tot + jnp.where(nb_ok, nb_val, 0.0)
        fill = num > 0
        g = jnp.where(
            valid, g, jnp.where(fill, tot / jnp.maximum(num, 1.0), 0.0)
        )
        valid = valid | fill
    return g


def p2g_apic_from_table_fused(cfg: SimConfig, table: ApicTable, pos, vel, C,
                              pc=None, m_meters=None):
    """p2g_apic_from_table restructured as ONE sweep over the UNION window
    (the celltable.p2g_from_table_fused pattern): cell-indexed accumulators
    (component face c + e_k stored at cell c) turn all three components'
    neighborhoods into subsets of the {-1..2}^3 offset cube, of which only
    54 combos serve >= 1 component (those with >= two axes at +2 serve
    none) — 54 window reads instead of the unfused form's 108.  Boundary
    faces (index 0 on the staggered axis) are never accumulated, which is
    fine: they are forced to 0/valid afterwards, identical semantics.

    pc / m_meters: pass positions already in (possibly shifted local)
    CELL units and the GLOBAL cells-per-meter for the affine-term unit
    conversion — the sharded caller's extended-slab frame
    (parallel/halo_apic.py).  Defaults reproduce the single-chip form
    exactly (m_meters = cfg dims, pc = pos * dims)."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    m = (jnp.array([nx, ny, nz], jnp.float32) if m_meters is None
         else jnp.asarray(m_meters, jnp.float32))
    if pc is None:
        pc = pos * jnp.array([nx, ny, nz], jnp.float32)
    slots = table.slots
    padded = jnp.pad(slots, ((2, 2), (2, 2), (0, 0), (0, 0), (2, 2)))

    cx = jnp.arange(nx, dtype=jnp.float32).reshape(nx, 1, 1, 1)
    cy = jnp.arange(ny, dtype=jnp.float32).reshape(1, ny, 1, 1)
    cz = jnp.arange(nz, dtype=jnp.float32).reshape(1, 1, 1, nz)
    # Face positions (cell units) of the face stored at cell c, per comp:
    # U: (cx+0.5, cy, cz)  V: (cx, cy+0.5, cz)  W: (cx, cy, cz+0.5).
    fcoords = [
        (cx + 0.5, cy, cz),
        (cx, cy + 0.5, cz),
        (cx, cy, cz + 0.5),
    ]

    shp = (nx, ny, nz)
    accs = [jnp.zeros(shp, jnp.float32) for _ in range(3)]
    amts = [jnp.zeros(shp, jnp.float32) for _ in range(3)]

    for dx_off in (-1, 0, 1, 2):
        for dy_off in (-1, 0, 1, 2):
            for dz_off in (-1, 0, 1, 2):
                d = (dx_off, dy_off, dz_off)
                comps = [k for k in range(3)
                         if all(d[ax] <= 1 for ax in range(3) if ax != k)]
                if not comps:
                    continue
                win = padded[
                    2 + dx_off: 2 + dx_off + nx,
                    2 + dy_off: 2 + dy_off + ny,
                    :, :,
                    2 + dz_off: 2 + dz_off + nz,
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
                    val = (velc + c0 * (ddx / m[0]) + c1 * (ddy / m[1])
                           + c2 * (ddz / m[2]))
                    accs[k] = accs[k] + (wgt * val).sum(2)
                    amts[k] = amts[k] + wgt.sum(2)

    return _finalize_apic_faces(cfg, table, pc, vel, C, accs, amts,
                                m_meters=m_meters)


def _finalize_apic_faces(cfg: SimConfig, table, pc, vel, C, accs, amts,
                         m_meters=None):
    """Shared tail of the fused cell-indexed P2G forms: shift the
    cell-indexed accumulators onto face grids (face i stores the value
    accumulated at cell i-1 along the staggered axis), apply the exact
    bounded overflow scatter, normalize, and force the boundary faces —
    identical op sequence for the per-cell and supercell tables."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    out = []
    for k, shape in ((0, (nx + 1, ny, nz)), (1, (nx, ny + 1, nz)),
                     (2, (nx, ny, nz + 1))):
        acc = jnp.zeros(shape, jnp.float32)
        amt = jnp.zeros(shape, jnp.float32)
        if k == 0:
            acc = acc.at[1:, :, :].set(accs[0])
            amt = amt.at[1:, :, :].set(amts[0])
        elif k == 1:
            acc = acc.at[:, 1:, :].set(accs[1])
            amt = amt.at[:, 1:, :].set(amts[1])
        else:
            acc = acc.at[:, :, 1:].set(accs[2])
            amt = amt.at[:, :, 1:].set(amts[2])
        acc, amt = _apic_overflow_scatter(
            cfg, table, pc, vel, C, k, shape, acc, amt, m_meters=m_meters
        )
        g = acc / jnp.maximum(amt, jnp.float32(1e-30))
        valid = amt > APIC_WEIGHT_THRESH
        if k == 0:
            g = g.at[0, :, :].set(0.0).at[nx, :, :].set(0.0)
            valid = valid.at[0, :, :].set(True).at[nx, :, :].set(True)
        elif k == 1:
            g = g.at[:, 0, :].set(0.0).at[:, ny, :].set(0.0)
            valid = valid.at[:, 0, :].set(True).at[:, ny, :].set(True)
        else:
            g = g.at[:, :, 0].set(0.0).at[:, :, nz].set(0.0)
            valid = valid.at[:, :, 0].set(True).at[:, :, nz].set(True)
        out.append((g, valid))

    (u, uv), (v, vv), (w, wv) = out
    return u, v, w, uv, vv, wv
