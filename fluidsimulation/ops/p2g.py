"""Particle-to-grid velocity transfer (trilinear hat kernel).

The reference's GPU path *gathers*: each MAC face scans ~144 particles from
18 neighbor cells (gpTransferParticleVelocities{U,V,W}.hlsl) and was its
single most expensive stage (95.9 ms of a 214.5 ms frame,
Simulation.cpp:805-806).  Its CPU path *scatters* (Simulation3D.cpp:440-537).
Both compute the same weighted average — the difference is reduction order.

Here we scatter: each particle contributes hat-kernel weights to 8 faces
per component via one big ``.at[].add`` (segment-sum) — dynamic-length
per-face particle lists are hostile to vectorization, and scatter matches the
CPU oracle's math exactly (SURVEY.md §7 "hard parts").

Face validity mirrors the GPU kernels: boundary (wall-normal) faces are
forced to 0 and valid (gpTransferParticleVelocitiesU.hlsl:30-33); faces with
accumulated weight < 0.01 are invalid — the GPU writes an INF sentinel there
(hlsl:61-64); we return an explicit validity mask instead (the sentinel is
just the reference's encoding of this mask).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.config import SimConfig


def _scatter_component(cfg: SimConfig, p, pv, comp_axis: int, shape):
    """Scatter one velocity component to its staggered grid.

    p  : (N, 3) positions in cell units
    pv : (N,) velocity component
    Returns (acc, amt) float32 grids of `shape`.
    """
    n = p.shape[0]
    dims = (cfg.nx, cfg.ny, cfg.nz)

    base = []
    alpha = []
    for ax in range(3):
        c = p[:, ax] + (0.5 if ax == comp_axis else 0.0)
        b = jnp.floor(c)
        base.append(b.astype(jnp.int32))
        alpha.append((c - b).astype(jnp.float32))

    flat_idx = []
    flat_w = []
    for ox in (0, 1):
        for oy in (0, 1):
            for oz in (0, 1):
                offs = (ox, oy, oz)
                idx = [base[ax] + offs[ax] for ax in range(3)]
                ok = jnp.ones(n, bool)
                for ax in range(3):
                    hi = dims[ax] + (1 if ax == comp_axis else 0)
                    ok = ok & (idx[ax] >= 0) & (idx[ax] < hi)
                w = jnp.ones(n, jnp.float32)
                for ax in range(3):
                    a = alpha[ax]
                    w = w * (a if offs[ax] > 0 else 1.0 - a)
                # Linearize with the grid's own shape; clamp invalid to 0
                # with zero weight (scatter no-op).
                sx, sy, sz = shape
                lin = (idx[0] * sy + idx[1]) * sz + idx[2]
                lin = jnp.where(ok, lin, 0)
                w = jnp.where(ok, w, 0.0)
                flat_idx.append(lin)
                flat_w.append(w)

    lin = jnp.concatenate(flat_idx)
    w = jnp.concatenate(flat_w)
    vals = jnp.concatenate([wi * pv for wi in flat_w])
    ncells = shape[0] * shape[1] * shape[2]
    acc = jnp.zeros(ncells, jnp.float32).at[lin].add(vals).reshape(shape)
    amt = jnp.zeros(ncells, jnp.float32).at[lin].add(w).reshape(shape)
    return acc, amt


def transfer_to_grid(cfg: SimConfig, pos, vel):
    """P2G for all three components.

    Returns (u, v, w, u_valid, v_valid, w_valid).  Invalid faces hold an
    unspecified value (they are always overwritten by extrapolation).
    """
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    m = jnp.array([nx, ny, nz], jnp.float32)
    p = pos * m  # advection clamps keep these in (-0.5, n+0.5)

    out = []
    for comp_axis, shape in (
        (0, (nx + 1, ny, nz)),
        (1, (nx, ny + 1, nz)),
        (2, (nx, ny, nz + 1)),
    ):
        acc, amt = _scatter_component(cfg, p, vel[:, comp_axis], comp_axis, shape)
        g = acc / jnp.maximum(amt, jnp.float32(1e-30))
        valid = amt > cfg.zero_thresh
        # Boundary faces: zero and valid.
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
