"""Combined-key packed MAC interpolation — ONE row gather per query.

STATUS: NOT the production path.  One 256 B gather per stage replaces
interp_packed's three 512 B gathers, but building this table needs a
51-lane minor-axis interleave that XLA vectorizes poorly, where
interp_packed's pack copies contiguous z runs; end to end advect was
slower with it.  Kept (with its exactness test) as a documented
alternative: it becomes the right design if the pack is fused into a
kernel or the table is reused across more stages (PERF.md, to re-judge on
the GPU).

Design: the 3-per-stage gathers of core/interp_packed.py fused into one row:

  key  = (iEI, iEJ, iK)  — the x/y *extended* indices and the z *normal*
         index of the query (all three derivable from the position alone);
  row  = 51 f32 lanes (padded to 64 = 256 B):
           U block: x in {iEI, iEI+1} (2) x y in {iEJ-1..iEJ+1} (3) x
                    z in {iK, iK+1} (2)                      = 12 lanes
           V block: x (3) x y in {iEJ, iEJ+1} (2) x z (2)    = 12 lanes
           W block: x (3) x y (3) x z-faces {iK..iK+2} (3)   = 27 lanes

Each block over-fetches one row along its hat-reduced axes; the hat weight
max(0, 1-|coord - lane_pos|) is exactly the reference's lerp weight on the
two true lanes and exactly zero on the over-fetched one (the extended index
differs from the normal index by at most +1, and the clamped-coordinate
quirks of Simulation3D.h:55-123 are absorbed by the same argument as
core/interp.py), so the result equals interp_mac3 up to fp reassociation.

Cost per query per stage: one 256 B gather + ~64 VPU mult-adds, vs the
packed path's three 512 B gathers — ~3x fewer transactions AND ~6x fewer
bytes.  The table is (nx * ny * (nz-1)) x 64 f32 (~533 MB at 128^3, 66 MB at
64^3), built once per pack with pure slicing (bandwidth-bound).
"""

from __future__ import annotations

import jax.numpy as jnp


def pack_mac3_combined(u, v, w):
    """Build the combined row table from MAC grids.

    u: (nx+1, ny, nz); v: (nx, ny+1, nz); w: (nx, ny, nz+1).
    Returns tab: (nx*ny*(nz-1), 64) f32.
    """
    nx = u.shape[0] - 1
    ny = v.shape[1] - 1
    nz = w.shape[2] - 1
    nzk = nz - 1  # iK ranges over [0, nz-2]

    up = jnp.pad(u, ((0, 0), (1, 1), (0, 0)))  # zero y-halo: hat weight is 0 there
    vp = jnp.pad(v, ((1, 1), (0, 0), (0, 0)))  # zero x-halo
    wp = jnp.pad(w, ((1, 1), (1, 1), (0, 0)))  # zero x,y-halos

    parts = []
    # U block: x = iEI+dx (u faces), y = iEJ-1+dy (+1 pad offset), z = iK+dz.
    for dx in range(2):
        for dy in range(3):
            for dz in range(2):
                parts.append(up[dx : dx + nx, dy : dy + ny, dz : dz + nzk])
    # V block: x = iEI-1+dx (+1 pad offset), y = iEJ+dy (v faces), z = iK+dz.
    for dx in range(3):
        for dy in range(2):
            for dz in range(2):
                parts.append(vp[dx : dx + nx, dy : dy + ny, dz : dz + nzk])
    # W block: x = iEI-1+dx, y = iEJ-1+dy (pad offsets), z-face = iK+dz.
    for dx in range(3):
        for dy in range(3):
            for dz in range(3):
                parts.append(wp[dx : dx + nx, dy : dy + ny, dz : dz + nzk])

    tab = jnp.stack(parts, axis=-1)  # (nx, ny, nzk, 51)
    tab = jnp.pad(tab, ((0, 0), (0, 0), (0, 0), (0, 13)))
    return tab.reshape(nx * ny * nzk, 64)


def _split_normal(coord, m):
    n = jnp.clip(coord, 0.0, m - 1.0)
    i = jnp.minimum(jnp.floor(n), m - 2.0)
    return i, n - i, n


def _split_extended(coord, m):
    e = jnp.clip(coord + 0.5, 0.0, m * 1.0)
    i = jnp.minimum(jnp.floor(e), m - 1.0)
    return i, e - i


def interp_mac3_combined(tab, dims, pi, pj, pk):
    """Interpolate using the combined table.  dims = (nx, ny, nz) static;
    pi/pj/pk flat (N,) cell-space coordinates.  Returns (uval, vval, wval)."""
    nx, ny, nz = dims
    nzk = nz - 1

    iI, fI, nI = _split_normal(pi, nx)
    iJ, fJ, nJ = _split_normal(pj, ny)
    iK, fK, nK = _split_normal(pk, nz)
    iEI, fEI = _split_extended(pi, nx)
    iEJ, fEJ = _split_extended(pj, ny)
    iEK, fEK = _split_extended(pk, nz)

    key = (
        iEI.astype(jnp.int32) * ny + iEJ.astype(jnp.int32)
    ) * nzk + iK.astype(jnp.int32)
    rows = tab[key]  # (N, 64)

    # Hat weights.  Exact: on the two true lanes of each axis they equal the
    # reference lerp weights (1-f, f); on the over-fetched lane they are 0.
    d3 = jnp.arange(3, dtype=jnp.float32)
    wxe = jnp.stack([1.0 - fEI, fEI], axis=-1)  # (N, 2)
    wye = jnp.stack([1.0 - fEJ, fEJ], axis=-1)
    wze = jnp.stack([1.0 - fK, fK], axis=-1)
    wxn = jnp.maximum(0.0, 1.0 - jnp.abs(nI[:, None] - (iEI[:, None] - 1.0 + d3)))
    wyn = jnp.maximum(0.0, 1.0 - jnp.abs(nJ[:, None] - (iEJ[:, None] - 1.0 + d3)))
    eK = iEK + fEK
    wzw = jnp.maximum(0.0, 1.0 - jnp.abs(eK[:, None] - (iK[:, None] + d3)))

    wu = (
        wxe[:, :, None, None] * wyn[:, None, :, None] * wze[:, None, None, :]
    ).reshape(-1, 12)
    wv = (
        wxn[:, :, None, None] * wye[:, None, :, None] * wze[:, None, None, :]
    ).reshape(-1, 12)
    ww = (
        wxn[:, :, None, None] * wyn[:, None, :, None] * wzw[:, None, None, :]
    ).reshape(-1, 27)

    uval = (rows[:, 0:12] * wu).sum(-1)
    vval = (rows[:, 12:24] * wv).sum(-1)
    wval = (rows[:, 24:51] * ww).sum(-1)
    return uval, vval, wval


def interp_mac3_combined_vec(tab, dims, pos_cells):
    shape = pos_cells.shape[:-1]
    flat = pos_cells.reshape(-1, 3)
    uval, vval, wval = interp_mac3_combined(
        tab, dims, flat[:, 0], flat[:, 1], flat[:, 2]
    )
    return jnp.stack([uval, vval, wval], axis=-1).reshape(*shape, 3)
