"""MAC-grid interpolation (JAX).

Exact port of the semantics of FluidSim3::InterpolateMACCell
(Simulation3D.h:55-123) and FluidSim::InterpolateMACCell (Simulation2D.h:59-100):
clamped trilinear interpolation on staggered grids, including the reference's
top-edge integer-index decrement quirks.  The reference's *GPU* path instead
uses hardware samplers with a coordinate remap (gpAdvect.hlsl:19-41), which it
measured to agree with this CPU form to ~1e-3 (Simulation.cpp:569-576) — the
difference being the GPU's fixed-point lerp.  We use the CPU semantics
everywhere, which removes that parity gap entirely.

All functions take positions in *cell units* (i = nx * X_meters etc.) and are
vectorized over an arbitrary leading shape of query points.

Grid array convention throughout the package: arrays are indexed [x, y, z]
(shape (nx+1, ny, nz) for U, etc.).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _lerp(a, b, t):
    return a + (b - a) * t


def _trilerp_pointwise(g, i0, j0, k0, fi, fj, fk):
    """Trilinear interpolation via 8 independent element gathers."""
    c000 = g[i0, j0, k0]
    c100 = g[i0 + 1, j0, k0]
    c010 = g[i0, j0 + 1, k0]
    c110 = g[i0 + 1, j0 + 1, k0]
    c001 = g[i0, j0, k0 + 1]
    c101 = g[i0 + 1, j0, k0 + 1]
    c011 = g[i0, j0 + 1, k0 + 1]
    c111 = g[i0 + 1, j0 + 1, k0 + 1]
    t00 = _lerp(c000, c100, fi)
    t10 = _lerp(c010, c110, fi)
    t01 = _lerp(c001, c101, fi)
    t11 = _lerp(c011, c111, fi)
    tx0 = _lerp(t00, t10, fj)
    tx1 = _lerp(t01, t11, fj)
    return _lerp(tx0, tx1, fk)


def _trilerp_window(g, i0, j0, k0, fi, fj, fk):
    """Trilinear interpolation via one windowed gather per call.

    vmap(dynamic_slice) batches to a single XLA gather with
    slice_sizes=(2,2,2): one memory transaction of 8 near-contiguous
    elements per query instead of 8 scattered element gathers.
    """
    shape = i0.shape
    starts = jnp.stack(
        [i0.reshape(-1), j0.reshape(-1), k0.reshape(-1)], axis=-1
    )
    win = jax.vmap(
        lambda s: jax.lax.dynamic_slice(g, (s[0], s[1], s[2]), (2, 2, 2))
    )(starts)  # (n, 2, 2, 2)
    fi = fi.reshape(-1)
    fj = fj.reshape(-1)
    fk = fk.reshape(-1)
    wx = jnp.stack([1.0 - fi, fi], axis=-1)  # (n, 2)
    wy = jnp.stack([1.0 - fj, fj], axis=-1)
    wz = jnp.stack([1.0 - fk, fk], axis=-1)
    out = (
        win
        * wx[:, :, None, None]
        * wy[:, None, :, None]
        * wz[:, None, None, :]
    ).sum(axis=(1, 2, 3))
    return out.reshape(shape)


def _trilerp(g, i0, j0, k0, fi, fj, fk):
    # Pointwise element gathers are the default; the batched-dynamic-slice
    # form (_trilerp_window, one gather with slice_sizes=(2,2,2)) is the
    # alternative for the GPU benchmark to compare.
    return _trilerp_pointwise(g, i0, j0, k0, fi, fj, fk)


def _split_normal(coord, m):
    """'Normal' coordinate handling: clamp to [0, m-1], floor with the
    i == m-1 decrement (Simulation3D.h:61,70)."""
    n = jnp.clip(coord, 0.0, m - 1.0)
    i = jnp.minimum(jnp.floor(n), m - 2.0)
    return i.astype(jnp.int32), n - i


def _split_extended(coord, m):
    """'Extended' coordinate handling: clamp coord+0.5 to [0, m], floor with
    the i == m decrement (Simulation3D.h:65,73)."""
    e = jnp.clip(coord + 0.5, 0.0, jnp.float32(m))
    i = jnp.minimum(jnp.floor(e), m - 1.0)
    return i.astype(jnp.int32), e - i


def interp_mac3(u, v, w, pi, pj, pk):
    """Interpolate (u,v,w) MAC grids at cell-unit positions (pi,pj,pk).

    u: (nx+1, ny, nz); v: (nx, ny+1, nz); w: (nx, ny, nz+1).
    Returns (uval, vval, wval), each shaped like pi.
    """
    nx = u.shape[0] - 1
    ny = v.shape[1] - 1
    nz = w.shape[2] - 1

    iI, fI = _split_normal(pi, nx)
    iJ, fJ = _split_normal(pj, ny)
    iK, fK = _split_normal(pk, nz)
    iEI, fEI = _split_extended(pi, nx)
    iEJ, fEJ = _split_extended(pj, ny)
    iEK, fEK = _split_extended(pk, nz)

    uval = _trilerp(u, iEI, iJ, iK, fEI, fJ, fK)
    vval = _trilerp(v, iI, iEJ, iK, fI, fEJ, fK)
    wval = _trilerp(w, iI, iJ, iEK, fI, fJ, fEK)
    return uval, vval, wval


def interp_mac3_vec(u, v, w, pos_cells):
    """Like interp_mac3 but takes/returns stacked (..., 3) arrays."""
    uval, vval, wval = interp_mac3(
        u, v, w, pos_cells[..., 0], pos_cells[..., 1], pos_cells[..., 2]
    )
    return jnp.stack([uval, vval, wval], axis=-1)


def _bilerp(g, i0, j0, fi, fj):
    c00 = g[i0, j0]
    c10 = g[i0 + 1, j0]
    c01 = g[i0, j0 + 1]
    c11 = g[i0 + 1, j0 + 1]
    return _lerp(_lerp(c00, c10, fi), _lerp(c01, c11, fi), fj)


def interp_mac2(u, v, pi, pj):
    """2D MAC interpolation (Simulation2D.h:59-100).

    u: (nx+1, ny); v: (nx, ny+1).  Returns (uval, vval).
    """
    nx = u.shape[0] - 1
    ny = v.shape[1] - 1
    iI, fI = _split_normal(pi, nx)
    iJ, fJ = _split_normal(pj, ny)
    iEI, fEI = _split_extended(pi, nx)
    iEJ, fEJ = _split_extended(pj, ny)
    uval = _bilerp(u, iEI, iJ, fEI, fJ)
    vval = _bilerp(v, iI, iEJ, fI, fEJ)
    return uval, vval
