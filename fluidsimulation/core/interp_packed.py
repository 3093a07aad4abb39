"""Packed-row MAC interpolation — the fast path.

Motivation: the pointwise trilinear path issues 24 element gathers per
query, and a gather's cost is per transaction far more than per byte up to
a few hundred bytes, so it is transaction-bound.  This module restructures each MAC
grid so that one 128-lane row gather fetches everything a query needs for one
component:

  row = [4 (x,y)-corner segments] x [32-lane minor-axis window]

and the minor-axis lerp becomes a *lane-hat reduction*: with the clamped
minor coordinate q, sum(row * max(0, 1 - |q - lane|)) — which equals the
reference's clamped lerp including its top-edge integer-decrement quirk
(Simulation3D.h:70-75), since the hat has weight 1 on the lane at integral q.

Per component per query: 1 row gather (512 B) + a 128-lane VPU reduction,
i.e. 3 transactions per (query, stage) instead of 24.

W's minor grid axis is staggered (nz+1 lanes), so W is packed transposed
with x as the lane axis (x is a 'normal' axis for W).

Numerics are identical to core/interp.py (same clamp semantics); tests
enforce bit-level agreement up to fma reassociation.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Segment stride/width: windows of 32 lanes advancing by 31 so that any
# (iK, iK+1) pair lies inside one segment.
_S = 31
_L = 32


def _nseg(n_normal: int) -> int:
    # i ranges over [0, n_normal-2]; segment = i // _S.
    return (n_normal - 2) // _S + 1


# Giant-batch chunking for the _vec entry points: the row gathers
# materialize an (N, lanes) temp, and XLA additionally inserts a full
# layout-converting copy of it — at the 128³ ppc2 config (8M particles)
# the fat pair gather alone is 2 × 7.6 GB of device memory.  lax.map over
# fixed-size chunks bounds the temp.  Results match the unchunked
# program to ~1 ulp (the scan body fuses/fma-contracts slightly
# differently; same per-particle arithmetic, zero-padded tail rows are
# sliced off).  N ≤ _CHUNK (every demo/bench config at ≤2M particles)
# compiles to the exact unchunked program, so the carried-cache
# bit-equality guarantees are unaffected there.
_CHUNK = 2 * 1024 * 1024


def _map_chunks(fn, flat):
    n = flat.shape[0]
    if n <= _CHUNK:
        return fn(flat)
    nc = -(-n // _CHUNK)
    fp = jnp.pad(flat, ((0, nc * _CHUNK - n), (0, 0)))
    out = jax.lax.map(fn, fp.reshape(nc, _CHUNK, flat.shape[1]))
    return jax.tree_util.tree_map(
        lambda a: a.reshape((nc * _CHUNK,) + a.shape[2:])[:n], out
    )


def _u_stride(pu, dims) -> int:
    """U tables exist in two row layouts: the plain pack's key stride is
    ny-1 (iJ in [0, ny-2]); pack_mac3_pair_padded pads the stride to ny
    (the iJ = ny-1 rows are dead).  The layouts differ in ROW COUNT — nx*(ny-1)*ns
    vs nx*ny*ns — which is static under jit, so consumers infer the stride
    from the shape and both layouts flow through the same interp code."""
    nx, ny, nz = dims
    return ny if pu.shape[0] == nx * ny * _nseg(nz) else ny - 1


def _pad_minor(a, total: int):
    pad = [(0, 0)] * a.ndim
    pad[-1] = (0, total - a.shape[-1])
    return jnp.pad(a, pad) if total > a.shape[-1] else a


def _segments(a):
    """(..., Z) -> (..., ns, L) overlapping windows at stride _S."""
    n = a.shape[-1]
    ns = (n - 2) // _S + 1
    ap = _pad_minor(a, _S * (ns - 1) + _L)
    return jnp.stack([ap[..., _S * s : _S * s + _L] for s in range(ns)], axis=-2)


def pack_mac3(u, v, w):
    """Build packed row tables (pu, pv, pw) from MAC grids."""
    nx = u.shape[0] - 1
    ny = v.shape[1] - 1
    nz = w.shape[2] - 1

    # U: x-corners iEI+{0,1} (iEI in [0,nx-1]); y-corners iJ+{0,1}
    # (iJ in [0,ny-2]); minor z.
    su = _segments(u)  # (nx+1, ny, ns, L)
    pu = jnp.stack(
        [
            su[0:nx, 0 : ny - 1],
            su[0:nx, 1:ny],
            su[1 : nx + 1, 0 : ny - 1],
            su[1 : nx + 1, 1:ny],
        ],
        axis=3,
    )  # (nx, ny-1, ns, 4, L)
    pu = pu.reshape(nx * (ny - 1) * pu.shape[2], 4 * _L)

    # V: x-corners iI+{0,1} (iI in [0,nx-2]); y-corners iEJ+{0,1}
    # (iEJ in [0,ny-1]); minor z.
    sv = _segments(v)  # (nx, ny+1, ns, L)
    pv = jnp.stack(
        [
            sv[0 : nx - 1, 0:ny],
            sv[0 : nx - 1, 1 : ny + 1],
            sv[1:nx, 0:ny],
            sv[1:nx, 1 : ny + 1],
        ],
        axis=3,
    )
    pv = pv.reshape((nx - 1) * ny * pv.shape[2], 4 * _L)

    # W: packed transposed (y, z, x) with x as lanes; y-corners iJ+{0,1},
    # z-corners iEK+{0,1} (iEK in [0,nz-1]).
    wt = jnp.transpose(w, (1, 2, 0))  # (ny, nz+1, nx)
    sw = _segments(wt)  # (ny, nz+1, ns, L)
    pw = jnp.stack(
        [
            sw[0 : ny - 1, 0:nz],
            sw[0 : ny - 1, 1 : nz + 1],
            sw[1:ny, 0:nz],
            sw[1:ny, 1 : nz + 1],
        ],
        axis=3,
    )
    pw = pw.reshape((ny - 1) * nz * pw.shape[2], 4 * _L)
    return pu, pv, pw


def _split_normal(coord, m):
    n = jnp.clip(coord, 0.0, m - 1.0)
    i = jnp.minimum(jnp.floor(n), m - 2.0)
    return i, n - i, n


def _split_extended(coord, m):
    e = jnp.clip(coord + 0.5, 0.0, m * 1.0)
    i = jnp.minimum(jnp.floor(e), m - 1.0)
    return i, e - i


def _hat_reduce(rows, q, seg):
    """rows: (N, 4, L); q: clamped minor coordinate; seg: segment index.
    Returns (N, 4) minor-axis lerp via lane-hat weights."""
    lane = jax.lax.broadcasted_iota(jnp.float32, (1, 1, _L), 2)
    zpos = jnp.float32(_S) * seg[:, None, None] + lane
    wz = jnp.maximum(0.0, 1.0 - jnp.abs(q[:, None, None] - zpos))
    return (rows * wz).sum(-1)


def _corner_mix(zred, fa, fb):
    w = jnp.stack(
        [
            (1 - fa) * (1 - fb),
            (1 - fa) * fb,
            fa * (1 - fb),
            fa * fb,
        ],
        axis=-1,
    )
    return (zred * w).sum(-1)


def interp_mac3_packed(pu, pv, pw, dims, pi, pj, pk):
    """Interpolate using packed tables.  dims = (nx, ny, nz) static.

    pi/pj/pk: flat (N,) cell-space coordinates.  Returns (uval, vval, wval).
    """
    nx, ny, nz = dims
    ns = _nseg(nz)
    nsx = _nseg(nx)

    iI, fI, nI = _split_normal(pi, nx)
    iJ, fJ, nJ = _split_normal(pj, ny)
    iK, fK, nK = _split_normal(pk, nz)
    iEI, fEI = _split_extended(pi, nx)
    iEJ, fEJ = _split_extended(pj, ny)
    iEK, fEK = _split_extended(pk, nz)

    segz = (iK / _S).astype(jnp.int32)
    segx = (iI / _S).astype(jnp.int32)

    # U
    ust = _u_stride(pu, dims)
    key = (iEI.astype(jnp.int32) * ust + iJ.astype(jnp.int32)) * ns + segz
    rows = pu[key].reshape(-1, 4, _L)
    uval = _corner_mix(_hat_reduce(rows, nK, segz.astype(jnp.float32)), fEI, fJ)

    # V
    key = (iI.astype(jnp.int32) * ny + iEJ.astype(jnp.int32)) * ns + segz
    rows = pv[key].reshape(-1, 4, _L)
    vval = _corner_mix(_hat_reduce(rows, nK, segz.astype(jnp.float32)), fI, fEJ)

    # W (lanes = x)
    key = (iJ.astype(jnp.int32) * nz + iEK.astype(jnp.int32)) * nsx + segx
    rows = pw[key].reshape(-1, 4, _L)
    wval = _corner_mix(_hat_reduce(rows, nI, segx.astype(jnp.float32)), fJ, fEK)

    return uval, vval, wval


def interp_mac3_packed_vec(pu, pv, pw, dims, pos_cells):
    shape = pos_cells.shape[:-1]
    flat = pos_cells.reshape(-1, 3)

    def one(f):
        uval, vval, wval = interp_mac3_packed(
            pu, pv, pw, dims, f[:, 0], f[:, 1], f[:, 2]
        )
        return jnp.stack([uval, vval, wval], axis=-1)

    return _map_chunks(one, flat).reshape(*shape, 3)


# -- fat-row pair interpolation (two grid sets, one gather) ------------------

def pack_mac3_pair(macA, macB):
    """Build fat pair tables directly: per-component rows of 2*4*_L = 1024
    lanes, lanes [0:4*_L] = pack_mac3(macA)'s 512 B row, [4*_L:8*_L] =
    pack_mac3(macB)'s — bit-identical to concatenating the two packs but
    materialized once (one 8-way stack instead of two 4-way stacks plus a
    250 MB concat)."""
    uA, vA, wA = macA
    uB, vB, wB = macB
    nx = uA.shape[0] - 1
    ny = vA.shape[1] - 1
    nz = wA.shape[2] - 1

    def corners(sa, sb, x0, x1, y0, y1):
        return [
            sa[x0, y0], sa[x0, y1], sa[x1, y0], sa[x1, y1],
            sb[x0, y0], sb[x0, y1], sb[x1, y0], sb[x1, y1],
        ]

    sa, sb = _segments(uA), _segments(uB)
    pu = jnp.stack(
        corners(sa, sb, slice(0, nx), slice(1, nx + 1),
                slice(0, ny - 1), slice(1, ny)),
        axis=3,
    ).reshape(nx * (ny - 1) * _nseg(nz), 8 * _L)

    sa, sb = _segments(vA), _segments(vB)
    pv = jnp.stack(
        corners(sa, sb, slice(0, nx - 1), slice(1, nx),
                slice(0, ny), slice(1, ny + 1)),
        axis=3,
    ).reshape((nx - 1) * ny * _nseg(nz), 8 * _L)

    sa = _segments(jnp.transpose(wA, (1, 2, 0)))
    sb = _segments(jnp.transpose(wB, (1, 2, 0)))
    pw = jnp.stack(
        corners(sa, sb, slice(0, ny - 1), slice(1, ny),
                slice(0, nz), slice(1, nz + 1)),
        axis=3,
    ).reshape((ny - 1) * nz * _nseg(nx), 8 * _L)
    return pu, pv, pw

def _hat_reduce2(rows2, q, seg):
    """rows2: (N, 2, 4, L) — two stacked grid-set rows; same lane-hat reduce
    as _hat_reduce applied to both halves (bit-identical per half)."""
    lane = jax.lax.broadcasted_iota(jnp.float32, (1, 1, 1, _L), 3)
    zpos = jnp.float32(_S) * seg[:, None, None, None] + lane
    wz = jnp.maximum(0.0, 1.0 - jnp.abs(q[:, None, None, None] - zpos))
    return (rows2 * wz).sum(-1)  # (N, 2, 4)


def _corner_mix2(zred2, fa, fb):
    w = jnp.stack(
        [
            (1 - fa) * (1 - fb),
            (1 - fa) * fb,
            fa * (1 - fb),
            fa * fb,
        ],
        axis=-1,
    )
    return (zred2 * w[:, None, :]).sum(-1)  # (N, 2)


def interp_mac3_packed_pair(pu2, pv2, pw2, dims, pi, pj, pk):
    """Interpolate TWO grid sets with ONE row gather per component.

    pu2/pv2/pw2 are fat tables: per-component rows of 2*4*_L = 1024 lanes,
    with halves at [0:4*_L] = grid set A's pack_mac3 row and [4*_L:8*_L] =
    grid set B's (build with pack_mac3_pair, or equivalently
    ``jnp.concatenate([packA, packB], axis=1)``).  Gather cost
    is per-transaction, so fetching 1 KB instead of 512 B is ~free; both
    interpolants come out of the same row.  Results are bit-identical to
    interp_mac3_packed on each set separately (same keys, same reduce
    order).  Returns ((uA,vA,wA), (uB,vB,wB)).
    """
    nx, ny, nz = dims
    ns = _nseg(nz)
    nsx = _nseg(nx)

    iI, fI, nI = _split_normal(pi, nx)
    iJ, fJ, nJ = _split_normal(pj, ny)
    iK, fK, nK = _split_normal(pk, nz)
    iEI, fEI = _split_extended(pi, nx)
    iEJ, fEJ = _split_extended(pj, ny)
    iEK, fEK = _split_extended(pk, nz)

    segz = (iK / _S).astype(jnp.int32)
    segx = (iI / _S).astype(jnp.int32)

    ust = _u_stride(pu2, dims)
    key = (iEI.astype(jnp.int32) * ust + iJ.astype(jnp.int32)) * ns + segz
    rows2 = pu2[key].reshape(-1, 2, 4, _L)
    uval = _corner_mix2(_hat_reduce2(rows2, nK, segz.astype(jnp.float32)), fEI, fJ)

    key = (iI.astype(jnp.int32) * ny + iEJ.astype(jnp.int32)) * ns + segz
    rows2 = pv2[key].reshape(-1, 2, 4, _L)
    vval = _corner_mix2(_hat_reduce2(rows2, nK, segz.astype(jnp.float32)), fI, fEJ)

    key = (iJ.astype(jnp.int32) * nz + iEK.astype(jnp.int32)) * nsx + segx
    rows2 = pw2[key].reshape(-1, 2, 4, _L)
    wval = _corner_mix2(_hat_reduce2(rows2, nI, segx.astype(jnp.float32)), fJ, fEK)

    return (
        (uval[:, 0], vval[:, 0], wval[:, 0]),
        (uval[:, 1], vval[:, 1], wval[:, 1]),
    )


def interp_mac3_packed_pair_vec(pu2, pv2, pw2, dims, pos_cells):
    shape = pos_cells.shape[:-1]
    flat = pos_cells.reshape(-1, 3)

    def one(f):
        a, b = interp_mac3_packed_pair(
            pu2, pv2, pw2, dims, f[:, 0], f[:, 1], f[:, 2]
        )
        return jnp.stack(a, axis=-1), jnp.stack(b, axis=-1)

    va, vb = _map_chunks(one, flat)
    return va.reshape(*shape, 3), vb.reshape(*shape, 3)


def interp_mac3_packed_half(pu2, pv2, pw2, dims, pi, pj, pk, half: int = 1):
    """Interpolate ONE of a fat pair table's grid sets (lane half ``half``).
    The gathered row is 1 KB instead of 512 B — same per-transaction cost —
    and only the selected half is reduced.  Bit-identical to
    interp_mac3_packed on that set's plain pack."""
    nx, ny, nz = dims
    ns = _nseg(nz)
    nsx = _nseg(nx)

    iI, fI, nI = _split_normal(pi, nx)
    iJ, fJ, nJ = _split_normal(pj, ny)
    iK, fK, nK = _split_normal(pk, nz)
    iEI, fEI = _split_extended(pi, nx)
    iEJ, fEJ = _split_extended(pj, ny)
    iEK, fEK = _split_extended(pk, nz)

    segz = (iK / _S).astype(jnp.int32)
    segx = (iI / _S).astype(jnp.int32)

    ust = _u_stride(pu2, dims)
    key = (iEI.astype(jnp.int32) * ust + iJ.astype(jnp.int32)) * ns + segz
    rows = pu2[key].reshape(-1, 2, 4, _L)[:, half]
    uval = _corner_mix(_hat_reduce(rows, nK, segz.astype(jnp.float32)), fEI, fJ)

    key = (iI.astype(jnp.int32) * ny + iEJ.astype(jnp.int32)) * ns + segz
    rows = pv2[key].reshape(-1, 2, 4, _L)[:, half]
    vval = _corner_mix(_hat_reduce(rows, nK, segz.astype(jnp.float32)), fI, fEJ)

    key = (iJ.astype(jnp.int32) * nz + iEK.astype(jnp.int32)) * nsx + segx
    rows = pw2[key].reshape(-1, 2, 4, _L)[:, half]
    wval = _corner_mix(_hat_reduce(rows, nI, segx.astype(jnp.float32)), fJ, fEK)

    return uval, vval, wval


def interp_mac3_packed_half_vec(pu2, pv2, pw2, dims, pos_cells, half: int = 1):
    shape = pos_cells.shape[:-1]
    flat = pos_cells.reshape(-1, 3)

    def one(f):
        vals = interp_mac3_packed_half(
            pu2, pv2, pw2, dims, f[:, 0], f[:, 1], f[:, 2], half=half
        )
        return jnp.stack(vals, axis=-1)

    return _map_chunks(one, flat).reshape(*shape, 3)


def pack_mac3_pair_padded(macA, macB):
    """pack_mac3_pair with U rows at the padded key stride ny
    (``key = (iEI*ny + iJ)*ns + seg``; the iJ = ny-1 rows are dead), so
    each x-slab holds a whole number of ny*ns rows.  Row content is
    bit-identical; consumers infer the stride (_u_stride)."""
    uA, vA, wA = macA
    uB, vB, wB = macB
    nx = uA.shape[0] - 1
    ny = vA.shape[1] - 1
    nz = wA.shape[2] - 1

    def corners(sa, sb, x0, x1, y0, y1):
        return [
            sa[x0, y0], sa[x0, y1], sa[x1, y0], sa[x1, y1],
            sb[x0, y0], sb[x0, y1], sb[x1, y0], sb[x1, y1],
        ]

    sa = _segments(jnp.pad(uA, ((0, 0), (0, 1), (0, 0))))
    sb = _segments(jnp.pad(uB, ((0, 0), (0, 1), (0, 0))))
    pu = jnp.stack(
        corners(sa, sb, slice(0, nx), slice(1, nx + 1),
                slice(0, ny), slice(1, ny + 1)),
        axis=3,
    ).reshape(nx * ny * _nseg(nz), 8 * _L)

    sa, sb = _segments(vA), _segments(vB)
    pv = jnp.stack(
        corners(sa, sb, slice(0, nx - 1), slice(1, nx),
                slice(0, ny), slice(1, ny + 1)),
        axis=3,
    ).reshape((nx - 1) * ny * _nseg(nz), 8 * _L)

    sa = _segments(jnp.transpose(wA, (1, 2, 0)))
    sb = _segments(jnp.transpose(wB, (1, 2, 0)))
    pw = jnp.stack(
        corners(sa, sb, slice(0, ny - 1), slice(1, ny),
                slice(0, nz), slice(1, nz + 1)),
        axis=3,
    ).reshape((ny - 1) * nz * _nseg(nx), 8 * _L)
    return pu, pv, pw
