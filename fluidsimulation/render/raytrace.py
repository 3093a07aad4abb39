"""Shadertoy-style raytraced water renderer, vectorized over pixels (JAX).

JAX equivalent of FX/Render.fx: the fullscreen-triangle pixel shader
becomes a pure function over (H, W) ray arrays under jit.  Every
data-dependent loop in the reference (sphere trace, glass bounces) already
has a fixed worst-case trip count (Render.fx:369/:394/:411/:310); here they
are ``lax.fori_loop``s with active-lane masking — the same counts: 64-step
outside march, 128+48 inside march, 8 glass bounce iterations, 2 water
bounces (traceWater2 -> traceWater1 -> traceWater0).

Deliberately replicated reference quirks (bit-for-bit behavior parity):
  * the pixel shader discards traceGlass's reflection sum at top level
    (Render.fx:555-562 overwrites col unconditionally);
  * traceGlass's inner-box branch always uses the water IOR — its
    ``phi < 0.0 || true`` test (Render.fx:330) short-circuits, so the map()
    probe there is dead code and is omitted;
  * intersectWater's backward march reuses the forward loop counter
    (``for (int j = 0; i < 48; i++)``, Render.fx:411), so it runs
    max(0, 48 - i_exit) iterations;
  * the matte floor is disabled (Render.fx:567 ``|| true``) — misses shade
    as sky.

Level-set sampling uses manual trilinear interpolation with half-texel
centers and clamp addressing, matching the reference's sampler state
(Render.fx:34-40), plus iq's quintic smoothstep warp on the x/z fractional
coordinates (Render.fx:81-115, README.md:65).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

LARGE = 1.0e5  # Render.fx:61 largeNum
WALL = 0.02  # glass wall thickness, Render.fx:60
# March sub-steps per while iteration.  The md() row gathers dominate, so
# extra sub-steps past whole-batch convergence cost more than the saved
# per-iteration any-reduce (a design finding to re-measure on the GPU).
_UNROLL = 1
# Speculative probes per inside-march while iteration (intersect_water
# fwd loop).  Unlike _UNROLL (which adds SERIAL gathers), the fixed
# march's probe positions are data-independent, so _SPEC sub-steps share
# ONE batched md() gather — the gather count per converged lane is
# unchanged and the batch is _SPEC x larger.
# Must divide 128 (the reference trip count) so the loop bound is exact.
_SPEC = 8
SPOT = (-0.7, 0.05, 0.5)  # sun direction (normalized below), Render.fx:28


def _norm(v, axis=-1, eps=0.0):
    return v / jnp.sqrt((v * v).sum(axis=axis, keepdims=True) + eps)


def _dot(a, b):
    return (a * b).sum(axis=-1)


# -- level-set sampling ------------------------------------------------------

def sample_phi(phi, p):
    """Texture-style trilinear sample: p in [0,1]^3 normalized coordinates,
    texel centers at (i+0.5)/n, clamp addressing."""
    n = jnp.array(phi.shape, jnp.float32)
    q = jnp.clip(p * n - 0.5, 0.0, n - 1.0)
    i = jnp.minimum(jnp.floor(q), n - 2.0)
    f = q - i
    i = i.astype(jnp.int32)
    ix, iy, iz = i[..., 0], i[..., 1], i[..., 2]
    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]

    def g(dx, dy, dz):
        return phi[ix + dx, iy + dy, iz + dz]

    c00 = g(0, 0, 0) * (1 - fx) + g(1, 0, 0) * fx
    c10 = g(0, 1, 0) * (1 - fx) + g(1, 1, 0) * fx
    c01 = g(0, 0, 1) * (1 - fx) + g(1, 0, 1) * fx
    c11 = g(0, 1, 1) * (1 - fx) + g(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def _warp(p, dims):
    """iq's quintic smoothstep warp on x/z fractions (Render.fx:81-113),
    returning warped [0,1]^3 sample coordinates."""
    m = jnp.array(dims, jnp.float32)
    mp = m * p + 0.5
    i = jnp.floor(mp)
    f = mp - i
    fx = f[..., 0]
    fz = f[..., 2]
    q = lambda t: t * t * t * (t * (t * 6.0 - 15.0) + 10.0)
    f = f.at[..., 0].set(q(fx)).at[..., 2].set(q(fz))
    return (1.0 / m) * (i + f - 0.5)


def map_dist(phi, p):
    """Distance to fluid at p in [0,1]^3 (Render.fx:77-116): quintic
    smoothstep warp on x/z fractions, then a scaled phi sample."""
    return sample_phi(phi, _warp(p, phi.shape)) / jnp.float32(phi.shape[0])


# -- packed level-set texture (row-gather fast path) --------------------------
#
# The 8-element-gather trilerp above issues 8 gather transactions per map()
# call, and the raymarcher issues hundreds of map() calls per pixel.  Like
# core/interp_packed.py, we pre-pack phi so one 128-lane row gather fetches a
# query's whole (2 x 2 x 32) neighborhood, and the z-lerp becomes a lane-hat
# reduction: ~7x fewer memory transactions per map() call.

_SEG = 31
_LANES = 32


@jax.tree_util.register_pytree_node_class
class PackedPhi:
    """Packed (4 x 32)-row representation of a cell-centered texture.

    Registered as a pytree so a pre-built texture can cross jit boundaries
    (e.g. pack once, render many bands).

    ``dtype``: row storage type.  float32 (default) reproduces sample_phi
    bit-for-bit; bfloat16/float16 halve the row bytes (512 -> 256 B) —
    values are rounded once at pack time and the sample arithmetic runs in
    f32 after the gather, so the error is one storage rounding of phi
    (bf16: 2^-8 relative ~ 0.4%; f16: 2^-11 ~ 0.05%)."""

    def __init__(self, phi=None, *, rows=None, dims=None, ns=None,
                 dtype=None):
        if phi is None:  # tree_unflatten path
            self.rows, self.dims, self.ns = rows, dims, ns
            return
        nx, ny, nz = phi.shape
        self.dims = (nx, ny, nz)
        self.ns = (nz - 2) // _SEG + 1
        pad = _SEG * (self.ns - 1) + _LANES
        pp = jnp.pad(phi, ((0, 0), (0, 0), (0, pad - nz)))
        seg = jnp.stack(
            [pp[..., _SEG * s : _SEG * s + _LANES] for s in range(self.ns)],
            axis=-2,
        )  # (nx, ny, ns, L)
        rows = jnp.stack(
            [
                seg[0 : nx - 1, 0 : ny - 1],
                seg[0 : nx - 1, 1:ny],
                seg[1:nx, 0 : ny - 1],
                seg[1:nx, 1:ny],
            ],
            axis=3,
        )  # (nx-1, ny-1, ns, 4, L)
        rows = rows.reshape((nx - 1) * (ny - 1) * self.ns, 4 * _LANES)
        self.rows = rows if dtype is None else rows.astype(dtype)

    def tree_flatten(self):
        return (self.rows,), (self.dims, self.ns)

    @classmethod
    def tree_unflatten(cls, aux, children):
        dims, ns = aux
        return cls(rows=children[0], dims=dims, ns=ns)


def sample_phi_packed(tex: PackedPhi, p):
    """Texture sample with half-texel centers + clamp addressing, equal to
    sample_phi() to float roundoff."""
    nx, ny, nz = tex.dims
    n = jnp.array(tex.dims, jnp.float32)
    q = jnp.clip(p * n - 0.5, 0.0, n - 1.0)
    i = jnp.minimum(jnp.floor(q), n - 2.0)
    f = q - i
    ix = i[..., 0].astype(jnp.int32)
    iy = i[..., 1].astype(jnp.int32)
    iz = i[..., 2].astype(jnp.int32)
    seg = (iz // _SEG).astype(jnp.int32)
    key = (ix * (ny - 1) + iy) * tex.ns + seg
    shape = key.shape
    rows = (
        tex.rows[key.reshape(-1)]
        .reshape(-1, 4, _LANES)
        .astype(jnp.float32)  # no-op for f32 rows; one cast for bf16/f16
    )
    lane = jax.lax.broadcasted_iota(jnp.float32, (1, 1, _LANES), 2)
    zpos = jnp.float32(_SEG) * seg.reshape(-1, 1, 1).astype(jnp.float32) + lane
    qz = q[..., 2].reshape(-1, 1, 1)
    wz = jnp.maximum(0.0, 1.0 - jnp.abs(qz - zpos))
    zred = (rows * wz).sum(-1)  # (N, 4)
    fx = f[..., 0].reshape(-1)
    fy = f[..., 1].reshape(-1)
    w4 = jnp.stack(
        [(1 - fx) * (1 - fy), (1 - fx) * fy, fx * (1 - fy), fx * fy], axis=-1
    )
    return (zred * w4).sum(-1).reshape(shape)


def map_dist_packed(tex: PackedPhi, p):
    return sample_phi_packed(tex, _warp(p, tex.dims)) / jnp.float32(tex.dims[0])


# -- gradient-tap texture (one gather per forward-difference gradient) -------
#
# compute_gradient's four taps (p, p+ex, p+ey, p+ez, e = 0.005) cost four
# 512 B row gathers.  All four taps' 2x2x2 neighborhoods fit in
# ONE 3x3-corner row: the warped coordinate moves by < 1 cell per tap
# (quintic warp: max DQ over a 0.005*n <= 0.72 input window is < 1, and y is
# unwarped), so tap floors are {i, i+1} per axis — corners {i, i+1, i+2} —
# and a z-window stride of 30 keeps iz+2 inside the 32-lane window.

_S9 = 30


@jax.tree_util.register_pytree_node_class
class PackedPhi9:
    """Packed (9 x 32)-row gradient-tap texture: row (ix, iy, s) holds the
    3x3 (x, y)-corner z-segments [30s, 30s+32) of phi (x/y zero-padded by
    one so the ix+2 / iy+2 corners exist; those lanes are never selected
    when they'd be out of range — the tap floor is clamped to n-2).

    ``dtype``: row storage type like PackedPhi's (1152 -> 576 B rows for
    bf16/f16; taps run in f32 after the gather)."""

    def __init__(self, phi=None, *, rows=None, dims=None, ns=None,
                 dtype=None):
        if phi is None:  # tree_unflatten path
            self.rows, self.dims, self.ns = rows, dims, ns
            return
        nx, ny, nz = phi.shape
        self.dims = (nx, ny, nz)
        self.ns = (nz - 2) // _S9 + 1
        pad = _S9 * (self.ns - 1) + _LANES
        pp = jnp.pad(phi, ((0, 1), (0, 1), (0, pad - nz)))
        seg = jnp.stack(
            [pp[..., _S9 * s : _S9 * s + _LANES] for s in range(self.ns)],
            axis=-2,
        )  # (nx+1, ny+1, ns, L)
        rows = jnp.stack(
            [
                seg[dx : dx + nx - 1, dy : dy + ny - 1]
                for dx in range(3)
                for dy in range(3)
            ],
            axis=3,
        )  # (nx-1, ny-1, ns, 9, L)
        rows = rows.reshape((nx - 1) * (ny - 1) * self.ns, 9 * _LANES)
        self.rows = rows if dtype is None else rows.astype(dtype)

    def tree_flatten(self):
        return (self.rows,), (self.dims, self.ns)

    @classmethod
    def tree_unflatten(cls, aux, children):
        dims, ns = aux
        return cls(rows=children[0], dims=dims, ns=ns)


def gradient_fits_phi9(dims) -> bool:
    """The single-row gradient needs every tap's warped shift < 1 cell:
    0.005 * n <= 0.72 bounds the quintic DQ at 0.983 with f32 headroom."""
    return max(dims) * 0.005 <= 0.72


def compute_gradient9(tex9: PackedPhi9, p):
    """compute_gradient(map_dist_packed(tex), p) from ONE row gather.

    Each tap computes the SAME warped coordinates, floors, hat weights and
    corner mix as sample_phi_packed (bit-identical arithmetic); the only
    change is where the corner z-segments come from — the shared 9-corner
    row instead of a per-tap 4-corner row.  Hat-reducing a differently
    offset 32-lane window is exact (all non-adjacent lanes contribute
    exact 0.0 and f32 addition of zeros is order-independent).  The tap
    floor offset vs the base floor is {0, 1} by the warp bound above; it
    is clamped defensively (a downward ulp wiggle of the computed quintic
    at an exactly-integer coordinate could yield -1 — measure-zero, not
    observed)."""
    nx, ny, nz = tex9.dims
    n = jnp.array(tex9.dims, jnp.float32)
    shape = p.shape[:-1]
    pf = p.reshape(-1, 3)

    w0 = _warp(pf, tex9.dims)
    q0 = jnp.clip(w0 * n - 0.5, 0.0, n - 1.0)
    i0 = jnp.minimum(jnp.floor(q0), n - 2.0)
    ix = i0[:, 0].astype(jnp.int32)
    iy = i0[:, 1].astype(jnp.int32)
    iz = i0[:, 2].astype(jnp.int32)
    seg = iz // _S9
    key = (ix * (ny - 1) + iy) * tex9.ns + seg
    rows = tex9.rows[key].reshape(-1, 9, _LANES).astype(jnp.float32)
    lane = jax.lax.broadcasted_iota(jnp.float32, (1, 1, _LANES), 2)
    zpos = jnp.float32(_S9) * seg.reshape(-1, 1, 1).astype(jnp.float32) + lane

    e = 0.005

    def tap(dp):
        wq = _warp(pf + jnp.asarray(dp, jnp.float32), tex9.dims)
        q = jnp.clip(wq * n - 0.5, 0.0, n - 1.0)
        i = jnp.minimum(jnp.floor(q), n - 2.0)
        f = q - i
        qz = q[:, 2].reshape(-1, 1, 1)
        wz = jnp.maximum(0.0, 1.0 - jnp.abs(qz - zpos))
        zred = (rows * wz).sum(-1).reshape(-1, 3, 3)
        dxb = (i[:, 0].astype(jnp.int32) - ix) >= 1
        dyb = (i[:, 1].astype(jnp.int32) - iy) >= 1

        def pick(a, b):
            return jnp.where(
                dxb & dyb, zred[:, a + 1, b + 1],
                jnp.where(dxb, zred[:, a + 1, b],
                          jnp.where(dyb, zred[:, a, b + 1], zred[:, a, b])),
            )

        zr4 = jnp.stack([pick(0, 0), pick(0, 1), pick(1, 0), pick(1, 1)],
                        axis=-1)
        fx = f[:, 0]
        fy = f[:, 1]
        w4 = jnp.stack(
            [(1 - fx) * (1 - fy), (1 - fx) * fy, fx * (1 - fy), fx * fy],
            axis=-1,
        )
        return (zr4 * w4).sum(-1) / jnp.float32(nx)

    d0 = tap((0.0, 0.0, 0.0))
    g = jnp.stack(
        [tap((e, 0.0, 0.0)) - d0, tap((0.0, e, 0.0)) - d0,
         tap((0.0, 0.0, e)) - d0],
        axis=-1,
    )
    top = pf[:, 1] > 0.999
    up = jnp.array([0.0, 1.0, 0.0], jnp.float32)
    return jnp.where(top[:, None], up, g).reshape(*shape, 3)


@jax.tree_util.register_pytree_node_class
class PackedPhi8:
    """8-lane-row packed texture: row r = the full 2x2x2 corner neighborhood
    of cell (ix, iy, iz), so one 32 B gather fetches exactly what a trilerp
    needs.  Bit-identical to sample_phi_packed.

    STATUS: not the default.  It was slower than PackedPhi end to end on
    the accelerator this renderer was first tuned for (the renderer's
    small march batches favoured the 512 B-row gather); kept as a
    documented alternative to re-measure on the GPU (PERF.md)."""

    def __init__(self, phi=None, *, rows=None, dims=None):
        if phi is None:
            self.rows, self.dims = rows, dims
            return
        nx, ny, nz = phi.shape
        self.dims = (nx, ny, nz)
        parts = []
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    parts.append(
                        phi[dx : dx + nx - 1, dy : dy + ny - 1, dz : dz + nz - 1]
                    )
        self.rows = jnp.stack(parts, axis=-1).reshape(-1, 8)

    def tree_flatten(self):
        return (self.rows,), (self.dims,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(rows=children[0], dims=aux[0])


def sample_phi_packed8(tex: PackedPhi8, p):
    """Texture sample equal to sample_phi_packed bit-for-bit."""
    nx, ny, nz = tex.dims
    n = jnp.array(tex.dims, jnp.float32)
    q = jnp.clip(p * n - 0.5, 0.0, n - 1.0)
    i = jnp.minimum(jnp.floor(q), n - 2.0)
    f = q - i
    ix = i[..., 0].astype(jnp.int32)
    iy = i[..., 1].astype(jnp.int32)
    iz = i[..., 2].astype(jnp.int32)
    key = (ix * (ny - 1) + iy) * (nz - 1) + iz
    shape = key.shape
    r = tex.rows[key.reshape(-1)]  # (N, 8)
    qz = q[..., 2].reshape(-1)
    z0 = i[..., 2].reshape(-1)
    hat0 = jnp.maximum(0.0, 1.0 - jnp.abs(qz - z0))
    hat1 = jnp.maximum(0.0, 1.0 - jnp.abs(qz - (z0 + 1.0)))
    zred = r[:, 0::2] * hat0[:, None] + r[:, 1::2] * hat1[:, None]  # (N, 4)
    fx = f[..., 0].reshape(-1)
    fy = f[..., 1].reshape(-1)
    w4 = jnp.stack(
        [(1 - fx) * (1 - fy), (1 - fx) * fy, fx * (1 - fy), fx * fy], axis=-1
    )
    return (zred * w4).sum(-1).reshape(shape)


def map_dist_packed8(tex: PackedPhi8, p):
    return sample_phi_packed8(tex, _warp(p, tex.dims)) / jnp.float32(tex.dims[0])


GROUND_COLOR = (0.8, 0.8, 0.8)  # Render.fx:27 (floor disabled at :567)


def trace_floor(co, ci):
    """Distance to the matte floor plane y = -0.5 - w (Render.fx:64-74).
    Present for component parity; the reference disables the floor in its
    pixel shader (`|| true`, Render.fx:567) and so do we."""
    t = (-0.5 - WALL - co[..., 1]) / ci[..., 1]
    return jnp.where(t < 0.0, LARGE, t)


# -- geometry ---------------------------------------------------------------

def intersect_aabb(co, ci, bmin, bmax):
    """Slab test (Render.fx:120-147).  Returns (tm, tM, norm1, norm2);
    (LARGE, LARGE, ...) on miss."""
    ci_safe = jnp.where(jnp.abs(ci) < 1e-12, 1e-12, ci)
    inv = 1.0 / ci_safe
    t1 = (bmin - co) * inv
    t2 = (bmax - co) * inv
    tmin = jnp.minimum(t1, t2)
    tmax = jnp.maximum(t1, t2)
    tm = tmin.max(axis=-1)
    tM = tmax.min(axis=-1)
    hit = tM >= tm

    n1 = (jnp.sign(tmin - tm[..., None]) + 1.0) * jnp.sign(t1 - t2)
    n2 = (jnp.sign(tM[..., None] - tmax) + 1.0) * jnp.sign(t2 - t1)
    tm = jnp.where(hit, tm, LARGE)
    tM = jnp.where(hit, tM, LARGE)
    return tm, tM, n1, n2


def fresnel_tr(ci, n, n1, n2):
    """Schlick fresnel + reflection + Snell transmission (Render.fx:154-180).
    Returns (fresnel_weight, refl_dir, trans_dir); TIR -> weight 1, trans 0."""
    n1 = jnp.asarray(n1, jnp.float32)
    n2 = jnp.asarray(n2, jnp.float32)
    rf0 = ((n2 - n1) / (n2 + n1)) ** 2
    cos_i = _dot(n, -ci)
    fresnel = rf0 + (1.0 - rf0) * (1.0 - cos_i) ** 5
    refl = 2.0 * cos_i[..., None] * n + ci
    eta = n1 / n2
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    tir = k < 0.0
    ksqrt = jnp.sqrt(jnp.maximum(k, 0.0))
    trans = jnp.expand_dims(eta, -1) * ci + (eta * cos_i - ksqrt)[..., None] * n
    trans = jnp.where(tir[..., None], 0.0, trans)
    weight = jnp.where(tir, 1.0, fresnel)
    return weight, refl, trans


# -- sky --------------------------------------------------------------------

def _hsv2rgb(c):
    """Render.fx:184-189."""
    kx = jnp.array([1.0, 2.0 / 3.0, 1.0 / 3.0], jnp.float32)
    p = jnp.abs(jnp.mod(c[..., 0:1] + kx, 1.0) * 6.0 - 3.0)
    return c[..., 2:3] * (
        1.0 + c[..., 1:2] * (jnp.clip(p - 1.0, 0.0, 1.0) - 1.0)
    )


def _sky_grad(h, f_time):
    """Render.fx:191-212."""
    r1 = jnp.array([195.0, 43.0, 6.0]) / 255.0
    r2 = jnp.array([228.0, 132.0, 28.0]) / 255.0
    bg1 = jnp.array([168.0, 139.0, 83.0]) / 255.0
    bl2 = jnp.array([96.0, 130.0, 158.0]) / 255.0
    bl3 = jnp.array([96.0, 130.0, 218.0]) / 255.0

    h = h - h * 0.25 * jnp.sin(f_time)
    h_ = h[..., None]
    c = jnp.where(
        h_ < 0.25,
        r1 + (r2 - r1) * 4.0 * h_,
        jnp.where(
            h_ < 0.5,
            r2 + (bg1 - r2) * 4.0 * (h_ - 0.25),
            bg1 + (bl2 - bg1) * 2.0 * (h_ - 0.5),
        ),
    )
    light = 1.0 + 0.25 * jnp.sin(f_time)
    t = 0.25 + 0.25 * jnp.sin(f_time)
    return (c + (bl3 - c) * t) * light


def sample_environment(d):
    """Procedural sky + sun (Render.fx:214-248)."""
    f_time = -1.95
    spot = _norm(jnp.array(SPOT, jnp.float32))
    dspot = _dot(d, spot)
    pos_angle = jnp.arcsin(jnp.clip(d[..., 1], -1.0, 1.0))
    trav = 0.35 * jnp.cos(jnp.sqrt(jnp.clip(12.3 * pos_angle, 0.0, 100.0)) - 0.8) + 0.65
    day_v = 0.25 + 0.666 * (0.3 + trav) * (dspot + 1.0) / 2.0
    day_s = 0.9 - trav / 1.60
    day_h = 0.61 + (0.65 - 0.61) * d[..., 1]
    day = _hsv2rgb(jnp.stack([day_h, day_s, day_v], axis=-1))
    grad_s = _sky_grad(
        0.75 - 0.75 * dspot * jnp.clip(1.0 - 3.0 * d[..., 1], 0.0, 1.0) * trav,
        f_time,
    )
    grad_f = (grad_s + day) / 2.0

    dist = jnp.sqrt(((spot - d) ** 2).sum(-1)) * 10.0
    inten = 0.015 / jnp.abs(dist) + 2.0 ** (-jnp.abs(dist * 2.0)) * 0.4
    sun_c = jnp.array([255.0, 213.0, 73.0]) / 255.0
    grad_f = grad_f + sun_c * (inten * 8.0)[..., None]

    # Redistribute excess red.
    over = jnp.maximum(grad_f[..., 0] - 1.0, 0.0)
    has = grad_f[..., 0] > 1.0
    add = jnp.stack(
        [jnp.zeros_like(over), over / 1.5, over / 0.75], axis=-1
    )
    grad_f = jnp.where(has[..., None], grad_f + add, grad_f)
    return jnp.abs(grad_f) ** 0.4545


# -- glass ------------------------------------------------------------------

def trace_glass(co, ci):
    """Render.fx:255-352.  Returns (h_main, prim_co, prim_ci, prim_alpha,
    refl_sum)."""
    box_lo = jnp.array([-0.5 - WALL] * 3, jnp.float32)
    box_hi = jnp.array([0.5 + WALL, 0.5, 0.5 + WALL], jnp.float32)
    inn_lo = jnp.array([-0.5] * 3, jnp.float32)
    inn_hi = jnp.array([0.5] * 3, jnp.float32)

    inside = (jnp.abs(co) < 0.51).all(axis=-1)
    tm_o, tM_o, n1_o, n2_o = intersect_aabb(co, ci, box_lo, box_hi)
    h_main = jnp.where(inside, tM_o, tm_o)
    norm1 = jnp.where(inside[..., None], -n2_o, n1_o)
    miss = h_main >= LARGE

    p_outer = co + ci * h_main[..., None]

    # Open-top special case (Render.fx:287-293).
    top = (
        (p_outer[..., 1] > 0.49)
        & (jnp.abs(p_outer[..., 0]) <= 0.503)
        & (jnp.abs(p_outer[..., 2]) <= 0.503)
        & ~miss
    )

    fres, refl1, trans1 = fresnel_tr(ci, norm1, 1.0, 1.5)
    refl_sum = fres[..., None] * sample_environment(refl1)
    inn_weight = 1.0 - fres

    prim_co = jnp.full_like(co, LARGE)
    prim_ci = jnp.full_like(co, LARGE)
    prim_alpha = jnp.zeros(co.shape[:-1], jnp.float32)
    prim_set = jnp.zeros(co.shape[:-1], bool)

    p = p_outer
    d = trans1

    def body(_, carry):
        p, d, inn_weight, refl_sum, prim_co, prim_ci, prim_alpha, prim_set = carry
        tm_i, _, n1_i, _ = intersect_aabb(p, d, inn_lo, inn_hi)
        h = tm_i
        use_outer = (h <= 0.01) | (h >= LARGE)
        _, tM2, _, n2_2 = intersect_aabb(p, d, box_lo, box_hi)
        h = jnp.where(use_outer, tM2, h)
        n = jnp.where(use_outer[..., None], -n2_2, n1_i)
        p = p + d * h[..., None]

        # outer branch: exit to air
        f_air, refl_air, trans_air = fresnel_tr(d, n, 1.5, 1.0)
        refl_sum_air = refl_sum + (inn_weight * (1.0 - f_air))[..., None] * sample_environment(trans_air)
        w_air = inn_weight * f_air

        # inner branch: always water IOR (Render.fx:330 `|| true`)
        f_wat, refl_wat, trans_wat = fresnel_tr(d, n, 1.5, 1.333)
        alpha_wat = prim_alpha + inn_weight * (1.0 - f_wat)
        w_wat = inn_weight * f_wat
        set_now = (~prim_set) & (alpha_wat > 0.0) & ~use_outer
        prim_co2 = jnp.where(set_now[..., None], p, prim_co)
        prim_ci2 = jnp.where(set_now[..., None], trans_wat, prim_ci)
        prim_set2 = prim_set | set_now

        out = use_outer
        d = jnp.where(out[..., None], refl_air, refl_wat)
        inn_weight = jnp.where(out, w_air, w_wat)
        refl_sum = jnp.where(out[..., None], refl_sum_air, refl_sum)
        prim_alpha = jnp.where(out, prim_alpha, alpha_wat)
        return (p, d, inn_weight, refl_sum, prim_co2, prim_ci2, prim_alpha, prim_set2)

    carry = (p, d, inn_weight, refl_sum, prim_co, prim_ci, prim_alpha, prim_set)
    carry = jax.lax.fori_loop(0, 8, body, carry)
    _, _, _, refl_sum, prim_co, prim_ci, prim_alpha, _ = carry

    # Apply the special-case and miss overrides.
    prim_co = jnp.where(top[..., None], p_outer, prim_co)
    prim_ci = jnp.where(top[..., None], ci, prim_ci)
    prim_alpha = jnp.where(top, 1.0, prim_alpha)
    refl_sum = jnp.where(top[..., None], 0.0, refl_sum)

    prim_co = jnp.where(miss[..., None], LARGE, prim_co)
    prim_ci = jnp.where(miss[..., None], LARGE, prim_ci)
    prim_alpha = jnp.where(miss, 0.0, prim_alpha)
    refl_sum = jnp.where(miss[..., None], LARGE, refl_sum)
    h_main = jnp.where(miss, LARGE, h_main)
    return h_main, prim_co, prim_ci, prim_alpha, refl_sum


# -- water intersection ------------------------------------------------------

# Sphere-trace-skip defaults (intersect_water ``sphere`` mode): the inside
# march jumps k = floor((d_cells - MARGIN) * SCALE) lattice steps using the
# distance sample it ALREADY fetched.  Raw phi saturates at about
# -particle_radius inside the fluid (it is distance-to-nearest-particle
# minus radius — interior.py docstring), so the march texture must be
# DEEPENED first (interior.deepen_phi folds the certified L1/sqrt3 interior
# distance into deep nodes; render(sphere_trace=True) does this).  With the
# deepened texture d_cells is a Euclidean-certified cell distance; the
# margin absorbs the trilerp support radius (sqrt3), the warp wobble
# (~0.5), the one-probe-behind skip position (1) and the raw-phi overclaim
# in mixed support (<0.86) — see docs/PARITY.md for the pixel-diff bound.
SPHERE_MARGIN = 4.0
SPHERE_SCALE = 1.0


def intersect_water(md, inv_m0, co, ci, max_t, dead=None, stats=False,
                    probe2=None, margin=None, sphere=None, overstep=None,
                    t_seed=None, seed_back=None):
    """Render.fx:358-424.  Returns (p_shifted, t), or with ``stats=True``
    (a trace-time flag for counting md() transactions; default path is
    unchanged) (p_shifted, t, rows) where
    rows is a (4,) int32 vector [total, init+outside, inside_fwd,
    inside_bwd] of md() row gathers this call issued (iterations x full
    batch width — converged lanes still ride every gather, which is
    exactly what the floor model needs to count).

    ``md`` is the distance-field sampler (map_dist flavor); the fixed
    worst-case loop counts (64 / 128 / 48) are preserved but run under
    ``lax.while_loop`` with whole-batch early exit: once every lane has
    converged the loop stops (individual lanes stop updating the moment
    their own break condition fires — identical results, fewer map calls).
    The inside branch only runs when some lane starts inside the water.

    ``dead`` marks rays whose result is discarded upstream (zero-weight
    bounce children, e.g. full-TIR fresnel): they are treated like junk
    lanes so they never stall the whole-batch early exits.

    ``probe2``/``margin``: interior-skip probe for the inside FORWARD
    march — ``probe2(p) -> (dt, d8)`` returns the distance sample plus the
    per-cell L1 interior distance (render/interior.py, PackedPhiSkip).
    At each speculative block boundary a still-marching lane jumps
    k = floor((d8 - margin)/sqrt(3)) whole lattice steps — all provably
    non-exit, non-box probe points, so the lane visits the same decision
    sequence as the serial reference loop; on power-of-two grids every
    t = n*step is exact in f32, so results are bit-identical.  margin is
    TRACED: the same compiled program with margin=+inf IS the no-skip
    march (how bit-equality is asserted, tests/test_interior.py).

    ``sphere``: (margin_cells, scale, spec) — sphere-trace skip for the
    inside forward march with NO auxiliary texture: the skip distance is
    the last distance sample the march already consumed (phi ~ signed
    distance in cell units), k = floor((-dt/step - margin) * scale)
    lattice steps per speculative block, probes stay lattice-aligned.
    scale=0 reproduces the exact march bit-for-bit (how equality is
    tested); nonzero scales can in principle step past sub-cell features
    the 1-cell reference march would also need luck to see — shipped as a
    mode with a measured pixel-diff bound (docs/PARITY.md).  spec is
    the static probes-per-block count (the default _SPEC elsewhere).
    Mutually exclusive with probe2.

    ``overstep``: enhanced sphere tracing (Keinert et al. 2014) on the
    OUTSIDE march — step ``omega*dt`` instead of the plain sphere-trace
    ``dt``; at the next probe the jump is certified iff the two probe
    spheres overlap (``dt_next + dt >= omega*dt``), otherwise the lane
    backtracks to the always-safe conservative point ``t - (omega-1)*dt``
    and re-probes.  Hits and box exits are only ever declared at certified
    points, so an overshoot can never produce a false hit; what CAN differ
    from the reference march is tolerance-level surface-t rounding (the
    probe sequence differs), measured as a pixel-diff bound in
    docs/PARITY.md.  omega is TRACED: omega=1.0 computes the reference
    result exactly (the certification chain degenerates to the plain
    march; only the iteration count can differ), which is how equality is
    asserted in tests/test_render.py.

    ``t_seed``/``seed_back``: temporal frame coherence.  ``t_seed`` is the per-lane ``t`` this function returned
    LAST frame (static camera: identical ray parameterization), and
    ``seed_back`` a conservative world-space backoff.  Both marches then
    start at ``max(t_seed - seed_back, 0)`` instead of 0 — the empty-space
    prefix the previous frame already traversed is skipped.  Hits remain
    locally refined (outside: the sphere trace re-converges; inside: the
    48-step backward sphere trace recovers even a receded surface), so
    the error is bounded by surface motion past ``seed_back`` within one
    frame *introducing new media into the skipped prefix* — measured as
    a pixel-diff bound in docs/PARITY.md.  ``t_seed=None`` (or
    ``seed_back`` >= the previous t) reproduces the cold march exactly;
    boxed/missed lanes re-exit in O(1) probes from their seeded start.
    """
    p0 = co + 0.5
    initial = md(p0)
    outside = (initial > 0.0) | (p0[..., 1] > 0.9999)
    if t_seed is not None:
        t0_seed = jnp.maximum(t_seed - seed_back, 0.0)
    else:
        t0_seed = None
    # Lanes whose box test missed (max_t == LARGE) are glass-miss pixels /
    # dead bounce children whose color is discarded upstream — mark them
    # converged immediately so they never stall the whole-batch early exits
    # (they otherwise march the full worst-case trip counts: sky pixels
    # would drag every band to 64/128 steps).
    junk = max_t >= LARGE
    if dead is not None:
        junk = junk | dead

    # March loops run _UNROLL sub-steps per while iteration: the whole-batch
    # `any` convergence check (a cross-lane reduce + scalar sync) is paid
    # 1/_UNROLL as often.  Bit-exact: converged lanes are frozen per-lane by
    # their `done` flags, so extra sub-steps past convergence change nothing.
    # --- outside: 64-step sphere trace (Render.fx:369-381)
    if overstep is None:
        def out_cond(c):
            i, p, t, done = c
            return (i < 64) & jnp.any(~done)

        def out_body(c):
            i, p, t, done = c
            for _ in range(_UNROLL):
                dt = md(p)
                t2 = t + dt
                done2 = done | (dt < 0.001) | (t2 >= max_t)
                p2 = p0 + t2[..., None] * ci
                t = jnp.where(done, t, t2)
                p = jnp.where(done[..., None], p, p2)
                done = done2
            return i + _UNROLL, p, t, done

        # Lanes that are "inside" never update their done flag
        # meaningfully; mark them done so they don't keep the loop alive.
        t_out0 = (jnp.zeros_like(max_t) if t0_seed is None
                  else jnp.where(outside, t0_seed, 0.0))
        i_out, _, t_o, _ = jax.lax.while_loop(
            out_cond,
            out_body,
            (jnp.int32(0), p0 + t_out0[..., None] * ci, t_out0,
             ~outside | junk),
        )
    else:
        omega = jnp.float32(overstep)

        def out_cond(c):
            i, t, dlast, ostep, done = c
            return (i < 64) & jnp.any(~done)

        def out_body(c):
            i, t, dlast, ostep, done = c
            for _ in range(_UNROLL):
                dt = md(p0 + t[..., None] * ci)
                # Certification: the probe spheres at the previous point
                # (radius dlast) and here must overlap across the
                # omega*dlast jump; conservative (first/backtracked)
                # points have ostep=False and certify trivially.
                fail = ostep & (dt + dlast < omega * dlast)
                # Hit / box-exit use the UNSCALED dt (the sphere-trace
                # invariant "no surface within dt" — identical predicates
                # to the plain march), and only at certified points.
                t2 = t + dt
                done2 = done | (~fail & ((dt < 0.001) | (t2 >= max_t)))
                # Next probe: overstep, or backtrack to the conservative
                # point the plain march would have reached.
                t_next = jnp.where(
                    fail, t - (omega - 1.0) * dlast, t + omega * dt
                )
                # Terminal lanes record the plain-march t2 (the reference
                # march's final t includes the terminal +dt).
                t = jnp.where(done, t, jnp.where(done2, t2, t_next))
                dlast = jnp.where(done | fail, dlast, dt)
                ostep = jnp.where(done, ostep, ~fail)
                done = done2
            return i + _UNROLL, t, dlast, ostep, done

        t_out0 = (jnp.zeros_like(max_t) if t0_seed is None
                  else jnp.where(outside, t0_seed, 0.0))
        i_out, t_o, _, _, _ = jax.lax.while_loop(
            out_cond,
            out_body,
            (
                jnp.int32(0),
                t_out0,
                jnp.zeros_like(max_t),
                jnp.zeros(max_t.shape, bool),
                ~outside | junk,
            ),
        )
    t_o = jnp.minimum(t_o, max_t)
    p_o = p0 + t_o[..., None] * ci

    # --- inside: 128-step fixed march + 48-i backward trace (Render.fx:391-423)
    use_skip = probe2 is not None
    if use_skip and margin is None:
        from .interior import _SKIP_MARGIN

        margin = jnp.float32(_SKIP_MARGIN)
    use_sphere = sphere is not None
    if use_sphere:
        assert not use_skip, "sphere and probe2 skips are mutually exclusive"
        sp_margin, sp_scale, spec = sphere
        sp_margin = jnp.float32(sp_margin)
        sp_scale = jnp.float32(sp_scale)
        assert 128 % spec == 0
    else:
        spec = _SPEC

    def run_inside(_):
        step = inv_m0

        def fwd_cond(c):
            i, p, t, i_exit, exited, boxed, d8, nb = c
            return jnp.any(~(exited | boxed) & (i < 128))

        def fwd_body(c):
            i, p, t, i_exit, exited, boxed, d8, nb = c
            # Interior skip at block boundary (render/interior.py): a lane
            # that is still marching is one step past its last consumed
            # probe, whose d8 certifies that the next
            # k = floor((d8 - margin)/sqrt(3)) lattice points are interior
            # (non-exit); the box clamp keeps every skipped point below
            # max_t so no box event is missed.  k*step and t are exact
            # multiples of step on power-of-two grids, so the skipped
            # lanes land on bit-identical probe positions.  With
            # margin = +inf, k == 0 and t/p are unchanged exactly.
            if use_skip or use_sphere:
                cont = ~(exited | boxed) & (i < 128)
                if use_skip:
                    k = jnp.floor(
                        (d8 - margin) * jnp.float32(0.57735026)
                    ).astype(jnp.int32)
                else:
                    # d8 carries the last consumed distance sample (world
                    # units, negative inside); -d8/step is cells to the
                    # (warped) surface per the SDF property.
                    k = jnp.floor(
                        ((-d8) / step - sp_margin) * sp_scale
                    ).astype(jnp.int32)
                k = jnp.minimum(k, 127 - i)
                k_box = jnp.floor((max_t - t) / step).astype(jnp.int32) - 2
                k = jnp.maximum(jnp.minimum(k, k_box), 0)
                k = jnp.where(cont, k, 0)
                skipped = k > 0
                i = i + k
                t = jnp.where(skipped, t + k.astype(jnp.float32) * step, t)
                p = jnp.where(
                    skipped[..., None], p0 + t[..., None] * ci, p
                )
            # Speculative probe block: the fixed march's probe positions
            # are data-independent given the per-lane step count (every
            # t is an exact multiple of step), so _SPEC sub-steps' probes
            # go out as ONE md() batch — merging what were serial
            # small-batch gathers into a pipelined (_SPEC x batch)-row
            # gather — and the dts are then applied serially in-register
            # with the exact per-lane break semantics (a lane that exits
            # mid-block simply ignores the remaining dts, which the
            # serial form would also have probed and masked).  t/position
            # chains reuse the serial expressions, so results are
            # bit-identical.
            ps = [p]
            ts = [t]
            for j in range(1, spec):
                t_j = ts[-1] + step
                ts.append(t_j)
                ps.append(p0 + t_j[..., None] * ci)
            pstack = jnp.stack(ps, axis=0)  # (spec, *batch, 3)
            if use_skip:
                dts, d8s = probe2(pstack)
            else:
                dts = md(pstack)  # (spec, *batch)
            for j in range(spec):
                active = ~(exited | boxed) & (i + j < 128)
                dt = dts[j]
                t2 = ts[j] + step
                exit_now = active & (dt >= 0.0)
                box_now = active & ~exit_now & (t2 >= max_t)
                i_exit = jnp.where(exit_now, i + j, i_exit)
                p2 = p0 + t2[..., None] * ci
                # On exit: t advances but p does not (reference break order).
                t = jnp.where(active, t2, t)
                p = jnp.where((active & ~exit_now)[..., None], p2, p)
                if use_skip:
                    d8 = jnp.where(
                        active & ~exit_now & ~box_now, d8s[j], d8
                    )
                elif use_sphere:
                    d8 = jnp.where(
                        active & ~exit_now & ~box_now, dts[j], d8
                    )
                exited = exited | exit_now
                boxed = boxed | box_now
            return i + spec, p, t, i_exit, exited, boxed, d8, nb + 1

        if t0_seed is None:
            k_init = jnp.zeros(max_t.shape, jnp.int32)
        else:
            # Seeded start: lattice-aligned (t stays an exact multiple of
            # step on power-of-two grids, like the skip jumps above).
            # Clamped below the box exit so boxed lanes re-box on their
            # first probe; the (128 - k_init) remaining budget and the
            # reused (48 - i_exit) backward counter then behave exactly
            # as if the march had walked to the seed.
            k_box = jnp.maximum(
                jnp.floor(max_t / step).astype(jnp.int32) - 1, 0
            )
            k_init = jnp.clip(
                jnp.floor(t0_seed / step).astype(jnp.int32), 0, 126
            )
            k_init = jnp.minimum(k_init, k_box)
        t_in0 = k_init.astype(jnp.float32) * step
        init = (
            k_init,
            p0 + t_in0[..., None] * ci,
            t_in0,
            jnp.full(max_t.shape, 128, jnp.int32),
            outside | junk,  # outside/junk lanes are inert here
            jnp.zeros(max_t.shape, bool),
            jnp.zeros_like(max_t),  # d8 = 0: no skip before the 1st probe
            jnp.int32(0),
        )
        _, p_i, t_i, i_exit, exited, boxed, _, n_fwd = jax.lax.while_loop(
            fwd_cond, fwd_body, init
        )

        def bwd_cond(c):
            k, p, t, done = c
            return (k < 48) & jnp.any(((i_exit + k) < 48) & ~done & ~boxed)

        def bwd_body(c):
            k, p, t, done = c
            for j in range(_UNROLL):
                active = (
                    ((i_exit + k + j) < 48) & ~done & ~boxed & ~outside & ~junk
                )
                dt = -md(p)
                t2 = t + dt
                done2 = done | (active & (dt > -0.001))
                p2 = p0 + t2[..., None] * ci
                t = jnp.where(active, t2, t)
                p = jnp.where((active & ~(dt > -0.001))[..., None], p2, p)
                done = done2
            return k + _UNROLL, p, t, done

        k_bwd, p_i, t_i, _ = jax.lax.while_loop(
            bwd_cond, bwd_body, (jnp.int32(0), p_i, t_i, jnp.zeros(max_t.shape, bool))
        )
        # Box-exit early return: point exactly at the box edge.
        p_i = jnp.where(boxed[..., None], p0 + max_t[..., None] * ci, p_i)
        t_i = jnp.where(boxed, max_t, t_i)
        return p_i, t_i, n_fwd * spec, k_bwd

    p_i, t_i, fwd_iters, bwd_iters = jax.lax.cond(
        jnp.any(~outside & ~junk),
        run_inside,
        lambda _: (p0, jnp.zeros_like(max_t), jnp.int32(0), jnp.int32(0)),
        operand=None,
    )

    p = jnp.where(outside[..., None], p_o, p_i)
    t = jnp.where(outside, t_o, t_i)
    if stats:
        n = jnp.int32(max_t.size)
        r_out = (1 + i_out) * n  # initial probe + outside sphere trace
        r_fwd = fwd_iters * n
        r_bwd = bwd_iters * n
        rows = jnp.stack([r_out + r_fwd + r_bwd, r_out, r_fwd, r_bwd])
        return p, t, rows
    return p, t


def compute_gradient(md, p):
    """Forward-difference normal (Render.fx:426-438)."""
    top = p[..., 1] > 0.999
    d0 = md(p)
    e = 0.005
    ex = jnp.array([e, 0, 0], jnp.float32)
    ey = jnp.array([0, e, 0], jnp.float32)
    ez = jnp.array([0, 0, e], jnp.float32)
    g = jnp.stack(
        [md(p + ex) - d0, md(p + ey) - d0, md(p + ez) - d0],
        axis=-1,
    )
    up = jnp.array([0.0, 1.0, 0.0], jnp.float32)
    return jnp.where(top[..., None], up, g)


# -- water bounce recursion (unrolled: 2 -> 1 -> 0) -------------------------

def trace_water0(co, ci):
    """Render.fx:442-447."""
    _, _, prim_ci, prim_alpha, refl_sum = trace_glass(co, ci)
    return prim_alpha[..., None] * sample_environment(prim_ci) + refl_sum


def _expand_bounce(md, inv_m0, co, ci, w=None, g9=None, stats=False,
                   probe2=None, margin=None, sphere=None, overstep=None,
                   t_seed=None, seed_back=None, return_t=False):
    """One water-bounce level (the shared body of traceWater1/traceWater2,
    Render.fx:451-515), expressed as ray splitting: returns the hit point
    and two weighted child rays.  A miss forwards the ray unchanged with
    weight 1 (the reference's traceWater0 straight call); on a hit the
    children are the fresnel-weighted reflection and transmission.  Note the
    reference evaluates *both* recursive calls unconditionally in HLSL, so
    zero-weight children (TIR) are traced there too — here they skip the
    march (``dead`` lanes): their color is multiplied by the exact-zero
    accumulated weight upstream, so the output is unchanged while the
    whole-batch early exits stop being dragged by discarded lanes."""
    co = co + 0.001 * ci
    half = jnp.array([0.5, 0.5, 0.5], jnp.float32)
    _, max_t, _, _ = intersect_aabb(co, ci, -half, half)
    dead = None if w is None else (w <= 0.0)
    if stats:
        p_hit, t_hit, md_rows = intersect_water(
            md, inv_m0, co, ci, max_t, dead=dead, stats=True, probe2=probe2,
            margin=margin, sphere=sphere, overstep=overstep,
            t_seed=t_seed, seed_back=seed_back)
    else:
        p_hit, t_hit = intersect_water(md, inv_m0, co, ci, max_t, dead=dead,
                                       probe2=probe2, margin=margin,
                                       sphere=sphere, overstep=overstep,
                                       t_seed=t_seed, seed_back=seed_back)
    ipoint = p_hit - 0.5
    # A ray whose box test missed (max_t == LARGE) is a glass-miss pixel or
    # an epsilon-escaped bounce child: forward it as a miss (the reference's
    # per-pixel short-circuit to traceWater0) instead of marching it.
    # max_t <= 0 is the box BEHIND the ray (a child whose 0.001 epsilon step
    # escaped through the top face): marching it samples the level set at
    # CLAMPED out-of-box coordinates and its first (negative) sample value
    # leaks into t — the reference never marches these (it short-circuits
    # misses), so they forward as misses here too (round 4; previously they
    # produced a spurious clamped-sample "hit" on ~0.5% of pixels).
    missed = (t_hit >= max_t) | (max_t >= LARGE) | (max_t <= 0.0)

    # Surface normal: the Phi9 texture computes all four forward-difference
    # taps from ONE row gather (bit-identical arithmetic — see
    # compute_gradient9); the md-tap form is the fallback for grids where
    # the single-row window can't hold every tap (gradient_fits_phi9).
    if g9 is not None:
        grad = compute_gradient9(g9, p_hit)
    else:
        grad = compute_gradient(md, p_hit)
    norm = _norm(grad, eps=1e-20)
    from_inside = _dot(norm, ci) > 0.0
    n1 = jnp.where(from_inside, 1.333, 1.000)
    n2 = jnp.where(from_inside, 1.000, 1.333)
    norm = jnp.where(from_inside[..., None], -norm, norm)
    fres, refl, trans = fresnel_tr(ci, norm, n1, n2)

    d_a = jnp.where(missed[..., None], ci, refl)
    w_a = jnp.where(missed, 1.0, fres)
    d_b = jnp.where(missed[..., None], ci, trans)
    w_b = jnp.where(missed, 0.0, 1.0 - fres)
    extra = ()
    if return_t:
        # Next frame's seed: the raw march t (hit t; max_t for boxed
        # lanes; >= max_t for misses — every case re-converges in O(1)
        # probes when used as a seeded start).
        extra = (t_hit,)
    if stats:
        g9_rows = jnp.int32(max_t.size if g9 is not None else 0)
        grad_md_rows = jnp.int32(0 if g9 is not None else 4 * max_t.size)
        md_rows = md_rows.at[0].add(grad_md_rows)
        return (ipoint, d_a, w_a, d_b, w_b, (md_rows, g9_rows)) + extra
    return (ipoint, d_a, w_a, d_b, w_b) + extra


def trace_water2(md, inv_m0, co, ci, g9=None, stats=False, probe2=None,
                 margin=None, sphere=None, overstep=None,
                 t_seed=None, seed_back=None, return_t=False):
    """2-bounce water tracing (traceWater2 -> traceWater1 -> traceWater0,
    Render.fx:442-515), restructured as *batched* levels: each bounce level
    concatenates its child rays and traces them in one call (4 leaf rays per
    pixel).  Linearity of the weighted sum makes this the reference's
    unrolled recursion with one HLO instance per level instead of an
    exponential inline tree.  One micro-divergence: the reference's miss
    case short-circuits straight to traceWater0, while here a missed ray
    passes through the remaining bounce level as a weight-1 identity child;
    the extra level immediately re-misses (max_t ~ 0 at the box boundary),
    shifting the ray origin by the 0.001 epsilon step once more."""
    shape = co.shape

    # Temporal seeding covers BOTH march levels (round 5): t_seed is a
    # (3, *batch) stack — [0] the primary march t, [1:3] the two level-2
    # bounce children's ts.  For a static camera the children's rays drift
    # only with the water surface, the same bounded motion the backoff
    # absorbs on the primary (level-2 divergence compounds the primary
    # drift; covered by the same measured pixel bound).
    t1 = t_seed[0] if t_seed is not None else None
    r1 = _expand_bounce(md, inv_m0, co, ci, g9=g9, stats=stats,
                        probe2=probe2, margin=margin, sphere=sphere,
                        overstep=overstep, t_seed=t1,
                        seed_back=seed_back, return_t=return_t)
    ip1, d_a, w_a, d_b, w_b = r1[:5]
    t_prim = r1[-1] if return_t else None
    co2 = jnp.concatenate([ip1, ip1], axis=0)
    d2 = jnp.concatenate([d_a, d_b], axis=0)
    w2 = jnp.concatenate([w_a, w_b], axis=0)

    # Children batch is the level-1 batch concatenated along axis 0, so
    # the two seed planes concatenate the same way.
    t2 = (jnp.concatenate([t_seed[1], t_seed[2]], axis=0)
          if t_seed is not None else None)
    r2 = _expand_bounce(md, inv_m0, co2, d2, w=w2, g9=g9, stats=stats,
                        probe2=probe2, margin=margin, sphere=sphere,
                        overstep=overstep, t_seed=t2,
                        seed_back=seed_back, return_t=return_t)
    ip2, d_c, w_c, d_d, w_d = r2[:5]
    if return_t:
        t_child = r2[-1].reshape(2, *shape[:-1])
        t_prim = jnp.concatenate([t_prim[None], t_child], axis=0)
    co3 = jnp.concatenate([ip2, ip2], axis=0)
    d3 = jnp.concatenate([d_c, d_d], axis=0)
    w3 = jnp.concatenate([w2 * w_c, w2 * w_d], axis=0)

    cols = trace_water0(co3, d3)  # (4*N, ..., 3)
    cols = cols.reshape(4, *shape)
    w3 = w3.reshape(4, *shape[:-1])
    out = (cols * w3[..., None]).sum(axis=0)
    res = (out,)
    if stats:
        res = (out, (r1[5][0] + r2[5][0], r1[5][1] + r2[5][1]))
    if return_t:
        res = res + (t_prim,)
    return res if len(res) > 1 else out


def trace_water1(md, inv_m0, co, ci, g9=None, probe2=None, sphere=None,
                 overstep=None, t_seed=None, seed_back=None,
                 return_t=False):
    """1-bounce variant (traceWater1), kept for API parity."""
    shape = co.shape
    t1 = t_seed[0] if t_seed is not None else None
    r1 = _expand_bounce(md, inv_m0, co, ci, g9=g9,
                        probe2=probe2, sphere=sphere,
                        overstep=overstep, t_seed=t1,
                        seed_back=seed_back, return_t=return_t)
    ip1, d_a, w_a, d_b, w_b = r1[:5]
    co2 = jnp.concatenate([ip1, ip1], axis=0)
    d2 = jnp.concatenate([d_a, d_b], axis=0)
    w2 = jnp.concatenate([w_a, w_b], axis=0)
    cols = trace_water0(co2, d2).reshape(2, *shape)
    out = (cols * w2.reshape(2, *shape[:-1])[..., None]).sum(axis=0)
    if return_t:
        # No level-2 march at bounces=1: child slots carry LARGE (a LARGE
        # seed re-exits in O(1) probes if later consumed at bounces=2).
        t3 = jnp.concatenate(
            [r1[-1][None], jnp.full((2, *shape[:-1]), LARGE, jnp.float32)],
            axis=0,
        )
        return out, t3
    return out


# -- top-level pixel shader --------------------------------------------------

def shade(phi, co, ci, g9=None, bounces: int = 2, stats=False, texs=None,
          skip_margin=None, sphere=None, overstep=None,
          t_seed=None, seed_back=None, return_t=False):
    """PS main (Render.fx:518-578) for ray batches.

    `phi` may be the raw level set or a pre-built PackedPhi (pack once per
    frame, render many tiles — the pack costs ~ms at 128^3 and must not be
    paid per tile); all map() sampling goes through the packed texture.
    ``g9``: optional pre-built PackedPhi9 gradient-tap texture (one row
    gather per surface normal instead of four).
    ``texs``: optional pre-built interior.PackedPhiSkip — enables the
    provably-exact interior skip on the inside forward march
    (bit-identical image on power-of-two grids; see intersect_water).
    ``bounces``: water-bounce recursion depth — 2 is the reference's PS
    main (traceWater2); 1/0 select the reference's lower tiers
    (traceWater1/traceWater0, Render.fx:442-515) as cheaper quality
    levels.
    ``sphere``: (margin_cells, scale, spec) sphere-trace skip for the
    inside march (see intersect_water) — zero extra gathers; scale=0 is
    the exact march bit-for-bit."""
    if isinstance(phi, PackedPhi8):
        tex = phi
        md = lambda p: map_dist_packed8(tex, p)
    elif isinstance(phi, PackedPhi):
        tex = phi
        md = lambda p: map_dist_packed(tex, p)
    else:
        tex = PackedPhi(phi)
        md = lambda p: map_dist_packed(tex, p)
    probe2 = None
    if texs is not None:
        from .interior import probe_skip

        probe2 = lambda p: probe_skip(texs, p)
    inv_m0 = 1.0 / jnp.float32(tex.dims[0])
    h, prim_co, prim_ci, _, _ = trace_glass(co, ci)
    hit = h < LARGE
    st = None
    t_prim = None
    if bounces >= 2:
        r = trace_water2(md, inv_m0, prim_co, prim_ci, g9=g9,
                         stats=stats, probe2=probe2,
                         margin=skip_margin, sphere=sphere,
                         overstep=overstep, t_seed=t_seed,
                         seed_back=seed_back, return_t=return_t)
        if stats or return_t:
            col_water = r[0]
            if stats:
                st = r[1]
            if return_t:
                t_prim = r[-1]
        else:
            col_water = r
    elif bounces == 1:
        r = trace_water1(md, inv_m0, prim_co, prim_ci, g9=g9,
                         probe2=probe2, sphere=sphere,
                         overstep=overstep, t_seed=t_seed,
                         seed_back=seed_back, return_t=return_t)
        col_water, t_prim = r if return_t else (r, None)
    else:
        assert not return_t, "bounces=0 has no water march to seed"
        col_water = trace_water0(prim_co, prim_ci)
    col_sky = sample_environment(ci)
    col = jnp.where(hit[..., None], col_water, col_sky)
    out = jnp.abs(col) ** 2.2
    # The reference feeds unset primary rays (largeNum sentinels) through the
    # water tracer when every glass bounce is TIR (Render.fx:341-344 never
    # fires) and displays the resulting f32 garbage on those rare pixels.  A
    # tensor API shouldn't return inf/nan, so bound them instead.
    img = jnp.nan_to_num(out, nan=0.0, posinf=1.0, neginf=0.0)
    res = (img,)
    if stats:
        # (image, (md_rows, g9_rows)) -- diag-only shape; image identical.
        res = res + ((st if st is not None
                      else (jnp.zeros(4, jnp.int32), jnp.int32(0))),)
    if return_t:
        # (3, *batch): primary + two level-2 child march ts.  Glass-miss
        # lanes carry LARGE so a later frame never seeds a transiently-junk
        # lane with stale garbage.
        res = res + (jnp.where(hit[None], t_prim, LARGE),)
    return res if len(res) > 1 else img


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "tile_h", "tile_w", "bounces",
                     "sphere_spec", "return_t"),
)
def _render_tile(tex, cam_pos, cam_right, cam_up, cam_fwd,
                 width: int, height: int, tile_h: int, tile_w: int, y0, x0,
                 g9=None, bounces: int = 2, texs=None,
                 sphere_margin=None, sphere_scale=None,
                 sphere_spec: int | None = None, overstep=None,
                 t_seed=None, seed_back=None, return_t: bool = False):
    """Render the (tile_h, tile_w) tile at rows [y0, ...), cols [x0, ...)."""
    px = (x0 + jnp.arange(tile_w, dtype=jnp.float32) + 0.5) / width
    py = (y0 + jnp.arange(tile_h, dtype=jnp.float32) + 0.5) / height
    fx, fy = jnp.meshgrid(px, py, indexing="xy")
    u = -1.0 + 2.0 * fx
    v = 1.0 - 2.0 * fy
    ci = _norm(u[..., None] * cam_right + v[..., None] * cam_up + cam_fwd)
    co = jnp.broadcast_to(cam_pos, ci.shape)
    sphere = (
        None if sphere_spec is None
        else (sphere_margin, sphere_scale, sphere_spec)
    )
    return shade(tex, co, ci, g9=g9, bounces=bounces, texs=texs,
                 sphere=sphere, overstep=overstep,
                 t_seed=t_seed, seed_back=seed_back, return_t=return_t)


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "tile_h", "tile_w", "bounces",
                     "sphere_spec", "return_t"),
)
def _render_scan(tex, cam_pos, cam_right, cam_up, cam_fwd,
                 width: int, height: int, tile_h: int, tile_w: int,
                 g9=None, bounces: int = 2, texs=None,
                 sphere_margin=None, sphere_scale=None,
                 sphere_spec: int | None = None, overstep=None,
                 t_seed=None, seed_back=None, return_t: bool = False):
    """All tiles under ONE compiled program (lax.scan over tile origins):
    keeps the per-tile whole-batch early exits while paying dispatch
    overhead once instead of once per tile."""
    nty = -(-height // tile_h)
    ntx = -(-width // tile_w)
    ys = jnp.repeat(jnp.arange(nty, dtype=jnp.float32) * tile_h, ntx)
    xs = jnp.tile(jnp.arange(ntx, dtype=jnp.float32) * tile_w, nty)
    if t_seed is not None:
        # (3, H, W) march-t planes (primary + 2 bounce children).  Pad the
        # spatial extent to the tiled size; padded lanes carry LARGE (a
        # LARGE seed re-exits in O(1) probes; junk lanes stored LARGE too).
        t_seed = jnp.pad(
            t_seed,
            ((0, 0), (0, nty * tile_h - height), (0, ntx * tile_w - width)),
            constant_values=LARGE,
        )

    def body(_, yx):
        seed_tile = None
        if t_seed is not None:
            seed_tile = jax.lax.dynamic_slice(
                t_seed,
                (jnp.int32(0), yx[0].astype(jnp.int32),
                 yx[1].astype(jnp.int32)),
                (3, tile_h, tile_w),
            )
        out = _render_tile(
            tex, cam_pos, cam_right, cam_up, cam_fwd,
            width, height, tile_h, tile_w, yx[0], yx[1], g9=g9,
            bounces=bounces, texs=texs,
            sphere_margin=sphere_margin, sphere_scale=sphere_scale,
            sphere_spec=sphere_spec, overstep=overstep,
            t_seed=seed_tile, seed_back=seed_back, return_t=return_t,
        )
        return 0, out

    _, tiles = jax.lax.scan(body, 0, jnp.stack([ys, xs], axis=1))
    if return_t:
        tiles, t_tiles = tiles
        t_plane = t_tiles.reshape(nty, ntx, 3, tile_h, tile_w).transpose(
            2, 0, 3, 1, 4
        ).reshape(3, nty * tile_h, ntx * tile_w)[:, :height, :width]
    img = tiles.reshape(nty, ntx, tile_h, tile_w, 3).transpose(0, 2, 1, 3, 4)
    img = img.reshape(nty * tile_h, ntx * tile_w, 3)[:height, :width]
    return (img, t_plane) if return_t else img


SEED_BACK = 6.0  # cells; see render() docstring


def _coarse_seed_upsample(t_c, k: int, height: int, width: int):
    """Conservative full-res seed planes from a coarse pass's return_t.

    Junk/miss lanes carry LARGE — map them to 0 (cold start) BEFORE
    pooling so a coarse glass-silhouette miss never seeds a fine hit
    lane past its surface.  A 3x3 min-pool over coarse cells (padded
    with 0 = cold) absorbs one coarse cell of silhouette displacement;
    nearest upsample by k, crop to the frame."""
    t = jnp.where(t_c >= LARGE, 0.0, t_c)
    p = jnp.pad(t, ((0, 0), (1, 1), (1, 1)))
    m = t
    hc, wc = t.shape[1], t.shape[2]
    for dy in range(3):
        for dx in range(3):
            m = jnp.minimum(m, p[:, dy:dy + hc, dx:dx + wc])
    m = jnp.repeat(jnp.repeat(m, k, axis=1), k, axis=2)
    return m[:, :height, :width]


def render(phi, cam_pos, cam_right, cam_up, cam_fwd, width: int, height: int,
           band_rows: int = 0, band_cols: int = 0, bounces: int = 2,
           interior_skip: bool = False, sphere_trace: bool = False,
           sphere_margin: float = SPHERE_MARGIN,
           sphere_scale: float = SPHERE_SCALE, sphere_spec: int = _SPEC,
           overstep: float = 0.0,
           t_seed=None, seed_back: float = SEED_BACK,
           return_t: bool = False, coarse_seed: int = 0):
    """Render a (height, width, 3) float32 image from the level set.

    Rays: fragCoord uv mapping per Render.fx:521 + VS:48-58; camera frame
    from render/camera.py (FOV scaling folded into right/up).

    band_rows/band_cols > 0 render the frame in tiles, all under one
    compiled program (the packed phi texture is built once per frame): the
    raymarch loops exit when *all* rays in a tile converge, and depth is
    spatially coherent, so small tiles exit much earlier.  band_cols
    defaults to 100 when tiling.  The tile size is a plain parameter (the
    image is the same for every tiling); app/demo.py passes 100 rows at
    128^3 and up, 64 below, until the benchmark re-measures the choice.

    When `phi` is the raw level set and the grid fits the single-row
    gradient window (gradient_fits_phi9), a PackedPhi9 gradient-tap
    texture is built alongside so every surface normal costs one row
    gather instead of four (bit-identical image).

    ``interior_skip`` (raw-phi callers, power-of-two grids only) builds
    the interior.PackedPhiSkip texture so the inside forward march jumps
    provably-interior lattice steps — bit-identical image, fewer march
    iterations (the win scales with water thickness).

    ``sphere_trace``: sphere-trace skip on the inside march using the
    distance samples the march already fetched (no auxiliary texture, no
    extra gathers).  Approximate — measured pixel-diff bound in
    docs/PARITY.md; scale=0 reproduces the exact march.

    ``overstep``: omega > 1 enables enhanced sphere tracing on the
    OUTSIDE march — see intersect_water.  Approximate with a measured
    pixel-diff bound (docs/PARITY.md); 0.0/1.0 keep the exact reference
    march.

    ``t_seed``/``seed_back``/``return_t``: temporal frame coherence
    (the reference re-pays a 64-step cold march per pixel every
    frame, Render.fx:369).  ``return_t=True`` additionally returns a
    (3, height, width) per-pixel march-t stack — [0] the primary water
    march, [1:3] the two level-2 bounce children; pass it back as
    ``t_seed`` on the next frame — IF the camera did not move — and every
    seeded march starts ``seed_back`` CELLS before its previous hit
    instead of cold.  Hits are re-refined locally (see intersect_water),
    so the divergence is bounded by surface motion > seed_back cells/frame
    entering the skipped prefix; measured pixel-diff bound in
    docs/PARITY.md.  seed_back >= grid diameter reproduces the cold march
    bit-for-bit (the equality test).  bounces=2/1 only.
    """
    if isinstance(phi, (PackedPhi, PackedPhi8)):
        if sphere_trace:
            # A pre-built texture was packed from RAW phi, which saturates
            # at ~-particle_radius inside the fluid — the skip would clamp
            # to 0 steps and silently do nothing.  Require raw phi.
            raise ValueError(
                "sphere_trace needs the raw level set (the march texture "
                "must be deepened at pack time; pass phi, not a PackedPhi)"
            )
        tex, g9, texs = phi, None, None
    else:
        if interior_skip and sphere_trace:
            raise ValueError(
                "interior_skip and sphere_trace are mutually exclusive "
                "inside-march skips — pick one"
            )
        if sphere_trace:
            from .interior import deepen_phi

            # March texture carries the folded interior distance; the
            # gradient texture keeps the raw phi (its taps never touch
            # deepened nodes anyway — buffer 3 > tap support ~2.3 cells).
            tex = PackedPhi(deepen_phi(phi))
        else:
            tex = PackedPhi(phi)
        g9 = PackedPhi9(phi) if gradient_fits_phi9(phi.shape) else None
        texs = None
        if interior_skip and all((d & (d - 1)) == 0 for d in phi.shape):
            from .interior import PackedPhiSkip

            texs = PackedPhiSkip(phi)
    sm = jnp.float32(sphere_margin) if sphere_trace else None
    sc = jnp.float32(sphere_scale) if sphere_trace else None
    sp = sphere_spec if sphere_trace else None
    ov = jnp.float32(overstep) if overstep and overstep > 1.0 else None
    if t_seed is not None:
        t_seed = jnp.asarray(t_seed, jnp.float32)
        assert t_seed.shape == (3, height, width), t_seed.shape
    # seed_back cells -> world units (box [-0.5,0.5]^3, cell = 1/dims[0]).
    sb = (jnp.float32(seed_back / tex.dims[0])
          if (t_seed is not None or return_t or coarse_seed > 1) else None)
    if coarse_seed > 1 and t_seed is None and bounces >= 1:
        # SAME-FRAME coarse seeding: a 1/k-res pre-pass over the
        # same textures/modes yields fresh per-pixel march ts; the full-res
        # marches start seed_back cells before the conservatively
        # min-pooled coarse hit instead of cold.  Unlike temporal seeding
        # the seeds are never stale, so this pays on moving scenes too;
        # the error class is the seeded re-refinement's (measured
        # pixel-diff bound in docs/PARITY.md).  Both passes trace
        # into ONE program under render_frame's jit.
        kc = int(coarse_seed)
        hc, wc = -(-height // kc), -(-width // kc)
        _, t_c = _render_scan(
            tex, cam_pos, cam_right, cam_up, cam_fwd,
            wc, hc, min(50, hc), min(100, wc), g9=g9, bounces=bounces,
            texs=texs, sphere_margin=sm, sphere_scale=sc, sphere_spec=sp,
            overstep=ov, t_seed=None, seed_back=sb, return_t=True,
        )
        t_seed = _coarse_seed_upsample(t_c, kc, height, width)
    if band_rows <= 0 and band_cols <= 0:
        return _render_tile(
            tex, cam_pos, cam_right, cam_up, cam_fwd,
            width, height, height, width, jnp.float32(0), jnp.float32(0),
            g9=g9, bounces=bounces, texs=texs,
            sphere_margin=sm, sphere_scale=sc, sphere_spec=sp, overstep=ov,
            t_seed=t_seed, seed_back=sb, return_t=return_t,
        )
    tile_h = band_rows if 0 < band_rows <= height else height
    tile_w = band_cols if 0 < band_cols <= width else (
        100 if width % 100 == 0 else width
    )
    return _render_scan(
        tex, cam_pos, cam_right, cam_up, cam_fwd,
        width, height, tile_h, tile_w, g9=g9, bounces=bounces, texs=texs,
        sphere_margin=sm, sphere_scale=sc, sphere_spec=sp, overstep=ov,
        t_seed=t_seed, seed_back=sb, return_t=return_t,
    )


@functools.partial(
    jax.jit,
    static_argnames=("width", "height", "band_rows", "band_cols", "bounces",
                     "interior_skip", "sphere_trace", "sphere_margin",
                     "sphere_scale", "sphere_spec", "overstep", "seed_back",
                     "return_t", "coarse_seed"),
)
def render_frame(phi, cam_pos, cam_right, cam_up, cam_fwd, *,
                 width: int, height: int,
                 band_rows: int = 0, band_cols: int = 0, bounces: int = 2,
                 interior_skip: bool = False, sphere_trace: bool = True,
                 sphere_margin: float = SPHERE_MARGIN,
                 sphere_scale: float = SPHERE_SCALE,
                 sphere_spec: int = _SPEC, overstep: float = 0.0,
                 t_seed=None, seed_back: float = SEED_BACK,
                 return_t: bool = False, coarse_seed: int = 0):
    """One fully-jitted frame from the RAW level set: the texture builds
    (PackedPhi + the Phi9 gradient rows) compile into the same program as
    the tile scan, so a frame is ONE dispatch instead of ~40 eager texture
    ops + the scan.  Frame-loop callers (bench.py, app/demo.py) use
    this entry; ``render`` stays for callers that pre-build a texture once
    and render many frames from it.

    Unlike ``render``, ``sphere_trace`` defaults ON here: it is
    bit-identical on every tested scene at the certified margin
    (tests/test_render.py::test_sphere_trace_mode_matches_exact) and does
    fewer inside-march probes.  ``sphere_trace=False`` keeps the plain
    1-cell inside march."""
    return render(phi, cam_pos, cam_right, cam_up, cam_fwd, width, height,
                  band_rows=band_rows, band_cols=band_cols, bounces=bounces,
                  interior_skip=interior_skip, sphere_trace=sphere_trace,
                  sphere_margin=sphere_margin, sphere_scale=sphere_scale,
                  sphere_spec=sphere_spec, overstep=overstep,
                  t_seed=t_seed, seed_back=seed_back, return_t=return_t,
                  coarse_seed=coarse_seed)
