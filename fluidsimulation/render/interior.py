"""Interior-distance acceleration field for the inside water march.

The reference's inside march takes fixed 1-cell steps until phi >= 0
(Render.fx:391-409) precisely because phi saturates at about -particle
radius inside the fluid (phi = distance-to-nearest-particle - radius,
gpComputeClosestParticleNeighbors.hlsl:101) — it carries no depth
information.  This module builds the missing information per frame: the
L1 (Manhattan) node distance to the nearest phi >= 0 node, reduced over
each cell's 8 corners.  A marching lane that reads d8 >= margin can skip
floor((d8 - margin)/sqrt(3)) whole lattice steps, because

  * trilinear interpolation of 8 strictly-negative corner values is
    strictly negative (the exit test md(p) >= 0 cannot fire), and
  * consecutive probes move 1 cell (Euclidean) along the ray, <= sqrt(3)
    in L1; the quintic warp (Render.fx:81-115) displaces the sample by
    <= ~0.2 cells per x/z axis, and corner snapping adds <= 1 per axis —
    all absorbed by the margin (see _SKIP_MARGIN).

The skipped lattice points are therefore provably non-exits: the march
visits exactly the same decision points as the serial reference loop.
Skips only change the float value of t when repeated addition of the
step differs from a single fused add — for power-of-two grids the step
is exactly representable and every t = n*step is exact in f32, so the
march is bit-identical (asserted by running the same compiled pool with
the skip margin set to +inf; tests/test_interior.py).

The distance transform is 6 log-doubling min-plus passes (2 directions x
3 axes, exact: coverage 2^(k+1)-1 after step 2^k), all full-grid
vectorized ops — no scans.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import raytrace as rt

_BIG = 1.0e6
# Safety margin in L1 cells: sqrt(3) ray step growth is applied by the
# caller; the margin absorbs warp wobble (~0.4), corner snapping (3),
# and a guard (1.6).
_SKIP_MARGIN = 5.0
_INV_SQRT3 = 0.57735026


def _shift_min_plus(f, s, axis):
    """min(f, f[... i+s ...] + s, f[... i-s ...] + s) with +inf edges."""
    n = f.shape[axis]
    pad = [(0, 0)] * f.ndim
    pad[axis] = (0, s)
    fwd = jnp.pad(f, pad, constant_values=_BIG)
    fwd = jnp.take(fwd, jnp.arange(s, n + s), axis=axis)
    pad[axis] = (s, 0)
    bwd = jnp.pad(f, pad, constant_values=_BIG)
    bwd = jnp.take(bwd, jnp.arange(0, n), axis=axis)
    return jnp.minimum(f, jnp.minimum(fwd, bwd) + jnp.float32(s))


def l1_distance_to_nonneg(phi):
    """Per-node L1 distance (in cells) to the nearest node with phi >= 0.

    Exact min-plus distance transform by log-doubling: after shifts
    s = 1, 2, 4, ..., coverage is 2^(k+1)-1, so s < n suffices."""
    f = jnp.where(phi >= 0.0, 0.0, _BIG).astype(jnp.float32)
    for axis in range(3):
        s = 1
        while s < phi.shape[axis]:
            f = _shift_min_plus(f, s, axis)
            s *= 2
    return f


def deepen_phi(phi, buffer: float = 3.0):
    """Fold a certified interior Euclidean distance into phi for the MARCH
    texture: nodes deeper than ``buffer``
    cells (L1/sqrt3-certified Euclidean lower bound) get
    phi := -(L1/sqrt3).  Inside the fluid the raw phi saturates at about
    -particle_radius (module docstring) and the fixed inside march uses
    interior samples only through their SIGN — deepened values stay
    strictly negative, so exits, the backward refine and surface gradients
    (whose sample supports sit within ~2.3 cells of the surface, inside
    the buffer) are untouched, while the sphere-trace skip in
    intersect_water reads a real distance from the row it already
    gathered.  Returned field is in cell units like phi."""
    d = l1_distance_to_nonneg(phi) * jnp.float32(_INV_SQRT3)
    return jnp.where(d >= jnp.float32(buffer), -d, phi)


def corner_min8(d):
    """d8[cell] = min over the cell's 2x2x2 corner nodes; shape (n-1,)^3."""
    for axis in range(3):
        n = d.shape[axis]
        a = jnp.take(d, jnp.arange(0, n - 1), axis=axis)
        b = jnp.take(d, jnp.arange(1, n), axis=axis)
        d = jnp.minimum(a, b)
    return d


import jax  # noqa: E402  (registered class below)


@jax.tree_util.register_pytree_node_class
class PackedPhiSkip:
    """PackedPhi rows widened to 160 lanes: [0:128] the standard 4x32
    phi corner layout (identical to PackedPhi — same gather key, same
    trilerp), [128:160] the d8 interior-distance lane block for the
    (ix, iy) cell column at z = 31*seg + lane (0-padded past nz-2, which
    disables skipping there — safe default)."""

    def __init__(self, phi=None, *, rows=None, dims=None, ns=None):
        if phi is None:
            self.rows, self.dims, self.ns = rows, dims, ns
            return
        base = rt.PackedPhi(phi)
        self.dims, self.ns = base.dims, base.ns
        nx, ny, nz = self.dims
        d8 = corner_min8(l1_distance_to_nonneg(phi))  # (nx-1, ny-1, nz-1)
        seg, lanes = rt._SEG, rt._LANES
        pad = seg * (self.ns - 1) + lanes
        d8p = jnp.pad(d8, ((0, 0), (0, 0), (0, pad - (nz - 1))))
        dseg = jnp.stack(
            [d8p[..., seg * s: seg * s + lanes] for s in range(self.ns)],
            axis=-2,
        )  # (nx-1, ny-1, ns, L)
        drows = dseg.reshape((nx - 1) * (ny - 1) * self.ns, lanes)
        self.rows = jnp.concatenate([base.rows, drows], axis=-1)

    def tree_flatten(self):
        return (self.rows,), (self.dims, self.ns)

    @classmethod
    def tree_unflatten(cls, aux, children):
        dims, ns = aux
        return cls(rows=children[0], dims=dims, ns=ns)


def sample_phi_skip(tex: PackedPhiSkip, p):
    """(phi_sample, d8_at_cell): the phi math is sample_phi_packed's,
    d8 is a one-hot lane select from the widened block."""
    nx, ny, nz = tex.dims
    n = jnp.array(tex.dims, jnp.float32)
    q = jnp.clip(p * n - 0.5, 0.0, n - 1.0)
    i = jnp.minimum(jnp.floor(q), n - 2.0)
    f = q - i
    ix = i[..., 0].astype(jnp.int32)
    iy = i[..., 1].astype(jnp.int32)
    iz = i[..., 2].astype(jnp.int32)
    seg = (iz // rt._SEG).astype(jnp.int32)
    key = (ix * (ny - 1) + iy) * tex.ns + seg
    shape = key.shape
    rows = tex.rows[key.reshape(-1)]
    phi_rows = rows[:, : 4 * rt._LANES].reshape(-1, 4, rt._LANES)
    d_rows = rows[:, 4 * rt._LANES:]
    lane = jax.lax.broadcasted_iota(jnp.float32, (1, 1, rt._LANES), 2)
    zpos = (jnp.float32(rt._SEG) * seg.reshape(-1, 1, 1).astype(jnp.float32)
            + lane)
    qz = q[..., 2].reshape(-1, 1, 1)
    wz = jnp.maximum(0.0, 1.0 - jnp.abs(qz - zpos))
    zred = (phi_rows * wz).sum(-1)
    fx = f[..., 0].reshape(-1)
    fy = f[..., 1].reshape(-1)
    w4 = jnp.stack(
        [(1 - fx) * (1 - fy), (1 - fx) * fy, fx * (1 - fy), fx * fy], axis=-1
    )
    phi_s = (zred * w4).sum(-1).reshape(shape)
    # one-hot z-lane select of d8 at the probe's cell
    zlane = (iz - rt._SEG * seg).reshape(-1, 1)
    lane1 = jax.lax.broadcasted_iota(jnp.int32, (1, rt._LANES), 1)
    d8 = jnp.where(lane1 == zlane, d_rows, 0.0).sum(-1).reshape(shape)
    return phi_s, d8


def probe_skip(tex: PackedPhiSkip, p):
    """(map_dist, d8) — the distance-field probe plus the per-cell
    interior L1 distance the pool's inside march uses to skip steps."""
    phi_s, d8 = sample_phi_skip(tex, rt._warp(p, tex.dims))
    return phi_s / jnp.float32(tex.dims[0]), d8
