"""Combined-key packed interpolation == pointwise reference interpolation.

The combined table (core/interp_combined.py) over-fetches one lane per
hat-reduced axis; these tests pin down that the hat weights vanish there for
every clamp edge case of Simulation3D.h:55-123.
"""

import numpy as np

import jax.numpy as jnp

from fluidsimulation.core.interp import interp_mac3
from fluidsimulation.core.interp_combined import (
    interp_mac3_combined,
    pack_mac3_combined,
)

NX, NY, NZ = 12, 8, 16


def _grids(seed=0):
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((NX + 1, NY, NZ)).astype(np.float32)
    v = rng.standard_normal((NX, NY + 1, NZ)).astype(np.float32)
    w = rng.standard_normal((NX, NY, NZ + 1)).astype(np.float32)
    return jnp.asarray(u), jnp.asarray(v), jnp.asarray(w)


def _check(u, v, w, pi, pj, pk):
    tab = pack_mac3_combined(u, v, w)
    got = interp_mac3_combined(
        tab, (NX, NY, NZ), jnp.asarray(pi), jnp.asarray(pj), jnp.asarray(pk)
    )
    want = interp_mac3(u, v, w, jnp.asarray(pi), jnp.asarray(pj), jnp.asarray(pk))
    for g, t in zip(got, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(t), atol=2e-6)


def test_random_interior():
    rng = np.random.default_rng(1)
    n = 5000
    pi = (rng.random(n) * NX).astype(np.float32)
    pj = (rng.random(n) * NY).astype(np.float32)
    pk = (rng.random(n) * NZ).astype(np.float32)
    _check(*_grids(), pi, pj, pk)


def test_edges_and_out_of_range():
    """Clamp quirks: below 0, above n-1, exactly integral, half-offsets."""
    vals_x = np.array(
        [-0.7, -0.5, 0.0, 0.25, 0.5, 1.0, NX - 2.0, NX - 1.5, NX - 1.0,
         NX - 0.5, NX - 0.2, float(NX)], np.float32
    )
    pi, pj, pk = np.meshgrid(
        vals_x, vals_x * NY / NX, vals_x * NZ / NX, indexing="ij"
    )
    _check(*_grids(3), pi.ravel(), pj.ravel(), pk.ravel())


def test_integral_positions():
    xs = np.arange(NX, dtype=np.float32)
    pi = np.repeat(xs, 4)
    pj = np.tile(np.array([0.0, 1.0, NY - 2.0, NY - 1.0], np.float32), NX)
    pk = np.linspace(0, NZ - 1, 4 * NX).astype(np.float32)
    _check(*_grids(5), pi, pj, pk)
