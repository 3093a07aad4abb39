"""PackedPhi9 single-gather gradient + speculative inside-march tests.

Both changes claim BIT-IDENTICAL results vs the incumbent formulations
within one program (raytrace.py docstrings); these tests pin that:

* compute_gradient9 vs the four-tap md() gradient (same warped floors,
  hat weights and corner mix; the shared 3x3-corner row holds every
  tap's 2x2x2 neighborhood because taps shift the warped floor by at
  most +1 per axis — gradient_fits_phi9).
* intersect_water with the _SPEC speculative probe block vs the serial
  (_SPEC=1) march: probe positions are data-independent given the
  shared step chain, so batching them changes no per-lane arithmetic.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fluidsimulation.core.config import SimConfig
from fluidsimulation.core.state import init_state
from fluidsimulation.render import raytrace as rt
from fluidsimulation.render.camera import OrbitCamera
from fluidsimulation.solver.step3d import step_jit

CFG = SimConfig(nx=16, ny=16, nz=16, cells_per_meter=16.0)


@pytest.fixture(scope="module")
def phi16():
    state = init_state(CFG)
    for _ in range(3):
        state = step_jit(state, 1.0 / 60.0, CFG)
    return state.phi


def _points(n, seed):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.0, 1.0, size=(n, 3)).astype(np.float32)
    # Boundary + top-branch coverage.
    p[:16] = rng.uniform(0.0, 0.05, size=(16, 3))
    p[16:32] = rng.uniform(0.95, 1.0, size=(16, 3))
    p[32:40, 1] = 0.9995
    return jnp.asarray(p)


def test_gradient_fits_phi9_gate():
    assert rt.gradient_fits_phi9((128, 128, 128))
    assert rt.gradient_fits_phi9((16, 16, 16))
    assert not rt.gradient_fits_phi9((160, 160, 160))


@pytest.mark.parametrize("shape", [(16, 16, 16), (32, 32, 32)])
def test_gradient9_matches_dense_random(shape):
    rng = np.random.default_rng(3)
    phi = jnp.asarray(rng.normal(size=shape).astype(np.float32))
    tex = rt.PackedPhi(phi)
    g9 = rt.PackedPhi9(phi)
    md = lambda p: rt.map_dist_packed(tex, p)
    p = _points(2048, seed=5)
    a = np.asarray(rt.compute_gradient(md, p))
    b = np.asarray(rt.compute_gradient9(g9, p))
    np.testing.assert_array_equal(a, b)


def test_gradient9_matches_dense_levelset(phi16):
    tex = rt.PackedPhi(phi16)
    g9 = rt.PackedPhi9(phi16)
    md = lambda p: rt.map_dist_packed(tex, p)
    p = _points(2048, seed=7)
    a = np.asarray(rt.compute_gradient(md, p))
    b = np.asarray(rt.compute_gradient9(g9, p))
    np.testing.assert_array_equal(a, b)


def test_spec_march_matches_serial(phi16, monkeypatch):
    tex = rt.PackedPhi(phi16)
    md = lambda p: rt.map_dist_packed(tex, p)
    inv_m0 = 1.0 / jnp.float32(tex.dims[0])
    rng = np.random.default_rng(11)
    n = 777
    co = rng.uniform(-0.49, 0.49, size=(n, 3)).astype(np.float32)
    co[:, 1] = rng.uniform(-0.49, 0.2, size=n)
    co[: n // 3] = rng.uniform(-1.5, 1.5, size=(n // 3, 3))
    ci = rng.normal(size=(n, 3)).astype(np.float32)
    ci /= np.linalg.norm(ci, axis=1, keepdims=True)
    co, ci = jnp.asarray(co), jnp.asarray(ci)
    half = jnp.array([0.5, 0.5, 0.5], jnp.float32)
    _, max_t, _, _ = rt.intersect_aabb(co, ci, -half, half)

    p_spec, t_spec = rt.intersect_water(md, inv_m0, co, ci, max_t)
    monkeypatch.setattr(rt, "_SPEC", 1)
    p_ser, t_ser = rt.intersect_water(md, inv_m0, co, ci, max_t)
    np.testing.assert_array_equal(np.asarray(t_spec), np.asarray(t_ser))
    # p: bit-identical on an accelerator; XLA:CPU contracts the two programs'
    # p0 + t*ci differently (measured: one element, 1 ulp).
    np.testing.assert_allclose(
        np.asarray(p_spec), np.asarray(p_ser), atol=1e-7
    )


@pytest.mark.slow  # round 5: 38 s; gradient9 parity stays fast via
# the dense-random/levelset tests, march parity via spec_march
def test_render_g9_matches_dense_taps(phi16, monkeypatch):
    co, right, up, fwd = OrbitCamera().frame(64, 48)
    img_g9 = np.asarray(
        rt.render(phi16, co, right, up, fwd, 64, 48, band_rows=24)
    )
    monkeypatch.setattr(rt, "gradient_fits_phi9", lambda dims: False)
    img_md = np.asarray(
        rt.render(phi16, co, right, up, fwd, 64, 48, band_rows=24)
    )
    np.testing.assert_array_equal(img_g9, img_md)
