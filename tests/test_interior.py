"""Interior-distance skip field tests (render/interior.py)."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fluidsimulation.core.config import SimConfig
from fluidsimulation.core.state import init_state
from fluidsimulation.render import interior as intr
from fluidsimulation.render import raytrace as rt
from fluidsimulation.experiments import wavefront as wf
from fluidsimulation.render.camera import OrbitCamera
from fluidsimulation.solver.step3d import step_jit

CFG32 = SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)


@pytest.fixture(scope="module")
def phi32():
    state = init_state(CFG32)
    for _ in range(3):
        state = step_jit(state, 1.0 / 60.0, CFG32)
    return state.phi


def _brute_l1(phi):
    n = phi.shape
    bad = np.argwhere(phi >= 0.0)
    out = np.full(n, 1e6, np.float32)
    idx = np.indices(n).transpose(1, 2, 3, 0)
    for b in bad:
        d = np.abs(idx - b).sum(-1)
        out = np.minimum(out, d)
    return out


def test_l1_distance_matches_brute_force():
    rng = np.random.default_rng(0)
    phi = rng.normal(loc=-0.5, size=(9, 7, 11)).astype(np.float32)
    got = np.asarray(intr.l1_distance_to_nonneg(jnp.asarray(phi)))
    ref = _brute_l1(phi)
    np.testing.assert_array_equal(got, ref)


def test_corner_min8():
    rng = np.random.default_rng(1)
    d = rng.uniform(0, 10, size=(5, 6, 7)).astype(np.float32)
    got = np.asarray(intr.corner_min8(jnp.asarray(d)))
    ref = np.min(
        [d[dx:dx + 4, dy:dy + 5, dz:dz + 6]
         for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)],
        axis=0,
    )
    np.testing.assert_array_equal(got, ref)


@pytest.mark.slow  # round 5: the interior-skip march is a
# experiment path (PERF.md); its equality soaks
# move behind slow with it
def test_sample_phi_skip_matches_packed(phi32):
    """phi part of the skip texture == PackedPhi sample, compared inside
    ONE program (immune to cross-program fp-contraction drift)."""
    texs = intr.PackedPhiSkip(phi32)
    texp = rt.PackedPhi(phi32)
    rng = np.random.default_rng(2)
    pts = jnp.asarray(rng.uniform(-0.1, 1.1, (4096, 3)).astype(np.float32))

    @jax.jit
    def both(texs, texp, p):
        a, d8 = intr.sample_phi_skip(texs, p)
        b = rt.sample_phi_packed(texp, p)
        return a - b, d8

    diff, d8 = both(texs, texp, pts)
    assert float(jnp.abs(diff).max()) == 0.0
    assert np.isfinite(np.asarray(d8)).all()
    assert float(d8.min()) >= 0.0


@pytest.mark.slow  # round 5: see test_sample_phi_skip_matches_packed
def test_skip_march_bit_identical(phi32):
    """The SAME compiled pool with margin=+big (skip disabled) and the
    real margin must agree bit-for-bit on a power-of-two grid."""
    tex = intr.PackedPhiSkip(phi32)
    probe2 = lambda p: intr.probe_skip(tex, p)
    md = lambda p: probe2(p)[0]
    inv_m0 = 1.0 / jnp.float32(tex.dims[0])

    rng = np.random.default_rng(3)
    n = 600
    co = np.empty((n, 3), np.float32)
    co[: n // 2] = rng.uniform(-1.5, 1.5, (n // 2, 3))
    co[n // 2:] = rng.uniform(-0.45, 0.45, (n - n // 2, 3))
    co[n // 2:, 1] = rng.uniform(-0.49, -0.1, n - n // 2)
    ci = rng.normal(size=(n, 3)).astype(np.float32)
    ci /= np.linalg.norm(ci, axis=1, keepdims=True)
    co, ci = jnp.asarray(co), jnp.asarray(ci)
    half = jnp.array([0.5, 0.5, 0.5], jnp.float32)
    _, max_t, _, _ = rt.intersect_aabb(co, ci, -half, half)

    @jax.jit
    def run(margin):
        return wf.intersect_water_wf(
            md, inv_m0, co, ci, max_t, pool=256, spr=4,
            probe2=probe2, margin=margin,
        )

    p_off, t_off = run(jnp.float32(1e9))
    p_on, t_on = run(jnp.float32(intr._SKIP_MARGIN))
    np.testing.assert_array_equal(np.asarray(t_off), np.asarray(t_on))
    np.testing.assert_array_equal(np.asarray(p_off), np.asarray(p_on))

    # Same property on the texture (row-reuse) path: one program, the
    # margin toggles the skip, bit-identical outputs.
    @jax.jit
    def run_tex(margin):
        return wf.intersect_water_wf(
            tex, inv_m0, co, ci, max_t, pool=256, spr=3, reuse=4,
            margin=margin,
        )

    p_off, t_off = run_tex(jnp.float32(1e9))
    p_on, t_on = run_tex(jnp.float32(intr._SKIP_MARGIN))
    np.testing.assert_array_equal(np.asarray(t_off), np.asarray(t_on))
    np.testing.assert_array_equal(np.asarray(p_off), np.asarray(p_on))
    # and the skip actually fires for deep inside rays (fewer rounds is
    # not observable here, but identical output with a real margin is the
    # load-bearing property)


@pytest.mark.slow
def test_tiled_inside_march_skip_bit_identical(phi32):
    """The TILED renderer's inside forward march with the interior skip
    (intersect_water probe2/margin) is bit-identical to the plain march:
    margin toggles the skip within one compiled program, and the
    full-frame render with interior_skip=True equals the default."""
    tex = intr.PackedPhiSkip(phi32)
    texp = rt.PackedPhi(phi32)
    probe2 = lambda p: intr.probe_skip(tex, p)
    md = lambda p: rt.map_dist_packed(texp, p)
    inv_m0 = 1.0 / jnp.float32(tex.dims[0])

    rng = np.random.default_rng(4)
    n = 512
    co = np.empty((n, 3), np.float32)
    co[: n // 2] = rng.uniform(-1.5, 1.5, (n // 2, 3))
    co[n // 2:] = rng.uniform(-0.45, 0.45, (n - n // 2, 3))
    co[n // 2:, 1] = rng.uniform(-0.49, -0.1, n - n // 2)
    ci = rng.normal(size=(n, 3)).astype(np.float32)
    ci /= np.linalg.norm(ci, axis=1, keepdims=True)
    co, ci = jnp.asarray(co), jnp.asarray(ci)
    half = jnp.array([0.5, 0.5, 0.5], jnp.float32)
    _, max_t, _, _ = rt.intersect_aabb(co, ci, -half, half)

    @jax.jit
    def run(margin):
        return rt.intersect_water(md, inv_m0, co, ci, max_t,
                                  probe2=probe2, margin=margin)

    p_off, t_off = run(jnp.float32(1e9))
    p_on, t_on = run(jnp.float32(intr._SKIP_MARGIN))
    np.testing.assert_array_equal(np.asarray(t_off), np.asarray(t_on))
    np.testing.assert_array_equal(np.asarray(p_off), np.asarray(p_on))

    # And the no-probe2 default path agrees bit-for-bit with the
    # margin=+inf skip program (same decision points, exact t chain).
    @jax.jit
    def run_plain():
        return rt.intersect_water(md, inv_m0, co, ci, max_t)

    p_pl, t_pl = run_plain()
    np.testing.assert_array_equal(np.asarray(t_pl), np.asarray(t_off))
    np.testing.assert_array_equal(np.asarray(p_pl), np.asarray(p_off))

    cam = OrbitCamera()
    co_c, right, up, fwd = cam.frame(64, 48)
    # sphere_trace=False: interior_skip is mutually exclusive with the
    # (default-on since round 5) sphere-trace skip.
    a = np.asarray(rt.render_frame(phi32, co_c, right, up, fwd,
                                   width=64, height=48, band_rows=24,
                                   band_cols=32, sphere_trace=False))
    b = np.asarray(rt.render_frame(phi32, co_c, right, up, fwd,
                                   width=64, height=48, band_rows=24,
                                   band_cols=32, interior_skip=True,
                                   sphere_trace=False))
    np.testing.assert_array_equal(a, b)


@pytest.mark.slow
def test_render_wavefront_skip_matches_noskip(phi32):
    cam = OrbitCamera()
    co, right, up, fwd = cam.frame(64, 48)
    a = np.asarray(
        wf.render_wavefront(phi32, co, right, up, fwd, 64, 48,
                            pool=2048, skip=False)
    )
    b = np.asarray(
        wf.render_wavefront(phi32, co, right, up, fwd, 64, 48,
                            pool=2048, skip=True)
    )
    d = np.abs(a - b)
    # different programs -> contraction drift; semantics identical
    assert float((d > 1e-4).mean()) < 0.005, float(d.max())
    assert np.isfinite(b).all()
