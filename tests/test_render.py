"""Renderer tests: component checks + an end-to-end frame smoke test."""

import numpy as np
import pytest

import jax.numpy as jnp

from fluidsimulation.core.config import SimConfig
from fluidsimulation.core.state import init_state
from fluidsimulation.render import raytrace as rt
from fluidsimulation.render.camera import OrbitCamera
from fluidsimulation.solver.step3d import step_jit

CFG = SimConfig(nx=16, ny=16, nz=16, cells_per_meter=16.0)


def test_sample_phi_matches_manual_trilerp():
    rng = np.random.default_rng(0)
    phi = rng.normal(size=(8, 8, 8)).astype(np.float32)
    # At texel centers the sample equals the texel value.
    for idx in [(0, 0, 0), (3, 4, 5), (7, 7, 7)]:
        p = (np.array(idx, np.float32) + 0.5) / 8.0
        got = float(rt.sample_phi(jnp.asarray(phi), jnp.asarray(p)))
        assert abs(got - phi[idx]) < 1e-6
    # Midway between two texels along x: mean of the two.
    p = np.array([(1.0 + 0.5 + 0.5) / 8.0, 0.5 / 8, 0.5 / 8], np.float32)
    got = float(rt.sample_phi(jnp.asarray(phi), jnp.asarray(p)))
    assert abs(got - 0.5 * (phi[1, 0, 0] + phi[2, 0, 0])) < 1e-6


def test_packed_phi_matches_sample_phi():
    rng = np.random.default_rng(2)
    phi = rng.normal(size=(16, 16, 16)).astype(np.float32)
    pts = rng.uniform(-0.2, 1.2, size=(4096, 3)).astype(np.float32)
    tex = rt.PackedPhi(jnp.asarray(phi))
    a = np.asarray(rt.sample_phi(jnp.asarray(phi), jnp.asarray(pts)))
    b = np.asarray(rt.sample_phi_packed(tex, jnp.asarray(pts)))
    np.testing.assert_allclose(a, b, atol=3e-6)
    c = np.asarray(rt.map_dist(jnp.asarray(phi), jnp.asarray(pts)))
    d = np.asarray(rt.map_dist_packed(tex, jnp.asarray(pts)))
    np.testing.assert_allclose(c, d, atol=3e-6)


def test_packed_phi_dtype_rows():
    """bf16/f16 row storage: values round once at pack time, sampling runs
    in f32 — error bounded by one storage rounding of phi (not used by the
    frame path; the plumbing stays supported)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    phi = rng.normal(size=(16, 16, 16)).astype(np.float32)
    pts = rng.uniform(0.05, 0.95, size=(1024, 3)).astype(np.float32)
    base = np.asarray(
        rt.sample_phi_packed(rt.PackedPhi(jnp.asarray(phi)), jnp.asarray(pts))
    )
    for dt, rel in [(jnp.bfloat16, 2.0 ** -8), (jnp.float16, 2.0 ** -11)]:
        tex = rt.PackedPhi(jnp.asarray(phi), dtype=dt)
        assert tex.rows.dtype == dt
        got = np.asarray(rt.sample_phi_packed(tex, jnp.asarray(pts)))
        assert np.abs(got - base).max() < 4.0 * rel * np.abs(phi).max()
    if rt.gradient_fits_phi9(phi.shape):
        g_base = np.asarray(
            rt.compute_gradient9(rt.PackedPhi9(jnp.asarray(phi)),
                                 jnp.asarray(pts))
        )
        g9 = rt.PackedPhi9(jnp.asarray(phi), dtype=jnp.bfloat16)
        assert g9.rows.dtype == jnp.bfloat16
        g_got = np.asarray(rt.compute_gradient9(g9, jnp.asarray(pts)))
        assert np.isfinite(g_got).all()
        # Gradients are central differences of O(1) phi over one cell:
        # one bf16 rounding of each tap => absolute error ~ n * 2^-8.
        assert np.abs(g_got - g_base).max() < 16 * 4.0 * 2.0 ** -8


def test_intersect_aabb():
    co = jnp.array([[0.0, 0.0, -3.0]])
    ci = jnp.array([[0.0, 0.0, 1.0]])
    lo = jnp.array([-0.5, -0.5, -0.5])
    hi = jnp.array([0.5, 0.5, 0.5])
    tm, tM, n1, n2 = rt.intersect_aabb(co, ci, lo, hi)
    assert abs(float(tm[0]) - 2.5) < 1e-5
    assert abs(float(tM[0]) - 3.5) < 1e-5
    np.testing.assert_allclose(np.asarray(n1[0]), [0, 0, -1], atol=1e-5)
    # Miss
    co2 = jnp.array([[5.0, 5.0, -3.0]])
    tm2, *_ = rt.intersect_aabb(co2, ci, lo, hi)
    assert float(tm2[0]) >= rt.LARGE


def test_fresnel_energy_and_tir():
    ci = jnp.array([[0.0, -1.0, 0.0]])
    n = jnp.array([[0.0, 1.0, 0.0]])
    f, refl, trans = rt.fresnel_tr(ci, n, 1.0, 1.333)
    # Normal incidence Schlick: ((n2-n1)/(n2+n1))^2
    assert abs(float(f[0]) - ((0.333 / 2.333) ** 2)) < 1e-6
    np.testing.assert_allclose(np.asarray(refl[0]), [0, 1, 0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(trans[0]), [0, -1, 0], atol=1e-6)
    # TIR: grazing from dense to light.
    ci2 = jnp.array([[0.999, -0.04, 0.0]])
    ci2 = ci2 / jnp.linalg.norm(ci2)
    f2, _, t2 = rt.fresnel_tr(ci2, n, 1.333, 1.0)
    assert float(f2[0]) == 1.0
    np.testing.assert_allclose(np.asarray(t2[0]), [0, 0, 0], atol=1e-6)


def test_environment_finite_and_positive():
    rng = np.random.default_rng(1)
    d = rng.normal(size=(128, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    col = np.asarray(rt.sample_environment(jnp.asarray(d)))
    assert np.isfinite(col).all()
    assert (col >= 0).all()


def test_render_frame_smoke():
    """End-to-end: step the dam break once, render a small frame
    (BASELINE.json config 5)."""
    state = init_state(CFG)
    state = step_jit(state, 0.01, CFG)
    cam = OrbitCamera()
    co, right, up, fwd = cam.frame(80, 60)
    img = np.asarray(
        rt.render(state.phi, co, right, up, fwd, width=80, height=60)
    )
    assert img.shape == (60, 80, 3)
    assert np.isfinite(img).all()
    assert img.max() > 0.01  # something visible
    # Sky pixels at the top should dominate the glass region brightness-wise;
    # just require spatial variation (not a constant field).
    assert img.std() > 0.01


def test_sphere_trace_mode_matches_exact():
    """Sphere-trace skip (deepened march texture; the render_frame/demo
    DEFAULT): the default margin's
    skips are certificate-grade (L1/sqrt3 interior distance folded into
    deep nodes, interior.deepen_phi), so the image stays bit-identical to
    the plain march on this scene.  The scale=0 degenerate-skip identity
    is a third render compile and lives in the slow companion below."""
    cfg = SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)
    state = init_state(cfg)
    for _ in range(3):
        state = step_jit(state, 1.0 / 120.0, cfg)
    co, right, up, fwd = OrbitCamera().frame(80, 60)

    base = np.asarray(
        rt.render(state.phi, co, right, up, fwd, 80, 60,
                  band_rows=30, band_cols=40)
    )
    on = np.asarray(
        rt.render(state.phi, co, right, up, fwd, 80, 60,
                  band_rows=30, band_cols=40, sphere_trace=True)
    )
    np.testing.assert_array_equal(base, on)


@pytest.mark.slow
def test_sphere_trace_scale0_matches_exact():
    """scale=0 runs the deepened texture + skip program with zero-width
    skips — bit-for-bit the exact march (the degenerate end of the
    sphere-trace certification chain)."""
    cfg = SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)
    state = init_state(cfg)
    for _ in range(3):
        state = step_jit(state, 1.0 / 120.0, cfg)
    co, right, up, fwd = OrbitCamera().frame(80, 60)

    base = np.asarray(
        rt.render(state.phi, co, right, up, fwd, 80, 60,
                  band_rows=30, band_cols=40)
    )
    off = np.asarray(
        rt.render(state.phi, co, right, up, fwd, 80, 60,
                  band_rows=30, band_cols=40,
                  sphere_trace=True, sphere_scale=0.0)
    )
    np.testing.assert_array_equal(base, off)


def test_overstep_omega1_matches_exact():
    """Enhanced sphere tracing on the outside march: omega=1.0
    degenerates the certification chain to the plain march — bit-identical
    image; the loop-level check and the omega=1.6 bound live in the slow
    companion below (fast-tier split)."""
    cfg = SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)
    state = init_state(cfg)
    for _ in range(3):
        state = step_jit(state, 1.0 / 120.0, cfg)
    co, right, up, fwd = OrbitCamera().frame(80, 60)

    base = np.asarray(
        rt.render(state.phi, co, right, up, fwd, 80, 60,
                  band_rows=30, band_cols=40)
    )
    # render() maps overstep<=1.0 to the plain march (mode off).
    off = np.asarray(
        rt.render(state.phi, co, right, up, fwd, 80, 60,
                  band_rows=30, band_cols=40, overstep=1.0)
    )
    np.testing.assert_array_equal(base, off)


@pytest.mark.slow
def test_overstep_loop_and_bound():
    """Drive the CERTIFIED-OVERSTEP LOOP ITSELF at omega=1.0 through
    shade() (render can't reach it at 1.0 by design), and bound the
    omega=1.6 fast mode (the recorded pixel-diff bounds live in
    docs/PARITY.md)."""
    cfg = SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)
    state = init_state(cfg)
    for _ in range(3):
        state = step_jit(state, 1.0 / 120.0, cfg)
    co, right, up, fwd = OrbitCamera().frame(80, 60)
    base = np.asarray(
        rt.render(state.phi, co, right, up, fwd, 80, 60,
                  band_rows=30, band_cols=40)
    )

    import jax.numpy as jnp

    tex = rt.PackedPhi(state.phi)
    g9 = (rt.PackedPhi9(state.phi)
          if rt.gradient_fits_phi9(state.phi.shape) else None)
    px = (np.arange(80, dtype=np.float32) + 0.5) / 80
    py = (np.arange(60, dtype=np.float32) + 0.5) / 60
    fx, fy = np.meshgrid(px, py, indexing="xy")
    ci = rt._norm(jnp.asarray(-1 + 2 * fx)[..., None] * right
                  + jnp.asarray(1 - 2 * fy)[..., None] * up + fwd)
    co_b = jnp.broadcast_to(co, ci.shape)
    plain = np.asarray(rt.shade(tex, co_b, ci, g9=g9))
    loop1 = np.asarray(
        rt.shade(tex, co_b, ci, g9=g9, overstep=jnp.float32(1.0))
    )
    np.testing.assert_array_equal(plain, loop1)

    fast = np.asarray(
        rt.render(state.phi, co, right, up, fwd, 80, 60,
                  band_rows=30, band_cols=40, overstep=1.6)
    )
    assert np.isfinite(fast).all()
    d = np.abs(fast - base)
    # Certified hits only: differences are tolerance-level surface-t
    # rounding on a small fraction of (grazing) pixels.
    assert (d.max(-1) > 1 / 255).mean() < 0.05
    assert d.mean() < 5e-3


def test_temporal_seed_huge_backoff_bitwise():
    """Temporal frame coherence, fast-tier contract: a seed_back >= the grid diameter reproduces the cold march
    BIT-FOR-BIT (the seeded start degenerates to t=0).  The backoff-bound
    and cross-step contracts live in the slow companion below (two render
    compiles here vs six there — fast-tier runtime)."""
    cfg = SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)
    state = init_state(cfg)
    for _ in range(4):
        state = step_jit(state, 0.01, cfg)
    co, right, up, fwd = OrbitCamera().frame(80, 60)

    cold, t0 = rt.render(state.phi, co, right, up, fwd, 80, 60,
                         band_rows=30, band_cols=40, return_t=True)
    cold, t0 = np.asarray(cold), np.asarray(t0)
    assert t0.shape == (3, 60, 80) and np.isfinite(t0).all()

    huge = np.asarray(
        rt.render(state.phi, co, right, up, fwd, 80, 60,
                  band_rows=30, band_cols=40, t_seed=t0, seed_back=1000.0)
    )
    np.testing.assert_array_equal(cold, huge)


@pytest.mark.slow
def test_temporal_seed():
    """Temporal frame coherence, full contract: (b) re-rendering the SAME
    scene with the default backoff stays within a tight pixel bound; (c)
    across real sim steps the divergence stays small and bounded (the
    recorded bound lives in docs/PARITY.md); plus the untiled and
    bounces=1 plumbing.  The bit-for-bit huge-backoff contract (a) stays
    in the fast tier above."""
    cfg = SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)
    state = init_state(cfg)
    for _ in range(4):
        state = step_jit(state, 0.01, cfg)
    co, right, up, fwd = OrbitCamera().frame(80, 60)

    cold, t0 = rt.render(state.phi, co, right, up, fwd, 80, 60,
                         band_rows=30, band_cols=40, return_t=True)
    cold, t0 = np.asarray(cold), np.asarray(t0)

    # (b) static scene, default backoff: tiny divergence.
    warm = np.asarray(
        rt.render(state.phi, co, right, up, fwd, 80, 60,
                  band_rows=30, band_cols=40, t_seed=t0)
    )
    d = np.abs(warm - cold)
    assert (d.max(-1) > 1 / 255).mean() < 0.01

    # (c) two sim steps later, seeded from the old frame: bounded.
    for _ in range(2):
        state = step_jit(state, 0.01, cfg)
    cold2 = np.asarray(
        rt.render(state.phi, co, right, up, fwd, 80, 60,
                  band_rows=30, band_cols=40)
    )
    warm2 = np.asarray(
        rt.render(state.phi, co, right, up, fwd, 80, 60,
                  band_rows=30, band_cols=40, t_seed=t0)
    )
    d2 = np.abs(warm2 - cold2)
    assert np.isfinite(warm2).all()
    assert (d2.max(-1) > 1 / 255).mean() < 0.05
    # Whole-frame (untiled) path carries the same plumbing.
    img, t = rt.render(state.phi, co, right, up, fwd, 80, 60,
                       t_seed=None, return_t=True)
    assert np.asarray(t).shape == (3, 60, 80)
    # bounces=1: child slots carry LARGE.
    img1, tb1 = rt.render(state.phi, co, right, up, fwd, 80, 60,
                          bounces=1, return_t=True)
    tb1 = np.asarray(tb1)
    assert tb1.shape == (3, 60, 80)
    assert (tb1[1:] >= rt.LARGE).all()


def test_escaped_bounce_child_is_miss():
    """Children whose epsilon step escapes the box (max_t <= 0) forward as
    misses (the reference short-circuits misses to traceWater0); marching
    them would read CLAMPED out-of-box samples whose first value leaks
    into t (round-4 fix; the deepened sphere-trace texture exposed it)."""
    # A ray starting above the open top moving up: box strictly behind.
    co = jnp.array([[0.0, 0.6, 0.0]], jnp.float32)
    ci = jnp.array([[0.0, 1.0, 0.0]], jnp.float32)
    phi = jnp.full((16, 16, 16), -0.7, jnp.float32)  # all-fluid: clamped
    tex = rt.PackedPhi(phi)                          # samples are negative
    md = lambda p: rt.map_dist_packed(tex, p)
    ip, d_a, w_a, d_b, w_b = rt._expand_bounce(md, 1.0 / 16.0, co, ci)
    assert float(w_a[0]) == 1.0 and float(w_b[0]) == 0.0  # miss weights
    np.testing.assert_allclose(np.asarray(d_a[0]), [0, 1, 0], atol=0)


def test_coarse_seed_contract():
    """Same-frame coarse seeding: a 1/k-res pre-pass seeds the
    full-res marches with fresh ts (render/raytrace.py coarse_seed).
    Contract: (a) seed_back >= the grid diameter reproduces the cold
    march BIT-FOR-BIT (seeded starts degenerate to t=0 — the pre-pass
    then provably cannot change the image); (b) at the default backoff
    the pixel drift stays within the seeded-re-refinement class
    (sub-percent on this scene; recorded bounds in docs/PARITY.md)."""
    cfg = SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)
    state = init_state(cfg)
    for _ in range(4):
        state = step_jit(state, 0.01, cfg)
    co, right, up, fwd = OrbitCamera().frame(80, 60)

    cold = np.asarray(
        rt.render(state.phi, co, right, up, fwd, 80, 60,
                  band_rows=30, band_cols=40)
    )
    huge = np.asarray(
        rt.render(state.phi, co, right, up, fwd, 80, 60,
                  band_rows=30, band_cols=40, coarse_seed=4,
                  seed_back=1000.0)
    )
    np.testing.assert_array_equal(cold, huge)

    warm = np.asarray(
        rt.render(state.phi, co, right, up, fwd, 80, 60,
                  band_rows=30, band_cols=40, coarse_seed=4)
    )
    d = np.abs(warm - cold)
    assert (d.max(axis=-1) > 1 / 255).mean() < 0.03, d.max()
