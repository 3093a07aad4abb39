"""Wavefront renderer equality tests.

The pool-marched intersector replicates raytrace.intersect_water's
per-lane serial semantics op for op, but XLA's fused-multiply-add
contraction is PROGRAM-dependent (verified: the same `p0 + t*ci` update
compiles to fma in one program and mul+add in another), so cross-program
results can drift by ~1 ulp per march step.  Equality is therefore
asserted to 1e-6-level tolerances with a tiny allowance for rays whose
step-exit decision flips at a threshold (the reference's own CPU<->GPU
parity tolerance was ~1e-3, Simulation.cpp:569-576).  Within one
program the wavefront renderer is deterministic; its own golden frame is
exact (test_golden_frame_wavefront)."""

import numpy as np
import pytest

# Round 5: the wavefront renderer is a quarantined measured-dead
# experiment (fluidsimulation/experiments/); its whole equality
# suite runs in the slow tier.
pytestmark = pytest.mark.slow

import jax.numpy as jnp

from fluidsimulation.core.config import SimConfig
from fluidsimulation.core.state import init_state
from fluidsimulation.render import raytrace as rt
from fluidsimulation.experiments import wavefront as wf
from fluidsimulation.render.camera import OrbitCamera
from fluidsimulation.solver.step3d import step_jit

CFG = SimConfig(nx=24, ny=24, nz=24, cells_per_meter=24.0)


@pytest.fixture(scope="module")
def phi24():
    state = init_state(CFG)
    for _ in range(3):
        state = step_jit(state, 1.0 / 60.0, CFG)
    return state.phi


def _rays(n, seed, inside_frac=0.4):
    """Mixed ray batch: some from outside the box, some starting inside the
    water region (exercises the inside fwd+bwd marches and box exits)."""
    rng = np.random.default_rng(seed)
    n_in = int(n * inside_frac)
    co_out = rng.uniform(-1.6, 1.6, size=(n - n_in, 3)).astype(np.float32)
    co_out[:, 2] -= 1.5
    # Inside the lower half of the box, where the settled dam-break fluid is.
    co_in = rng.uniform(-0.45, 0.45, size=(n_in, 3)).astype(np.float32)
    co_in[:, 1] = rng.uniform(-0.49, -0.2, size=n_in)
    co = np.concatenate([co_out, co_in], axis=0)
    ci = rng.normal(size=(n, 3)).astype(np.float32)
    ci /= np.linalg.norm(ci, axis=1, keepdims=True)
    return jnp.asarray(co), jnp.asarray(ci)


def _maxt(co, ci):
    half = jnp.array([0.5, 0.5, 0.5], jnp.float32)
    _, max_t, _, _ = rt.intersect_aabb(co, ci, -half, half)
    return max_t


def _assert_close_mostly(a, b, atol, outlier_frac, outlier_max):
    """All-but-a-few elements within atol (fp-contraction drift); the few
    threshold-flip outliers bounded by outlier_max."""
    a, b = np.asarray(a), np.asarray(b)
    d = np.abs(a - b)
    frac = float((d > atol).mean())
    assert frac <= outlier_frac, (
        f"{frac:.4%} elements beyond atol={atol} (max {d.max():.3e})"
    )
    assert float(d.max()) <= outlier_max, f"outlier too large: {d.max():.3e}"


@pytest.mark.parametrize("pool", [64, 4096])
@pytest.mark.parametrize("mode", ["closure", "tex", "tex_reuse"])
def test_intersect_water_pool_bitwise(phi24, pool, mode):
    tex = rt.PackedPhi(phi24)
    md = lambda p: rt.map_dist_packed(tex, p)
    inv_m0 = 1.0 / jnp.float32(tex.dims[0])
    co, ci = _rays(777, seed=0)
    max_t = _maxt(co, ci)

    p_ref, t_ref = rt.intersect_water(md, inv_m0, co, ci, max_t)
    texq = md if mode == "closure" else tex
    reuse = 4 if mode == "tex_reuse" else 1
    p_wf, t_wf = wf.intersect_water_wf(
        texq, inv_m0, co, ci, max_t, pool=pool, spr=3, reuse=reuse
    )
    _assert_close_mostly(t_ref, t_wf, 1e-5, 0.002, 0.1)
    _assert_close_mostly(p_ref, p_wf, 1e-5, 0.002, 0.1)


def test_intersect_water_pool_dead_mask(phi24):
    tex = rt.PackedPhi(phi24)
    md = lambda p: rt.map_dist_packed(tex, p)
    inv_m0 = 1.0 / jnp.float32(tex.dims[0])
    co, ci = _rays(300, seed=1)
    max_t = _maxt(co, ci)
    rng = np.random.default_rng(2)
    w = jnp.asarray(
        np.where(rng.uniform(size=300) < 0.3, 0.0, 1.0).astype(np.float32)
    )

    p_ref, t_ref = rt.intersect_water(md, inv_m0, co, ci, max_t,
                                      dead=w <= 0.0)
    p_wf, t_wf = wf.intersect_water_wf(
        md, inv_m0, co, ci, max_t, dead=w <= 0.0, pool=128, spr=4
    )
    # Documented twin divergence (wavefront.py module docstring): a dead
    # lane whose box lies strictly behind the ray returns t=0 instead of
    # the dense path's min(0, max_t); unreachable from the product path
    # (TIR children have zero direction => |max_t| >= LARGE).  Pin it.
    behind = np.asarray((max_t < 0.0) & (w <= 0.0))
    np.testing.assert_array_equal(np.asarray(t_wf)[behind], 0.0)
    keep = ~behind
    _assert_close_mostly(np.asarray(t_ref)[keep], np.asarray(t_wf)[keep],
                         1e-5, 0.004, 0.1)
    _assert_close_mostly(np.asarray(p_ref)[keep], np.asarray(p_wf)[keep],
                         1e-5, 0.004, 0.1)


@pytest.mark.slow
def test_render_wavefront_matches_tiled(phi24):
    cam = OrbitCamera()
    co, right, up, fwd = cam.frame(80, 60)
    ref = np.asarray(
        rt.render(phi24, co, right, up, fwd, width=80, height=60,
                  band_rows=20, band_cols=20)
    )
    got = np.asarray(
        wf.render_wavefront(phi24, co, right, up, fwd, width=80, height=60,
                            pool=2048, spr=5)
    )
    # Exclude the reference's unset-primary-ray quirk pixels (glass hit
    # but every bounce TIR'd, prim_alpha == 0, Render.fx:341-344): both
    # paths render f32 garbage there (the reference displays GPU garbage),
    # and garbage amplifies 1-ulp cross-program drift chaotically.  They
    # are pinned deterministically by the wavefront's own golden instead.
    px = (jnp.arange(80, dtype=jnp.float32) + 0.5) / 80
    py = (jnp.arange(60, dtype=jnp.float32) + 0.5) / 60
    fx, fyy = jnp.meshgrid(px, py, indexing="xy")
    ci = rt._norm((-1 + 2 * fx)[..., None] * right
                  + (1 - 2 * fyy)[..., None] * up + fwd)
    h, _, _, alpha, _ = rt.trace_glass(jnp.broadcast_to(co, ci.shape), ci)
    quirk = np.asarray((h < rt.LARGE) & (alpha == 0.0))
    assert quirk.mean() < 0.1  # the quirk region stays rare
    keep = ~quirk
    # Image-level: per-pixel fp drift tiny; allow a few threshold-flip
    # pixels whose march exited one step apart (bounded brightness delta).
    _assert_close_mostly(ref[keep], got[keep], 2e-4, 0.001, 0.5)
    assert np.isfinite(got).all()
    assert got.std() > 0.01


@pytest.mark.slow
def test_render_wavefront_selfconsistent(phi24):
    """Same program, same inputs -> bitwise identical frames (the wavefront
    renderer is deterministic; its goldens are exact against itself)."""
    cam = OrbitCamera()
    co, right, up, fwd = cam.frame(64, 48)
    a = np.asarray(
        wf.render_wavefront(phi24, co, right, up, fwd, width=64, height=48)
    )
    b = np.asarray(
        wf.render_wavefront(phi24, co, right, up, fwd, width=64, height=48)
    )
    np.testing.assert_array_equal(a, b)
