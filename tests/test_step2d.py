"""2D solver tests: oracle self-consistency + JAX step parity/stability."""

import numpy as np

from fluidsimulation.core.config import SimConfig2D
from fluidsimulation.reference.solver2d import FluidSimRef, reset, vector_curl
from fluidsimulation.solver.step2d import (
    SimState2D,
    init_state2d,
    step2d_jit,
)

CFG = SimConfig2D(nx=16, ny=16, cells_per_meter=16.0)


def test_curl_field_is_divergence_free_continuum():
    """vectorCurl is (0.1*dN/dy, -0.1*dN/dx) of a potential — its analytic
    divergence is ~0 (up to the reference's finite-difference eps)."""
    h = 1e-3
    xs = np.linspace(0.1, 0.9, 7)
    for x in xs:
        for y in xs:
            ux1, _ = vector_curl(x + h, y)
            ux0, _ = vector_curl(x - h, y)
            _, vy1 = vector_curl(x, y + h)
            _, vy0 = vector_curl(x, y - h)
            div = (ux1 - ux0) / (2 * h) + (vy1 - vy0) / (2 * h)
            assert abs(div) < 0.5  # peaks' scale is O(10); fd eps dominates


def test_reset_deterministic():
    p1, v1, u1, vv1 = reset(CFG)
    p2, v2, u2, vv2 = reset(CFG)
    np.testing.assert_array_equal(p1, p2)
    np.testing.assert_array_equal(u1, u2)
    assert p1.shape == (CFG.num_particles, 2)


def test_oracle_runs_and_is_stable():
    ref = FluidSimRef(CFG)
    for _ in range(3):
        ref.simulate(0.01)
    assert np.isfinite(ref.pos).all() and np.isfinite(ref.vel).all()
    assert np.abs(ref.vel).max() < 100.0


def test_transfer2d_and_extrapolation_exact():
    """P2G + full BFS-equivalent extrapolation reproduces the 2D oracle's
    grids bit-for-bit (the iterated masked one-ring equals the reference's
    Manhattan-bucket BFS, Simulation2D.cpp:443-581)."""
    import jax.numpy as jnp

    from fluidsimulation.reference.solver2d import (
        advect,
        transfer_particles_to_grid,
    )
    from fluidsimulation.solver.step2d import extrapolate_full, transfer_to_grid

    ref = FluidSimRef(CFG)
    pos = advect(CFG, ref.u, ref.v, ref.pos, 0.01)
    u_r, v_r, _, _ = transfer_particles_to_grid(CFG, pos, ref.vel)
    u_j, v_j, uv, vv = transfer_to_grid(CFG, jnp.asarray(pos), jnp.asarray(ref.vel))
    it = CFG.nx + CFG.ny + 2
    np.testing.assert_allclose(np.asarray(extrapolate_full(u_j, uv, it)), u_r, atol=1e-6)
    np.testing.assert_allclose(np.asarray(extrapolate_full(v_j, vv, it)), v_r, atol=1e-6)


def test_step2d_matches_oracle():
    """End-to-end 2D step vs the FluidSim oracle.

    Positions and the transfer stage are exact (see the test above); the
    residual velocity difference comes from the level-set sweep style (the
    oracle's nested Zhao sweeps vs our axis-decomposed parallel sweeps,
    both upper bounds that differ by <0.1 cells at interface cells) feeding
    the ghost-fluid projection coefficients.  Observed: median 2.6e-2,
    p95 6.6e-2 on velocities of magnitude ~2-3 m/s (~2% relative)."""
    ref = FluidSimRef(CFG)
    state = SimState2D(
        pos=ref.pos.copy(), vel=ref.vel.copy(),
        u=ref.u.copy(), v=ref.v.copy(),
        phi=np.full((CFG.nx, CFG.ny), np.inf, np.float32),
    )
    ref.simulate(0.01)
    out = step2d_jit(state, 0.01, CFG)
    np.testing.assert_allclose(np.asarray(out.pos), ref.pos, atol=2e-5)
    scale = max(1.0, np.abs(ref.vel).max())
    dv = np.abs(np.asarray(out.vel) - ref.vel) / scale
    assert np.quantile(dv, 0.5) < 4e-2, np.quantile(dv, [0.5, 0.95, 1.0])
    assert np.quantile(dv, 0.95) < 1e-1
    assert dv.max() < 0.3


def test_step2d_multi_step_stable():
    state = init_state2d(CFG)
    for _ in range(10):
        state = step2d_jit(state, 0.01, CFG)
    for name in ("pos", "vel", "u", "v", "phi"):
        assert np.isfinite(np.asarray(getattr(state, name))).all(), name
    m = np.array([CFG.nx, CFG.ny], np.float32)
    pos = np.asarray(state.pos)
    assert (pos >= -0.4 / m - 1e-6).all() and (pos <= 1 - 0.6 / m + 1e-6).all()
