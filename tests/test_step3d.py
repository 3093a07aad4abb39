"""End-to-end 3D step tests: stability, invariants, and behavioral parity
with the CPU (FluidSim3) oracle at small grid sizes."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fluidsimulation.core.config import SimConfig
from fluidsimulation.core.state import SimState, init_state
from fluidsimulation.reference.solver3d import FluidSim3Ref, divergence_stats
from fluidsimulation.solver.step3d import clamp_dt, pic_flip_alpha, step_jit

CFG = SimConfig(nx=16, ny=16, nz=16, cells_per_meter=16.0)


def test_dt_clamp():
    assert clamp_dt(CFG, 1.0) == pytest.approx(1.0 / 15.0)
    assert clamp_dt(CFG, 0.01) == pytest.approx(0.01)
    assert clamp_dt(CFG, -1.0) == 0.0
    assert clamp_dt(CFG, 0.05, simulation_rate=0.5) == pytest.approx(0.025)


def test_alpha_model():
    # alpha = 6*dt*nu*cpm^2 (Simulation.cpp:541); tiny for water viscosity.
    a = float(pic_flip_alpha(CFG, 1.0 / 60.0))
    assert a == pytest.approx(6 * (1 / 60) * CFG.nu * CFG.cells_per_meter**2, rel=1e-5)
    assert float(pic_flip_alpha(CFG, 1e9)) == 1.0


def test_step_runs_and_stays_finite():
    state = init_state(CFG)
    dt = 0.01
    for _ in range(10):
        state = step_jit(state, dt, CFG)
    for name in ("pos", "vel", "u", "v", "w", "phi"):
        arr = np.asarray(getattr(state, name))
        assert np.isfinite(arr).all(), name
    # Particles remain in the advection clamp box.
    pos = np.asarray(state.pos)
    m = np.array([CFG.nx, CFG.ny, CFG.nz], np.float32)
    assert (pos >= -0.4 / m - 1e-6).all() and (pos <= 1 - 0.6 / m + 1e-6).all()
    # Fluid has fallen: some downward velocity appeared at some point, and
    # the particle cloud's center of mass moved down vs the seeded state.
    assert np.asarray(state.pos)[:, 1].mean() < np.asarray(init_state(CFG).pos)[:, 1].mean()


def test_step_divergence_free():
    """Post-projection divergence invariant on the stepped state
    (PrintDivergence, Simulation3D.cpp:1095)."""
    state = init_state(CFG)
    state = step_jit(state, 0.01, CFG)
    # phi in the state is blurred (render-only); recompute the sharp phi used
    # by the projection via the level-set op to evaluate the invariant.
    from fluidsimulation.ops.levelset import compute_level_set

    phi, _ = compute_level_set(CFG, state.pos)
    l2, mx, _ = divergence_stats(
        CFG, np.asarray(state.u), np.asarray(state.v), np.asarray(state.w), np.asarray(phi)
    )
    assert mx < 5e-4, (l2, mx)


def test_step_matches_cpu_oracle_one_step():
    """One full step vs the FluidSim3 oracle from a noise-grid state.

    Documented divergences (SURVEY.md §3.4) bound the tolerance: level-set
    sweep style (GPU 24-sweep vs CPU 8 triple-sweeps) and extrapolation
    (one-ring vs full BFS) differ in the *air*; particle state lives in the
    fluid, where parity must be tight.
    """
    dt = 0.01
    ref = FluidSim3Ref(CFG, gpu_style_init=False)
    state = SimState(
        pos=ref.pos.copy(),
        vel=ref.vel.copy(),
        u=ref.u.copy(),
        v=ref.v.copy(),
        w=ref.w.copy(),
        phi=np.full(CFG.grid_shape(), np.inf, np.float32),
    )
    ref.simulate(dt)
    for fast in (False, True):
        out = step_jit(state, dt, CFG, fast=fast)

        np.testing.assert_allclose(np.asarray(out.pos), ref.pos, atol=2e-5)

        dv = np.abs(np.asarray(out.vel) - ref.vel)
        # Velocities at particles: the reference's own CPU<->GPU parity was
        # 2.5e-3 absolute after 100 SOR iterations (Simulation.cpp:899-900);
        # our f32-vs-f64 SOR plus extrapolation-style differences land in
        # the same regime.  Median tight, interface tail bounded.
        assert np.quantile(dv, 0.5) < 1e-3, (fast, np.quantile(dv, [0.5, 0.95, 1.0]))
        assert np.quantile(dv, 0.95) < 6e-3, fast
        assert dv.max() < 0.25, fast


def test_fast_slow_equivalence():
    """The fast path (packed interpolation + dense cell table)
    must agree with the direct gather/scatter path up to reassociation."""
    state = init_state(CFG)
    a = step_jit(state, 0.01, CFG, fast=True)
    b = step_jit(state, 0.01, CFG, fast=False)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos), atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.u), np.asarray(b.u), atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.v), np.asarray(b.v), atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.w), np.asarray(b.w), atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.phi), np.asarray(b.phi), atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel), atol=1e-4)


def test_jit_single_compilation_whole_step():
    """The whole timestep is one jit-compiled computation (SURVEY.md §7
    design stance: 'whole timestep fused under one jit')."""
    state = init_state(CFG)
    lowered = jax.jit(
        lambda s, dt: step_jit.__wrapped__(s, dt, CFG, True)
    ).lower(state, 0.01)
    assert lowered.compile() is not None


@pytest.mark.slow
def test_fast_slow_equivalence_supertable():
    """ppc_axis=1 routes the fast path through the supercell table
    (solver.step3d.use_super_table); it must agree with the direct path."""
    from fluidsimulation.solver.step3d import use_super_table

    cfg = SimConfig(nx=16, ny=16, nz=16, cells_per_meter=16.0,
                    particles_per_cell_axis=1)
    assert use_super_table(cfg)
    state = init_state(cfg)
    for _ in range(3):
        a = step_jit(state, 0.01, cfg, fast=True)
        b = step_jit(state, 0.01, cfg, fast=False)
        state = a
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos), atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.u), np.asarray(b.u), atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.v), np.asarray(b.v), atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.w), np.asarray(b.w), atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.phi), np.asarray(b.phi), atol=1e-4)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel), atol=1e-4)


def test_cached_advect_bit_identical():
    """The carried AdvectCache (FLIP fat-row k1 + packed tables of the final
    grids) must make NO numerical difference: stepping with it equals
    stepping a cache=None state bit-for-bit on every externalizable field,
    over several chained steps."""
    import dataclasses

    sc = init_state(CFG)              # cache present (zero cache)
    sn = dataclasses.replace(sc, cache=None)
    assert sc.cache is not None
    for _ in range(3):
        sc = step_jit(sc, 0.01, CFG, fast=True)
        sn = step_jit(sn, 0.01, CFG, fast=True)
    assert sc.cache is not None and sn.cache is None
    for k in ("pos", "vel", "u", "v", "w", "phi"):
        np.testing.assert_array_equal(
            np.asarray(getattr(sc, k)), np.asarray(getattr(sn, k)),
            err_msg=f"cache path diverged in {k}",
        )


def test_interp_packed_pair_bit_identical():
    """Fat-row pair interpolation == two separate packed interpolations."""
    from fluidsimulation.core.interp_packed import (
        interp_mac3_packed_pair_vec,
        interp_mac3_packed_vec,
        pack_mac3,
    )

    rng = np.random.default_rng(3)
    nx = ny = nz = 16
    ga = [rng.normal(size=s).astype(np.float32)
          for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))]
    gb = [rng.normal(size=s).astype(np.float32)
          for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))]
    q = rng.uniform(-0.2, 1.2, size=(500, 3)).astype(np.float32) * nx
    from fluidsimulation.core.interp_packed import (
        interp_mac3_packed_half_vec,
        pack_mac3_pair,
    )

    pa = pack_mac3(*ga)
    pb = pack_mac3(*gb)
    fat = tuple(jnp.concatenate([a, b], axis=1) for a, b in zip(pa, pb))
    fat2 = pack_mac3_pair(tuple(ga), tuple(gb))
    for f1, f2 in zip(fat, fat2):
        np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    va, vb = interp_mac3_packed_pair_vec(*fat, (nx, ny, nz), jnp.asarray(q))
    vh = interp_mac3_packed_half_vec(*fat, (nx, ny, nz), jnp.asarray(q), half=1)
    np.testing.assert_array_equal(np.asarray(vh), np.asarray(vb))
    wa = interp_mac3_packed_vec(*pa, (nx, ny, nz), jnp.asarray(q))
    wb = interp_mac3_packed_vec(*pb, (nx, ny, nz), jnp.asarray(q))
    np.testing.assert_array_equal(np.asarray(va), np.asarray(wa))
    np.testing.assert_array_equal(np.asarray(vb), np.asarray(wb))


def test_interp_packed_chunked_bit_identical(monkeypatch):
    """Giant-batch chunking (interp_packed._map_chunks, used for the 8M-
    particle ppc2 config where the unchunked fat gather exhausts device memory) must
    match the unchunked program to ~1 ulp (the lax.map body fma-contracts
    slightly differently), including the padded tail."""
    import fluidsimulation.core.interp_packed as ip

    rng = np.random.default_rng(7)
    nx = ny = nz = 16
    ga = [rng.normal(size=s).astype(np.float32)
          for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))]
    gb = [rng.normal(size=s).astype(np.float32)
          for s in ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))]
    # 2500 queries with chunk=1024 -> 3 chunks incl. a padded tail.
    q = jnp.asarray(
        rng.uniform(-0.2, 1.2, size=(2500, 3)).astype(np.float32) * nx)
    pa = ip.pack_mac3(*ga)
    fat = ip.pack_mac3_pair(tuple(ga), tuple(gb))

    ref_v = ip.interp_mac3_packed_vec(*pa, (nx, ny, nz), q)
    ref_a, ref_b = ip.interp_mac3_packed_pair_vec(*fat, (nx, ny, nz), q)
    ref_h = ip.interp_mac3_packed_half_vec(*fat, (nx, ny, nz), q, half=1)

    monkeypatch.setattr(ip, "_CHUNK", 1024)
    chk_v = ip.interp_mac3_packed_vec(*pa, (nx, ny, nz), q)
    chk_a, chk_b = ip.interp_mac3_packed_pair_vec(*fat, (nx, ny, nz), q)
    chk_h = ip.interp_mac3_packed_half_vec(*fat, (nx, ny, nz), q, half=1)

    for r, c in ((ref_v, chk_v), (ref_a, chk_a), (ref_b, chk_b),
                 (ref_h, chk_h)):
        np.testing.assert_allclose(np.asarray(r), np.asarray(c),
                                   rtol=0, atol=1e-6)
