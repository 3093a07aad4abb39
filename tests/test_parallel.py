"""Multi-chip sharding: the sharded step must equal the single-device step
(run on the 8-virtual-CPU-device mesh from conftest)."""

import numpy as np
import pytest

import jax

from fluidsimulation.core.config import SimConfig
from fluidsimulation.core.state import init_state
from fluidsimulation.parallel.sharding import (
    make_mesh,
    make_sharded_step,
    shard_state,
    state_shardings,
)
from fluidsimulation.solver.step3d import step_jit

CFG = SimConfig(nx=16, ny=16, nz=16, cells_per_meter=16.0)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(jax.devices()[:8])


@pytest.mark.slow
def test_sharded_step_matches_single(mesh):
    state = init_state(CFG)
    want = step_jit(state, 0.01, CFG)
    sharded = shard_state(init_state(CFG), mesh)
    got = make_sharded_step(CFG, mesh)(sharded, 0.01)
    np.testing.assert_allclose(np.asarray(got.pos), np.asarray(want.pos), atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.vel), np.asarray(want.vel), atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(want.u), atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.phi), np.asarray(want.phi), atol=1e-4)


def test_output_shardings_preserved(mesh):
    sharded = shard_state(init_state(CFG), mesh)
    out = make_sharded_step(CFG, mesh)(sharded, 0.01)
    want = state_shardings(mesh)
    for name in ("pos", "vel", "u", "v", "w", "phi"):
        got_sh = getattr(out, name).sharding
        assert got_sh.is_equivalent_to(
            getattr(want, name), getattr(out, name).ndim
        ), name


@pytest.mark.slow
def test_halo_step_matches_single(mesh):
    """The explicit-collective shard_map step (x-sharded grids, ppermute
    halos, relay x-sweeps, particle slab exchange) == single-device step
    (SURVEY.md §5.8)."""
    from fluidsimulation.parallel.halo_step import make_halo_step, shard_state_x

    cfg = SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)
    want = init_state(cfg)
    for _ in range(2):
        want = step_jit(want, 0.01, cfg)

    got = shard_state_x(init_state(cfg), mesh)
    halo_step = make_halo_step(cfg, mesh)
    for _ in range(2):
        got = halo_step(got, 0.01)

    np.testing.assert_allclose(np.asarray(got.pos), np.asarray(want.pos), atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.vel), np.asarray(want.vel), atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(want.u), atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.v), np.asarray(want.v), atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.w), np.asarray(want.w), atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.phi), np.asarray(want.phi), atol=1e-4)


@pytest.mark.slow
def test_halo_step_drop_counter(mesh):
    """with_diagnostics=True reports particles lost to the static slab
    capacity: 0 at the default 4x capacity, >0 when the capacity is forced
    below the dam break's initial 2x x-concentration (the dam occupies
    half the x extent, so early shards hold ~2x the average)."""
    from fluidsimulation.parallel.halo_step import make_halo_step, shard_state_x

    cfg = SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)
    state = shard_state_x(init_state(cfg), mesh)

    ok_step = make_halo_step(cfg, mesh, with_diagnostics=True)
    out, dropped = ok_step(state, 0.01)
    assert int(dropped) == 0
    np.testing.assert_allclose(
        np.asarray(out.pos),
        np.asarray(make_halo_step(cfg, mesh)(state, 0.01).pos),
        atol=0,
    )

    n = cfg.num_particles
    tight = ((n // 8) + 127) // 128 * 128  # 1x average < the 2x dam peak
    _, dropped = make_halo_step(
        cfg, mesh, capacity=tight, with_diagnostics=True
    )(state, 0.01)
    assert int(dropped) > 0


def test_shard_map_halo_sor_matches_single(mesh):
    """Explicit ppermute-halo SOR == single-device SOR (SURVEY.md §5.8)."""
    import jax.numpy as jnp

    from fluidsimulation.ops import levelset, project
    from fluidsimulation.parallel.halo import sor_pressure_sharded

    state = step_jit(init_state(CFG), 0.01, CFG)
    phi, _ = levelset.compute_level_set(CFG, state.pos)
    diag = project.compute_diag(CFG, phi)
    b = project.compute_rhs(CFG, state.u, state.v, state.w, jnp.float32(0.01))
    want = project.sor_pressure(CFG, phi, diag, b)
    got = sor_pressure_sharded(CFG, mesh, phi, diag, b)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)


@pytest.mark.slow
def test_sharded_apic_step_matches_single(mesh):
    """The APIC extension family also runs GSPMD-sharded (fast=False: the
    table fast path's windowed build is single-chip; the oracle transfer
    partitions cleanly)."""
    from fluidsimulation.parallel.sharding import (
        make_sharded_apic_step,
        shard_apic_state,
    )
    from fluidsimulation.solver.apic import init_apic_state, step_apic_jit

    state = init_apic_state(CFG)
    want = step_apic_jit(state, 0.01, CFG, fast=False)
    sharded = shard_apic_state(init_apic_state(CFG), mesh)
    got = make_sharded_apic_step(CFG, mesh, fast=False)(sharded, 0.01)
    np.testing.assert_allclose(np.asarray(got.pos), np.asarray(want.pos),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.vel), np.asarray(want.vel),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.C), np.asarray(want.C),
                               atol=0.05)
    fin = np.isfinite(np.asarray(want.phi))
    np.testing.assert_allclose(np.asarray(got.phi)[fin],
                               np.asarray(want.phi)[fin], atol=1e-4)


def test_halo_step_collective_budget(mesh):
    """Pin the engineered halo step's LOWERED-StableHLO collective counts
    at 32^3/D=8 (fast tier, round 5): the step emits its collectives
    explicitly via shard_map, so they are pinnable before XLA compile
    (7 s vs 42 s on this mesh) — a refactor that silently falls back to
    GSPMD auto-partitioning loses them from the lowered text entirely and
    fails here.  The compiled-text budget of record (docs/PARALLEL.md:
    84 permute / 14 AG / 20 a2a vs GSPMD's 447 / 56+ / 347) is pinned in
    the slow companion below."""
    from fluidsimulation.parallel.halo_step import (
        make_halo_step,
        shard_state_x,
    )
    from fluidsimulation.parallel.hlo import lowered_collectives

    cfg = SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)
    state = shard_state_x(init_state(cfg), mesh)
    counts = lowered_collectives(make_halo_step(cfg, mesh), state, 0.01)
    assert counts == {
        "collective-permute": 81,
        "all-gather": 14,
        "all-reduce": 0,
        "all-to-all": 0,
        "reduce-scatter": 0,
    }, counts


def test_halo_apic_collective_budget(mesh):
    """Pin the APIC halo step's LOWERED-StableHLO collective counts at
    32^3/D=8 (fast tier, round 5; see test_halo_step_collective_budget) —
    same skeleton as the FLIP halo step (81 lowered permutes, 0
    all-reduces), 12 all-gathers (slab exchange carries pos/vel/C; the
    mac9 G2P pack is per-shard so it adds no gathers beyond the projected
    full grids).  Compiled-text pin in the slow companion below."""
    from fluidsimulation.parallel.halo_apic import (
        make_halo_apic_step,
        shard_apic_state_x,
    )
    from fluidsimulation.parallel.hlo import lowered_collectives
    from fluidsimulation.solver.apic import init_apic_state

    cfg = SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)
    state = shard_apic_state_x(init_apic_state(cfg), mesh)
    counts = lowered_collectives(make_halo_apic_step(cfg, mesh), state, 0.01)
    assert counts == {
        "collective-permute": 81,
        "all-gather": 12,
        "all-reduce": 0,
        "all-to-all": 0,
        "reduce-scatter": 0,
    }, counts


@pytest.mark.slow
def test_halo_step_compiled_collective_budget(mesh):
    """The compiled-HLO budget of record for the FLIP halo step
    (docs/PARALLEL.md).  Exact-pinned on this image's
    jax; if a jax upgrade shifts counts benignly, re-baseline against
    scripts/diag_mesh_work.py."""
    from fluidsimulation.parallel.halo_step import (
        make_halo_step,
        shard_state_x,
    )
    from fluidsimulation.parallel.hlo import compiled_collectives

    cfg = SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)
    state = shard_state_x(init_state(cfg), mesh)
    counts = compiled_collectives(make_halo_step(cfg, mesh), state, 0.01)
    assert counts == {
        "collective-permute": 84,
        "all-gather": 14,
        "all-reduce": 0,
        "all-to-all": 20,
        "reduce-scatter": 0,
    }, counts


@pytest.mark.slow
def test_halo_apic_compiled_collective_budget(mesh):
    """The compiled-HLO budget of record for the APIC halo step (same
    skeleton as FLIP: 84 permutes, 0 all-reduces; 12 all-gathers)."""
    from fluidsimulation.parallel.halo_apic import (
        make_halo_apic_step,
        shard_apic_state_x,
    )
    from fluidsimulation.parallel.hlo import compiled_collectives
    from fluidsimulation.solver.apic import init_apic_state

    cfg = SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)
    state = shard_apic_state_x(init_apic_state(cfg), mesh)
    counts = compiled_collectives(make_halo_apic_step(cfg, mesh), state, 0.01)
    assert counts == {
        "collective-permute": 84,
        "all-gather": 12,
        "all-reduce": 0,
        "all-to-all": 20,
        "reduce-scatter": 0,
    }, counts


@pytest.mark.slow
def test_halo_apic_step_matches_single(mesh):
    """(slow tier since round 5 — ~2-3 min on the 8-device CPU mesh; the
    fast tier keeps test_halo_apic_collective_budget + the dryrun as its
    signal.)  The engineered APIC halo step (2-cell x halos for the quadratic
    windows, slab exchange carrying C, fused local-frame P2G) == the
    single-device APIC fast step to fp-reassociation tolerance."""
    from fluidsimulation.parallel.halo_apic import (
        make_halo_apic_step,
        shard_apic_state_x,
    )
    from fluidsimulation.solver.apic import init_apic_state, step_apic_jit

    cfg = SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)
    want = init_apic_state(cfg)
    for _ in range(2):
        want = step_apic_jit(want, 0.01, cfg)

    got = shard_apic_state_x(init_apic_state(cfg), mesh)
    halo_step = make_halo_apic_step(cfg, mesh)
    for _ in range(2):
        got = halo_step(got, 0.01)

    # Measured after the capacity fix (scripts/diag_halo_apic.py): step 1
    # is EXACT, step 2 within fp reassociation (pos 0, vel 6e-8, C 3.6e-6,
    # grids 2.2e-7) — tolerances carry ~30x headroom over that.
    np.testing.assert_allclose(np.asarray(got.pos), np.asarray(want.pos),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(got.vel), np.asarray(want.vel),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.C), np.asarray(want.C),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(got.u), np.asarray(want.u),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.v), np.asarray(want.v),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.w), np.asarray(want.w),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(got.phi), np.asarray(want.phi),
                               atol=1e-5)


@pytest.mark.slow
def test_halo_apic_drop_counter(mesh):
    """(slow tier since round 5 — the heaviest test in the suite: forced
    tight-capacity recompiles.)  with_diagnostics reports slab-capacity
    drops (0 at the default)."""
    from fluidsimulation.parallel.halo_apic import (
        make_halo_apic_step,
        shard_apic_state_x,
    )
    from fluidsimulation.solver.apic import init_apic_state

    cfg = SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)
    state = shard_apic_state_x(init_apic_state(cfg), mesh)
    out, dropped = make_halo_apic_step(cfg, mesh, with_diagnostics=True)(
        state, 0.01
    )
    assert int(dropped) == 0
    assert bool(np.isfinite(np.asarray(out.C)).all())

    # Forcing an undersized capacity must be REPORTED, not silent: the
    # fullest extended frame holds 8 fluid cells x 30 x 30 x 8 ppc = 57600
    # particles at this config (the 4x-uniform-share default without the
    # slabx+4 window scaling was 54016 — the round-4 silent-drop bug).
    _, dropped = make_halo_apic_step(cfg, mesh, capacity=50048,
                                     with_diagnostics=True)(state, 0.01)
    assert int(dropped) == 57600 - 50048
