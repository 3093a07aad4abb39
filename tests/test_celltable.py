"""Dense cell-table tests: build correctness, seeding and P2G parity with
the direct formulations, and overflow handling."""

import numpy as np

import jax.numpy as jnp

from fluidsimulation.core.config import SimConfig
from fluidsimulation.core.seeding import dam_break_particles, noise_grids
from fluidsimulation.ops import celltable as ct
from fluidsimulation.ops import levelset as ls
from fluidsimulation.ops import p2g
from fluidsimulation.reference import solver3d

CFG = SimConfig(nx=16, ny=16, nz=16, cells_per_meter=16.0)


def _seeded():
    pos, _ = dam_break_particles(CFG)
    u, v, w = noise_grids(CFG, seed=7)
    m = np.array([CFG.nx, CFG.ny, CFG.nz], np.float32)
    vel = np.stack(
        solver3d.interp_mac(u, v, w, m[0] * pos[:, 0], m[1] * pos[:, 1], m[2] * pos[:, 2]),
        axis=-1,
    ).astype(np.float32)
    return jnp.asarray(pos), jnp.asarray(vel)


def test_table_build_counts():
    pos, vel = _seeded()
    table = ct.build_cell_table(CFG, pos, vel)
    counts = np.asarray(ct.counts_from_table(CFG, table, pos))
    assert int(table.n_overflow) == 0
    # Dam break seeds 8 particles per interior right-half cell.
    m = np.array([CFG.nx, CFG.ny, CFG.nz], np.float32)
    cell = np.floor(np.asarray(pos) * m + 0.5).astype(np.int64)
    want = np.zeros(CFG.grid_shape(), np.int64)
    np.add.at(want, tuple(cell.T), 1)
    np.testing.assert_array_equal(counts, want)
    assert counts.sum() == CFG.num_particles


def test_table_slot_order_is_original_index_order():
    pos, vel = _seeded()
    table = ct.build_cell_table(CFG, pos, vel)
    slots = np.asarray(table.slots)
    m = np.array([CFG.nx, CFG.ny, CFG.nz], np.float32)
    pc = np.asarray(pos) * m
    cell = np.floor(pc + 0.5).astype(np.int64)
    # For a couple of cells, slot order must equal ascending particle index.
    # Layout: (nx, ny, K, 8, nz).
    for target in [tuple(cell[0]), tuple(cell[123])]:
        members = np.nonzero((cell == np.array(target)).all(axis=1))[0]
        k = len(members)
        x, y, z = target
        got = slots[x, y, :k, 0:3, z]
        np.testing.assert_allclose(got, pc[members], atol=1e-5)


def test_seed_from_table_matches_direct():
    pos, vel = _seeded()
    table = ct.build_cell_table(CFG, pos, vel)
    phi0, cpos0 = ct.seed_closest_from_table(CFG, table, ls.FAR)
    phi0, cpos0 = ct.seed_overflow_correction(CFG, table, pos, phi0, cpos0)
    phi_t, cpos_t = ls.neighborhood_pass(CFG, cpos0)
    phi_d, cpos_d = ls.seed_closest(CFG, pos)
    np.testing.assert_allclose(np.asarray(phi_t), np.asarray(phi_d), atol=1e-5)
    np.testing.assert_allclose(np.asarray(cpos_t), np.asarray(cpos_d), atol=1e-5)


def test_p2g_from_table_matches_direct():
    pos, vel = _seeded()
    table = ct.build_cell_table(CFG, pos, vel)
    got = ct.p2g_from_table(CFG, table, pos, vel)
    want = p2g.transfer_to_grid(CFG, pos, vel)
    for i in range(3):
        valid = np.asarray(want[3 + i])
        np.testing.assert_array_equal(np.asarray(got[3 + i]), valid)
        np.testing.assert_allclose(
            np.asarray(got[i])[valid], np.asarray(want[i])[valid],
            rtol=2e-4, atol=2e-4,
        )


def test_overflow_exactness():
    """Cram more particles into one cell than K slots: the bounded overflow
    corrections must keep seeding and P2G exact."""
    pos, vel = _seeded()
    K = ct.default_k(CFG)
    # Move the first 2K particles into the cell (8, 8, 8)'s neighborhood.
    n_extra = 2 * K + 3
    rng = np.random.default_rng(0)
    p = np.asarray(pos).copy()
    v = np.asarray(vel).copy()
    p[:n_extra] = (8.0 + rng.uniform(-0.45, 0.45, size=(n_extra, 3))) / 16.0
    p = jnp.asarray(p)
    v = jnp.asarray(v)

    table = ct.build_cell_table(CFG, p, v)
    assert int(table.n_overflow) > 0

    phi0, cpos0 = ct.seed_closest_from_table(CFG, table, ls.FAR)
    phi0, cpos0 = ct.seed_overflow_correction(CFG, table, p, phi0, cpos0)
    phi_t, _ = ls.neighborhood_pass(CFG, cpos0)
    phi_d, _ = ls.seed_closest(CFG, p)
    np.testing.assert_allclose(np.asarray(phi_t), np.asarray(phi_d), atol=1e-5)

    got = ct.p2g_from_table(CFG, table, p, v)
    want = p2g.transfer_to_grid(CFG, p, v)
    for i in range(3):
        valid = np.asarray(want[3 + i])
        np.testing.assert_array_equal(np.asarray(got[3 + i]), valid)
        np.testing.assert_allclose(
            np.asarray(got[i])[valid], np.asarray(want[i])[valid],
            rtol=2e-4, atol=2e-4,
        )


def test_overflow_count_matches_table():
    """overflow_count (the drivers' cheap fidelity monitor) agrees with the
    table build's own n_overflow at both binning granularities."""
    from fluidsimulation.solver.step3d import overflow_count

    pos, vel = _seeded()
    K = ct.default_k(CFG)
    p = np.asarray(pos).copy()
    p[: 3 * K] = (8.0 + np.random.default_rng(1).uniform(
        -0.45, 0.45, size=(3 * K, 3))) / 16.0
    p = jnp.asarray(p)

    table = ct.build_cell_table(CFG, p, vel)
    assert int(overflow_count(p, CFG)) == int(table.n_overflow) > 0

    cfg1 = SimConfig(nx=16, ny=16, nz=16, cells_per_meter=16.0,
                     particles_per_cell_axis=1)
    from fluidsimulation.ops.supertable import build_super_table
    from fluidsimulation.solver.step3d import use_super_table

    assert use_super_table(cfg1)
    pos1, _ = dam_break_particles(cfg1)
    p1 = np.asarray(pos1).copy()
    p1[:40] = (8.0 + np.random.default_rng(2).uniform(
        -0.45, 0.45, size=(40, 3))) / 16.0
    p1 = jnp.asarray(p1)
    vel1 = jnp.zeros_like(p1)
    st = build_super_table(cfg1, p1, vel1)
    assert int(overflow_count(p1, cfg1)) == int(st.n_overflow) > 0


def test_overflow_autotune_policy():
    """Power-of-4 tiers with 2x headroom, symmetric (shrinks after the
    slosh peak — tier programs are compile-cached), N ceiling."""
    import dataclasses

    from fluidsimulation.solver.step3d import overflow_autotune

    cfg = SimConfig(nx=64, ny=64, nz=64, cells_per_meter=64.0)  # N=953312
    assert overflow_autotune(cfg, 0) is cfg
    assert overflow_autotune(cfg, 2048) is cfg  # 2*2048 == cap: covered
    assert overflow_autotune(cfg, 2049).overflow_cap == 16384
    assert overflow_autotune(cfg, 40000).overflow_cap == 262144
    # Ceiling: cap never exceeds N (cap >= N == the full exact scatter).
    assert overflow_autotune(cfg, 900000).overflow_cap == cfg.num_particles
    # Symmetric: steps back down when the observed overflow recedes
    # (both tier programs are already compiled + disk-cached).
    hi = dataclasses.replace(cfg, overflow_cap=262144)
    assert overflow_autotune(hi, 27306).overflow_cap == 65536
    assert overflow_autotune(hi, 10).overflow_cap == 4096
    assert overflow_autotune(hi, 100000) is hi


def test_overflow_exactness_beyond_default_cap():
    """A clump larger than the DEFAULT 4096 cap: with the auto-raised cap
    the fast path stays exact (P2G vs the direct scatter) and n_overflow is
    fully covered — the 'no silent drops' contract."""
    import dataclasses

    from fluidsimulation.solver.step3d import overflow_autotune

    pos, vel = _seeded()
    n_clump = 6000  # > 4096 default cap, one cell's neighborhood
    rng = np.random.default_rng(3)
    p = np.asarray(pos).copy()
    p[:n_clump] = (8.0 + rng.uniform(-0.45, 0.45, size=(n_clump, 3))) / 16.0
    p = jnp.asarray(p)

    cfg = dataclasses.replace(CFG)
    table = ct.build_cell_table(cfg, p, vel)
    n_over = int(table.n_overflow)
    assert n_over > cfg.overflow_cap  # default cap would silently drop

    cfg = overflow_autotune(cfg, n_over)
    assert cfg.overflow_cap >= n_over
    table = ct.build_cell_table(cfg, p, vel)
    # Covered: every overflow particle has a live fallback slot.
    assert int((np.asarray(table.overflow_idx) < p.shape[0]).sum()) == n_over

    got = ct.p2g_from_table(cfg, table, p, vel)
    want = p2g.transfer_to_grid(cfg, p, vel)
    for i in range(3):
        valid = np.asarray(want[3 + i])
        np.testing.assert_array_equal(np.asarray(got[3 + i]), valid)
        np.testing.assert_allclose(
            np.asarray(got[i])[valid], np.asarray(want[i])[valid],
            rtol=2e-4, atol=2e-4,
        )
