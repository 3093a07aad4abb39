"""Supercell-table tests: build counts, slot ordering, seeding and P2G
parity with the direct formulations, and overflow exactness."""

import numpy as np

import jax.numpy as jnp

from fluidsimulation.core.config import SimConfig
from fluidsimulation.ops import celltable as ct
from fluidsimulation.ops import levelset as ls
from fluidsimulation.ops import p2g
from fluidsimulation.ops import supertable as st
from test_celltable import CFG, _seeded


def test_super_build_counts():
    pos, vel = _seeded()
    table = st.build_super_table(CFG, pos, vel)
    sx, sy, sz = CFG.nx // st.F[0], CFG.ny // st.F[1], CFG.nz // st.F[2]
    assert table.slots.shape == (sx, sy, st.super_k(CFG), 8, sz)
    counts = np.asarray(st.counts_from_super(CFG, table))
    m = np.array([CFG.nx, CFG.ny, CFG.nz], np.float32)
    cell = np.floor(np.asarray(pos) * m + 0.5).astype(np.int64)
    want = np.zeros(CFG.grid_shape(), np.int64)
    np.add.at(want, tuple(cell.T), 1)
    # Dam break at ppc=2 packs 8/cell = 64/supercell > Ks: count only
    # in-table particles.
    if int(table.n_overflow) == 0:
        np.testing.assert_array_equal(counts, want)
    else:
        assert counts.sum() + int(table.n_overflow) == CFG.num_particles


def test_super_slot_order_is_original_index_order():
    pos, vel = _seeded()
    table = st.build_super_table(CFG, pos, vel)
    slots = np.asarray(table.slots)
    m = np.array([CFG.nx, CFG.ny, CFG.nz], np.float32)
    pc = np.asarray(pos) * m
    sc = np.floor(pc + 0.5).astype(np.int64) // np.array(st.F)
    for target in [tuple(sc[0]), tuple(sc[123])]:
        members = np.nonzero((sc == np.array(target)).all(axis=1))[0]
        k = min(len(members), slots.shape[2])
        x, y, z = target
        got = slots[x, y, :k, 0:3, z]
        np.testing.assert_allclose(got, pc[members[:k]], atol=1e-5)


def test_super_seed_matches_direct():
    pos, vel = _seeded()
    table = st.build_super_table(CFG, pos, vel)
    phi0, cpos0 = st.seed_closest_from_super(CFG, table, ls.FAR)
    phi0, cpos0 = st.seed_overflow_correction(CFG, table, pos, phi0, cpos0)
    phi_t, cpos_t = ls.neighborhood_pass(CFG, cpos0)
    phi_d, cpos_d = ls.seed_closest(CFG, pos)
    np.testing.assert_allclose(np.asarray(phi_t), np.asarray(phi_d), atol=1e-5)
    np.testing.assert_allclose(np.asarray(cpos_t), np.asarray(cpos_d), atol=1e-5)


def test_super_seed_matches_celltable_exactly():
    pos, vel = _seeded()
    t_cell = ct.build_cell_table(CFG, pos, vel)
    t_sup = st.build_super_table(CFG, pos, vel)
    a0, ac = ct.seed_closest_from_table(CFG, t_cell, ls.FAR)
    a0, ac = ct.seed_overflow_correction(CFG, t_cell, pos, a0, ac)
    b0, bc = st.seed_closest_from_super(CFG, t_sup, ls.FAR)
    b0, bc = st.seed_overflow_correction(CFG, t_sup, pos, b0, bc)
    np.testing.assert_array_equal(np.asarray(a0), np.asarray(b0))
    np.testing.assert_array_equal(np.asarray(ac), np.asarray(bc))


def test_super_p2g_matches_direct():
    pos, vel = _seeded()
    table = st.build_super_table(CFG, pos, vel)
    got = st.p2g_from_super(CFG, table, pos, vel)
    want = p2g.transfer_to_grid(CFG, pos, vel)
    for i in range(3):
        valid = np.asarray(want[3 + i])
        np.testing.assert_array_equal(np.asarray(got[3 + i]), valid)
        np.testing.assert_allclose(
            np.asarray(got[i])[valid], np.asarray(want[i])[valid],
            rtol=2e-4, atol=2e-4,
        )


def test_super_overflow_exactness():
    """Cram more particles into one supercell than Ks slots: the bounded
    overflow corrections must keep seeding and P2G exact."""
    pos, vel = _seeded()
    Ks = st.super_k(CFG)
    n_extra = 2 * Ks + 5
    rng = np.random.default_rng(1)
    p = np.asarray(pos).copy()
    v = np.asarray(vel).copy()
    p[:n_extra] = (8.0 + rng.uniform(-0.95, 0.95, size=(n_extra, 3))) / 16.0
    p = jnp.asarray(p)
    v = jnp.asarray(v)

    table = st.build_super_table(CFG, p, v)
    assert int(table.n_overflow) > 0

    phi0, cpos0 = st.seed_closest_from_super(CFG, table, ls.FAR)
    phi0, cpos0 = st.seed_overflow_correction(CFG, table, p, phi0, cpos0)
    phi_t, _ = ls.neighborhood_pass(CFG, cpos0)
    phi_d, _ = ls.seed_closest(CFG, p)
    np.testing.assert_allclose(np.asarray(phi_t), np.asarray(phi_d), atol=1e-5)

    got = st.p2g_from_super(CFG, table, p, v)
    want = p2g.transfer_to_grid(CFG, p, v)
    for i in range(3):
        valid = np.asarray(want[3 + i])
        np.testing.assert_array_equal(np.asarray(got[3 + i]), valid)
        np.testing.assert_allclose(
            np.asarray(got[i])[valid], np.asarray(want[i])[valid],
            rtol=2e-4, atol=2e-4,
        )
