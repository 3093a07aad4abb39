"""Supercell APIC table (ops/apic_super.py): build/seed/P2G parity with
the per-cell ApicTable forms, overflow exactness, and the stepper gate."""

import numpy as np

import jax
import jax.numpy as jnp
import pytest

from fluidsimulation.core.config import SimConfig
from fluidsimulation.ops import apic_super as asup
from fluidsimulation.ops import levelset as ls
from fluidsimulation.ops.apic import (
    build_apic_table,
    p2g_apic,
    p2g_apic_from_table_fused,
)
from fluidsimulation.ops.celltable import (
    seed_closest_from_table,
    seed_overflow_correction,
)
from fluidsimulation.ops.supertable import F, seed_closest_from_super, super_k
from test_apic import _block_particles


def _cfg(n=16):
    # ppc_axis=1 so the supercell gate (solver.step3d.use_super_table) is on.
    return SimConfig(nx=n, ny=n, nz=n, cells_per_meter=float(n),
                     particles_per_cell_axis=1)


def _seeded(cfg, seed=3, scale=3.0):
    pos = _block_particles(cfg, lo=0.2, hi=0.8, ppc=1, seed=seed)
    n = pos.shape[0]
    rng = np.random.default_rng(seed + 1)
    vel = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    C = jnp.asarray(rng.normal(size=(n, 3, 3)).astype(np.float32) * scale)
    return pos, vel, C


def test_apic_super_build_shape_and_slot_order():
    cfg = _cfg(16)
    pos, vel, C = _seeded(cfg)
    t = asup.build_apic_super_table(cfg, pos, vel, C)
    sx, sy, sz = cfg.nx // F[0], cfg.ny // F[1], cfg.nz // F[2]
    assert t.slots.shape == (sx, sy, super_k(cfg), 16, sz)
    slots = np.asarray(t.slots)
    m = np.array([cfg.nx, cfg.ny, cfg.nz], np.float32)
    pc = np.asarray(pos) * m
    sc = np.floor(pc + 0.5).astype(np.int64) // np.array(F)
    for target in [tuple(sc[0]), tuple(sc[77])]:
        members = np.nonzero((sc == np.array(target)).all(axis=1))[0]
        k = min(len(members), slots.shape[2])
        x, y, z = target
        got_pos = slots[x, y, :k, 0:3, z]
        np.testing.assert_allclose(got_pos, pc[members[:k]], atol=1e-5)
        got_c = slots[x, y, :k, 7:16, z]
        np.testing.assert_allclose(
            got_c, np.asarray(C)[members[:k]].reshape(k, 9), atol=1e-6)


def test_apic_super_seed_matches_celltable_exactly():
    cfg = _cfg(16)
    pos, vel, C = _seeded(cfg, seed=5)
    t_cell = build_apic_table(cfg, pos, vel, C)
    t_sup = asup.build_apic_super_table(cfg, pos, vel, C)
    a0, ac = seed_closest_from_table(cfg, t_cell, ls.FAR)
    a0, ac = seed_overflow_correction(cfg, t_cell, pos, a0, ac)
    b0, bc = seed_closest_from_super(cfg, t_sup, ls.FAR)
    b0, bc = seed_overflow_correction(cfg, t_sup, pos, b0, bc)
    np.testing.assert_array_equal(np.asarray(a0), np.asarray(b0))
    np.testing.assert_array_equal(np.asarray(ac), np.asarray(bc))


def _check_p2g(cfg, pos, vel, C, table):
    got = asup.p2g_apic_from_super_fused(cfg, table, pos, vel, C)
    ref = p2g_apic(cfg, pos, vel, C)
    for a, b, name in zip(got, ref, ("u", "v", "w", "uv", "vv", "wv")):
        if len(name) == 2:
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b), err_msg=name)
        else:
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=5e-5, err_msg=name)


def test_apic_super_p2g_matches_oracle():
    cfg = _cfg(16)
    pos, vel, C = _seeded(cfg, seed=7)
    table = asup.build_apic_super_table(cfg, pos, vel, C)
    assert int(table.n_overflow) == 0
    _check_p2g(cfg, pos, vel, C, table)


def test_apic_super_p2g_overflow_exactness():
    """Tiny Ks forces heavy overflow: the bounded scatter must keep the
    result exact vs the oracle."""
    cfg = _cfg(16)
    pos, vel, C = _seeded(cfg, seed=9)
    table = asup.build_apic_super_table(cfg, pos, vel, C, ks=2)
    assert int(table.n_overflow) > 100
    _check_p2g(cfg, pos, vel, C, table)


def test_apic_super_p2g_matches_cell_fused():
    """Super vs per-cell fused forms agree to f32 reassociation."""
    cfg = _cfg(16)
    pos, vel, C = _seeded(cfg, seed=11)
    t_sup = asup.build_apic_super_table(cfg, pos, vel, C)
    t_cell = build_apic_table(cfg, pos, vel, C)
    got = asup.p2g_apic_from_super_fused(cfg, t_sup, pos, vel, C)
    want = p2g_apic_from_table_fused(cfg, t_cell, pos, vel, C)
    for a, b, name in zip(got, want, ("u", "v", "w", "uv", "vv", "wv")):
        if len(name) == 2:
            np.testing.assert_array_equal(
                np.asarray(a), np.asarray(b), err_msg=name)
        else:
            np.testing.assert_allclose(
                np.asarray(a), np.asarray(b), atol=5e-5, err_msg=name)


@pytest.mark.slow
def test_step_apic_super_gate_matches_cell_path():
    """At ppc_axis=1 step_apic routes through the supercell table; it must
    agree with the per-cell fast path (gate forced off via ppc — compare
    against the slow oracle path instead, which is config-independent)."""
    from fluidsimulation.solver.apic import init_apic_state, step_apic
    from fluidsimulation.solver.step3d import use_super_table

    cfg = _cfg(16)
    assert use_super_table(cfg)
    s = init_apic_state(cfg)
    f = jax.jit(lambda st: step_apic(st, 0.01, cfg, fast=True))(s)
    g = jax.jit(lambda st: step_apic(st, 0.01, cfg, fast=False))(s)
    np.testing.assert_allclose(np.asarray(f.pos), np.asarray(g.pos),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(f.vel), np.asarray(g.vel),
                               atol=1e-4)
    fin = np.isfinite(np.asarray(g.phi))
    np.testing.assert_allclose(np.asarray(f.phi)[fin],
                               np.asarray(g.phi)[fin], atol=1e-4)
    np.testing.assert_allclose(np.asarray(f.C), np.asarray(g.C), atol=0.05)
