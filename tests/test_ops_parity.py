"""Per-op parity: JAX ops vs the independently-written NumPy twin.

Mirrors the reference's stage-by-stage GPU-vs-CPU validation methodology
(README.md:55).  Tolerances here are tight (float roundoff), because both
sides implement identical semantics in f32.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from fluidsimulation.core.config import SimConfig
from fluidsimulation.core.seeding import dam_break_particles, noise_grids
from fluidsimulation.ops import advect as ops_advect
from fluidsimulation.ops import binning as ops_binning
from fluidsimulation.ops import blur as ops_blur
from fluidsimulation.ops import extrapolate as ops_extrap
from fluidsimulation.ops import forces as ops_forces
from fluidsimulation.ops import levelset as ops_levelset
from fluidsimulation.ops import p2g as ops_p2g
from fluidsimulation.ops import project as ops_project
from fluidsimulation.reference import solver3d, twin3d

CFG = SimConfig(nx=16, ny=16, nz=16, cells_per_meter=16.0)


@pytest.fixture(scope="module")
def seeded():
    pos, _ = dam_break_particles(CFG)
    u, v, w = noise_grids(CFG, seed=7)
    # Give particles nonzero velocities by sampling the noise field.
    m = np.array([CFG.nx, CFG.ny, CFG.nz], np.float32)
    vel = np.stack(
        solver3d.interp_mac(u, v, w, m[0] * pos[:, 0], m[1] * pos[:, 1], m[2] * pos[:, 2]),
        axis=-1,
    ).astype(np.float32)
    return pos, vel, u, v, w


def test_advect_matches_oracle(seeded):
    pos, vel, u, v, w = seeded
    dt = 0.01
    got = np.asarray(ops_advect.advect_rk3(CFG, u, v, w, pos, dt))
    want = solver3d.advect(CFG, u, v, w, pos, dt)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_binning_counts_and_offsets(seeded):
    pos, vel, *_ = seeded
    counts, start, bpos, bvel, order = ops_binning.bin_particles(CFG, jnp.asarray(pos), jnp.asarray(vel))
    counts = np.asarray(counts)
    start = np.asarray(start)
    # NumPy histogram check
    m = np.array([CFG.nx, CFG.ny, CFG.nz], np.float32)
    cell = np.floor(pos * m + 0.5).astype(np.int64)
    want = np.zeros((CFG.nx, CFG.ny, CFG.nz), np.int64)
    np.add.at(want, (cell[:, 0], cell[:, 1], cell[:, 2]), 1)
    np.testing.assert_array_equal(counts, want)
    assert counts.sum() == len(pos)
    # Exclusive prefix sum in x-fastest order
    lin = counts.transpose(2, 1, 0).ravel()
    ex = np.cumsum(lin) - lin
    np.testing.assert_array_equal(start.transpose(2, 1, 0).ravel(), ex)
    # Binned particles are sorted by reference cell id
    bcell = np.floor(np.asarray(bpos) * m + 0.5).astype(np.int64)
    blin = bcell[:, 0] + CFG.nx * (bcell[:, 1] + CFG.ny * bcell[:, 2])
    assert (np.diff(blin) >= 0).all()


def test_levelset_seed_matches_twin(seeded):
    pos, *_ = seeded
    phi_j, cpos_j = ops_levelset.seed_closest(CFG, jnp.asarray(pos))
    phi_n, cpos_n = twin3d.seed_closest(CFG, pos)
    np.testing.assert_allclose(np.asarray(phi_j), phi_n, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.asarray(cpos_j), cpos_n, rtol=0, atol=1e-5)


def test_levelset_sweeps_match_twin(seeded):
    pos, *_ = seeded
    phi_j, cpos_j = ops_levelset.compute_level_set(CFG, jnp.asarray(pos))
    phi_n, cpos_n = twin3d.sweep_closest(CFG, *twin3d.seed_closest(CFG, pos))
    np.testing.assert_allclose(np.asarray(phi_j), phi_n, rtol=0, atol=1e-4)


def test_levelset_near_interface_matches_cpu_oracle(seeded):
    """Near the interface (the band the projection reads), the GPU-style
    sweep result should agree with the CPU solver's level set closely."""
    pos, *_ = seeded
    phi_j, _ = ops_levelset.compute_level_set(CFG, jnp.asarray(pos))
    phi_cpu, _ = solver3d.compute_level_set(CFG, pos)
    phi_j = np.asarray(phi_j)
    band = np.abs(phi_cpu) < 2.0
    assert band.any()
    diff = np.abs(phi_j - phi_cpu)[band]
    assert np.quantile(diff, 0.99) < 0.35  # sub-half-cell agreement
    # Sign agreement in the band defines the fluid region for projection.
    sign_match = ((phi_j < 0) == (phi_cpu < 0))[np.abs(phi_cpu) > 0.05]
    assert sign_match.mean() > 0.99


def test_p2g_matches_twin(seeded):
    pos, vel, *_ = seeded
    got = ops_p2g.transfer_to_grid(CFG, jnp.asarray(pos), jnp.asarray(vel))
    want = twin3d.transfer_to_grid(CFG, pos, vel)
    for g_j, g_n, v_j, v_n in [
        (got[0], want[0], got[3], want[3]),
        (got[1], want[1], got[4], want[4]),
        (got[2], want[2], got[5], want[5]),
    ]:
        v_j = np.asarray(v_j)
        np.testing.assert_array_equal(v_j, v_n)
        # values compared only on valid faces (invalid are unspecified)
        np.testing.assert_allclose(
            np.asarray(g_j)[v_n], np.asarray(g_n)[v_n], rtol=2e-5, atol=2e-5
        )


def test_p2g_valid_matches_cpu_scatter(seeded):
    """P2G math equals the CPU solver's scatter (same reduction, different
    order) on valid faces; reference recorded 2.8e-5 relative error for its
    gather-vs-scatter pair (Simulation.cpp:523)."""
    pos, vel, *_ = seeded
    u_j, v_j, w_j, uv, vv, wv = ops_p2g.transfer_to_grid(
        CFG, jnp.asarray(pos), jnp.asarray(vel)
    )
    u_c, v_c, w_c, uvc, vvc, wvc = solver3d.transfer_particles_to_grid(CFG, pos, vel)
    for g_j, ok_j, g_c, ok_c in [
        (u_j, uv, u_c, uvc),
        (v_j, vv, v_c, vvc),
        (w_j, wv, w_c, wvc),
    ]:
        ok = np.asarray(ok_j) & ok_c
        np.testing.assert_allclose(
            np.asarray(g_j)[ok], g_c[ok], rtol=1e-4, atol=1e-4
        )


def test_extrapolate_matches_twin(seeded):
    pos, vel, *_ = seeded
    u, v, w, uv, vv, wv = twin3d.transfer_to_grid(CFG, pos, vel)
    got = np.asarray(ops_extrap.extrapolate_one_ring(jnp.asarray(u), jnp.asarray(uv)))
    want = twin3d.extrapolate_one_ring(u, uv)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_gravity(seeded):
    _, _, u, v, w = seeded
    dt = 0.01
    got = np.asarray(ops_forces.add_gravity(CFG, jnp.asarray(v), dt))
    want = v.copy()
    want[:, 1 : CFG.ny, :] += np.float32(-9.81 * dt)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_projection_matches_twin(seeded):
    pos, vel, *_ = seeded
    dt = 0.01
    u, v, w, uv, vv, wv = twin3d.transfer_to_grid(CFG, pos, vel)
    u = twin3d.extrapolate_one_ring(u, uv)
    v = twin3d.extrapolate_one_ring(v, vv)
    w = twin3d.extrapolate_one_ring(w, wv)
    phi, _ = twin3d.sweep_closest(CFG, *twin3d.seed_closest(CFG, pos))
    got_u, got_v, got_w, got_p = ops_project.project(
        CFG, jnp.asarray(u), jnp.asarray(v), jnp.asarray(w), jnp.asarray(phi), dt
    )
    want_u, want_v, want_w, want_p = twin3d.project_f32(CFG, u, v, w, phi, dt)
    np.testing.assert_allclose(np.asarray(got_p), want_p, rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(got_u), want_u, rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(got_v), want_v, rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(np.asarray(got_w), want_w, rtol=1e-3, atol=2e-3)


def test_projection_kills_divergence(seeded):
    """Post-projection divergence invariant (PrintDivergence,
    Simulation3D.cpp:1095): max divergence in fluid cells goes to ~0."""
    pos, vel, *_ = seeded
    dt = 0.01
    u, v, w, uv, vv, wv = twin3d.transfer_to_grid(CFG, pos, vel)
    u = twin3d.extrapolate_one_ring(u, uv)
    v = twin3d.extrapolate_one_ring(v, vv)
    w = twin3d.extrapolate_one_ring(w, wv)
    phi, _ = twin3d.sweep_closest(CFG, *twin3d.seed_closest(CFG, pos))
    v2 = np.asarray(ops_forces.add_gravity(CFG, jnp.asarray(v), dt))
    before_l2, before_max, _ = solver3d.divergence_stats(CFG, u, v2, w, phi)
    got_u, got_v, got_w, _ = ops_project.project(
        CFG, jnp.asarray(u), jnp.asarray(v2), jnp.asarray(w), jnp.asarray(phi), dt
    )
    l2, mx, _ = solver3d.divergence_stats(
        CFG, np.asarray(got_u), np.asarray(got_v), np.asarray(got_w), phi
    )
    # Reference at 16^3: max divergence 1.583e-8 after 100 iters
    # (Simulation3D.cpp:938) — allow f32 slack.
    assert mx < 1e-4, (before_max, mx)
    assert l2 < 1e-3 * max(1.0, before_l2)


def test_blur_matches_twin(seeded):
    pos, *_ = seeded
    phi, _ = twin3d.seed_closest(CFG, pos)
    got = np.asarray(ops_blur.blur_phi(jnp.asarray(phi)))
    want = twin3d.blur_phi(phi)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
