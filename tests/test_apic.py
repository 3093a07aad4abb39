"""APIC transfer (ops/apic.py) + stepper (solver/apic.py) tests.

Key analytic properties of the quadratic-B-spline APIC pair:
 * partition of unity / linear completeness of the weights,
 * D_p = (1/4) diag(1/m^2) identically (the no-solve C = 4 B m^2 rule),
 * affine velocity fields v(x) = v0 + A (x - x0) round-trip P2G -> G2P
   exactly (both v and C recovered) — this is APIC's defining property
   (angular momentum preservation is the A = skew case),
 * constant fields transfer exactly (normalization sanity),
 * the full stepper runs and behaves physically on a small dam break.
"""

import pytest

import jax
import jax.numpy as jnp
import numpy as np

from fluidsimulation.core.config import SimConfig
from fluidsimulation.ops.apic import (
    _component_nodes,
    _quad_spline,
    g2p_apic,
    p2g_apic,
)


def _cfg(n=16):
    return SimConfig(nx=n, ny=n, nz=n, cells_per_meter=float(n))


def _block_particles(cfg, lo=0.3, hi=0.7, ppc=2, seed=0):
    """Dense jittered block of particles in [lo,hi]^3 (meters)."""
    rng = np.random.default_rng(seed)
    m = np.array([cfg.nx, cfg.ny, cfg.nz], np.float32)
    cells = np.stack(
        np.meshgrid(
            *[np.arange(int(lo * d), int(hi * d)) for d in m], indexing="ij"
        ),
        -1,
    ).reshape(-1, 3)
    sub = np.stack(
        np.meshgrid(*[np.arange(ppc)] * 3, indexing="ij"), -1
    ).reshape(-1, 3)
    pc = (
        cells[:, None, :]
        + (sub[None, :, :] + 0.5) / ppc
        - 0.5
        + rng.uniform(-0.2, 0.2, (len(cells), len(sub), 3))
    ).reshape(-1, 3)
    return jnp.asarray((pc / m).astype(np.float32))


def test_quad_spline_properties():
    t = jnp.linspace(-0.49, 0.49, 21) + 7.0  # arbitrary node-frame coords
    base = jnp.floor(t - 0.5)
    w = [_quad_spline(t - (base + o)) for o in (0, 1, 2)]
    np.testing.assert_allclose(sum(w), 1.0, atol=1e-6)  # partition of unity
    nodes = [base + o for o in (0, 1, 2)]
    first = sum(wi * xi for wi, xi in zip(w, nodes))
    np.testing.assert_allclose(first, t, atol=1e-5)  # linear completeness
    second = sum(wi * (xi - t) ** 2 for wi, xi in zip(w, nodes))
    np.testing.assert_allclose(second, 0.25, atol=1e-6)  # D = 1/4 (cell^2)


def test_inertia_identity_all_components():
    cfg = _cfg(16)
    m = np.array([cfg.nx, cfg.ny, cfg.nz], np.float32)
    rng = np.random.default_rng(1)
    pos = jnp.asarray(rng.uniform(0.3, 0.7, (64, 3)).astype(np.float32))
    pc = pos * jnp.asarray(m)
    for comp in range(3):
        D = np.zeros((64, 3, 3), np.float32)
        for _idx, ok, w, dxm in _component_nodes(cfg, pc, comp):
            assert bool(np.asarray(ok).all())  # interior: all nodes valid
            for a in range(3):
                for b in range(3):
                    D[:, a, b] += np.asarray(w * dxm[a] * dxm[b])
        expect = np.diag(0.25 / m**2)
        np.testing.assert_allclose(D, np.broadcast_to(expect, D.shape),
                                   atol=1e-8)


def test_constant_field_transfers_exactly():
    cfg = _cfg(16)
    pos = _block_particles(cfg)
    n = pos.shape[0]
    v0 = jnp.asarray([0.3, -0.2, 0.1], jnp.float32)
    vel = jnp.broadcast_to(v0, (n, 3))
    C = jnp.zeros((n, 3, 3), jnp.float32)
    u, v, w, uv, vv, wv = p2g_apic(cfg, pos, vel, C)
    # Interior valid faces hold exactly v0 (weighted average of constant).
    assert bool(uv[1:-1].any())
    np.testing.assert_allclose(np.asarray(u[1:-1])[np.asarray(uv[1:-1])],
                               0.3, atol=1e-5)
    np.testing.assert_allclose(np.asarray(v[:, 1:-1])[np.asarray(vv[:, 1:-1])],
                               -0.2, atol=1e-5)
    np.testing.assert_allclose(np.asarray(w[..., 1:-1])[np.asarray(wv[..., 1:-1])],
                               0.1, atol=1e-5)


def test_affine_field_roundtrips_exactly():
    """v(x) = v0 + A (x - x0) with a generic A (rotation + shear + scale):
    P2G produces the exact affine field on every covered face, and G2P
    recovers both vel and C — APIC's defining exactness."""
    cfg = _cfg(16)
    pos = _block_particles(cfg, lo=0.2, hi=0.8)
    n = pos.shape[0]
    v0 = jnp.asarray([0.05, -0.1, 0.2], jnp.float32)
    x0 = jnp.asarray([0.5, 0.5, 0.5], jnp.float32)
    A = jnp.asarray(
        [[0.3, 1.5, -0.7], [-1.5, 0.1, 0.4], [0.7, -0.4, -0.2]], jnp.float32
    )
    vel = v0 + (pos - x0) @ A.T
    C = jnp.broadcast_to(A, (n, 3, 3))

    u, v, w, uv, vv, wv = p2g_apic(cfg, pos, vel, C)

    # Spot-check P2G exactness on interior valid U faces.
    m = np.array([cfg.nx, cfg.ny, cfg.nz], np.float32)
    uvn = np.asarray(uv)
    idx = np.argwhere(uvn)
    idx = idx[(idx[:, 0] > 0) & (idx[:, 0] < cfg.nx)]
    xs = np.stack(
        [(idx[:, 0] - 0.5) / m[0], idx[:, 1] / m[1], idx[:, 2] / m[2]], -1
    )
    expect_u = np.asarray(v0)[0] + (xs - np.asarray(x0)) @ np.asarray(A[0])
    np.testing.assert_allclose(np.asarray(u)[tuple(idx.T)], expect_u,
                               atol=2e-4)

    # G2P roundtrip on particles well inside the block (>= 3 cells from
    # the block surface, so every spline node carries a valid face value).
    vel2, C2 = g2p_apic(cfg, pos, u, v, w)
    # Inner = >= 2.5 cells inside the particle cloud: every spline node
    # (within 1.5 cells) then lies in particle-covered, valid-face space.
    pn = np.asarray(pos)
    margin = 2.5 / m[0]
    inner = np.all(
        (pn > pn.min(0) + margin) & (pn < pn.max(0) - margin), axis=1
    )
    assert inner.sum() > 100
    np.testing.assert_allclose(np.asarray(vel2)[inner],
                               np.asarray(vel)[inner], atol=2e-4)
    np.testing.assert_allclose(np.asarray(C2)[inner],
                               np.asarray(C)[inner], atol=2e-2)


@pytest.mark.slow  # round 5 fast-tier re-tier: 55 s; the 2D smoke +
# oracle parity tests keep the fast APIC signal
def test_step_apic_dam_break_smoke():
    from fluidsimulation.solver.apic import init_apic_state, step_apic_jit

    cfg = _cfg(16)
    s = init_apic_state(cfg)
    for _ in range(5):
        s = step_apic_jit(s, 0.01, cfg)
    for arr in (s.pos, s.vel, s.C, s.u, s.v, s.w, s.phi):
        assert bool(jnp.isfinite(arr).all())
    # gravity pulls the dam down; speeds stay physical
    assert float(s.vel[:, 1].mean()) < 0.0
    assert float(jnp.abs(s.vel).max()) < 10.0
    # C picked up nonzero structure (velocity gradients exist)
    assert float(jnp.abs(s.C).max()) > 1e-3


def test_g2p_packed_matches_oracle():
    """g2p_apic_packed == g2p_apic (same math via one 9x32 row gather per
    component; edge-padded rows replicate the oracle's clamp addressing),
    on random grids INCLUDING boundary-adjacent particles."""
    from fluidsimulation.ops.apic import g2p_apic_packed

    cfg = _cfg(16)
    rng = np.random.default_rng(3)
    u = jnp.asarray(rng.normal(size=(17, 16, 16)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(16, 17, 16)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(16, 16, 17)).astype(np.float32))
    # Positions spanning the advect-clamp range incl. near-wall cells.
    lo, hi = -0.4 / 16, 1.0 - 0.6 / 16
    pos = jnp.asarray(rng.uniform(lo, hi, (4096, 3)).astype(np.float32))

    vel0, C0 = g2p_apic(cfg, pos, u, v, w)
    vel1, C1 = g2p_apic_packed(cfg, pos, u, v, w)
    np.testing.assert_allclose(np.asarray(vel1), np.asarray(vel0),
                               atol=2e-6)
    np.testing.assert_allclose(np.asarray(C1), np.asarray(C0),
                               atol=2e-3)  # C scale ~ 4 m^2


def test_g2p_packed_hat_matches_interp():
    """g2p_apic_packed(with_hat=True)'s khat == the hat (trilinear) MAC
    interp at pos (core/interp_packed.py semantics) — the free RK3 stage-1
    value the APIC AdvectCache carries — incl. clamp-range positions."""
    from fluidsimulation.core.interp_packed import (
        interp_mac3_packed_vec,
        pack_mac3,
    )
    from fluidsimulation.ops.apic import g2p_apic_packed

    cfg = _cfg(16)
    rng = np.random.default_rng(7)
    u = jnp.asarray(rng.normal(size=(17, 16, 16)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(16, 17, 16)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(16, 16, 17)).astype(np.float32))
    lo, hi = -0.4 / 16, 1.0 - 0.6 / 16
    pos = jnp.asarray(rng.uniform(lo, hi, (4096, 3)).astype(np.float32))

    vel0, C0 = g2p_apic_packed(cfg, pos, u, v, w)
    vel1, C1, khat = g2p_apic_packed(cfg, pos, u, v, w, with_hat=True)
    np.testing.assert_array_equal(np.asarray(vel1), np.asarray(vel0))
    np.testing.assert_array_equal(np.asarray(C1), np.asarray(C0))

    m = jnp.array([cfg.nx, cfg.ny, cfg.nz], jnp.float32)
    want = interp_mac3_packed_vec(
        *pack_mac3(u, v, w), (cfg.nx, cfg.ny, cfg.nz), pos * m
    )
    np.testing.assert_allclose(np.asarray(khat), np.asarray(want), atol=2e-6)


def test_advect_rk3_pic_consistency():
    """advect_rk3_pic (stage 1 = the particle's own velocity — the APIC
    stepper's advection) equals advect_rk3 exactly when vel is fed the
    hat interp at pos (same stages 2/3), and tracks it closely when vel
    is the spline sample instead (the real APIC case)."""
    from fluidsimulation.core.interp_packed import (
        interp_mac3_packed_vec,
        pack_mac3,
    )
    from fluidsimulation.ops.advect import advect_rk3, advect_rk3_pic
    from fluidsimulation.ops.apic import g2p_apic_packed

    cfg = _cfg(16)
    rng = np.random.default_rng(9)
    u = jnp.asarray(rng.normal(size=(17, 16, 16)).astype(np.float32))
    v = jnp.asarray(rng.normal(size=(16, 17, 16)).astype(np.float32))
    w = jnp.asarray(rng.normal(size=(16, 16, 17)).astype(np.float32))
    pos = jnp.asarray(rng.uniform(0.05, 0.9, (2048, 3)).astype(np.float32))
    dt = 0.01

    m = jnp.array([cfg.nx, cfg.ny, cfg.nz], jnp.float32)
    khat = interp_mac3_packed_vec(
        *pack_mac3(u, v, w), (cfg.nx, cfg.ny, cfg.nz), pos * m
    )
    ref = advect_rk3(cfg, u, v, w, pos, dt, packed=True)
    got = advect_rk3_pic(cfg, u, v, w, pos, khat, dt)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=1e-7)

    vspline, _ = g2p_apic_packed(cfg, pos, u, v, w)
    got2 = advect_rk3_pic(cfg, u, v, w, pos, vspline, dt)
    # Spline-vs-hat stage 1 differs by O(h^2) * dt * (2/9).
    np.testing.assert_allclose(np.asarray(got2), np.asarray(ref), atol=5e-3)


@pytest.mark.slow  # round 5: 29 s; the fused variant below stays fast
def test_p2g_table_matches_oracle():
    """p2g_apic_from_table == p2g_apic (dense spline windows over the
    16-field slot table + bounded overflow scatter vs direct scatter),
    same validity masks, values to fp tolerance."""
    from fluidsimulation.ops.apic import (
        build_apic_table,
        p2g_apic_from_table,
    )

    cfg = _cfg(16)
    pos = _block_particles(cfg, lo=0.2, hi=0.8)
    n = pos.shape[0]
    rng = np.random.default_rng(5)
    vel = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    C = jnp.asarray(rng.normal(size=(n, 3, 3)).astype(np.float32) * 3.0)

    ref = p2g_apic(cfg, pos, vel, C)
    for k in (None, 4):  # default K, and a tiny K forcing heavy overflow
        table = build_apic_table(cfg, pos, vel, C, k=k)
        got = p2g_apic_from_table(cfg, table, pos, vel, C)
        if k == 4:
            assert int(table.n_overflow) > 100
        for a, b, name in zip(got, ref, ("u", "v", "w", "uv", "vv", "wv")):
            if name.endswith("v") and len(name) == 2:
                np.testing.assert_array_equal(
                    np.asarray(a), np.asarray(b), err_msg=name)
            else:
                np.testing.assert_allclose(
                    np.asarray(a), np.asarray(b), atol=5e-5, err_msg=name)


def test_p2g_table_fused_matches_oracle():
    """The union-window fused P2G (54 windows, cell-indexed accumulators)
    matches the oracle like the unfused table form."""
    from fluidsimulation.ops.apic import (
        build_apic_table,
        p2g_apic_from_table_fused,
    )

    cfg = _cfg(16)
    pos = _block_particles(cfg, lo=0.2, hi=0.8)
    n = pos.shape[0]
    rng = np.random.default_rng(7)
    vel = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    C = jnp.asarray(rng.normal(size=(n, 3, 3)).astype(np.float32) * 3.0)

    ref = p2g_apic(cfg, pos, vel, C)
    for k in (None, 4):
        table = build_apic_table(cfg, pos, vel, C, k=k)
        got = p2g_apic_from_table_fused(cfg, table, pos, vel, C)
        for a, b, name in zip(got, ref, ("u", "v", "w", "uv", "vv", "wv")):
            if len(name) == 2:
                np.testing.assert_array_equal(
                    np.asarray(a), np.asarray(b), err_msg=name)
            else:
                np.testing.assert_allclose(
                    np.asarray(a), np.asarray(b), atol=5e-5, err_msg=name)


def test_apic_table_seeding_matches_celltable():
    """ApicTable's 16-field slots are layout-compatible with CellTable for
    the level-set seeding fields (0-2 = pc, 6 = present): seeding from
    either table is bit-identical, and the fast step's phi matches the
    slow step's at the usual fast/slow tolerance."""
    from fluidsimulation.ops.apic import build_apic_table
    from fluidsimulation.ops.celltable import (
        build_cell_table,
        seed_closest_from_table,
        seed_overflow_correction,
    )
    from fluidsimulation.ops.levelset import FAR

    cfg = _cfg(16)
    pos = _block_particles(cfg, lo=0.2, hi=0.8)
    n = pos.shape[0]
    rng = np.random.default_rng(9)
    vel = jnp.asarray(rng.normal(size=(n, 3)).astype(np.float32))
    C = jnp.zeros((n, 3, 3), jnp.float32)

    ta = build_apic_table(cfg, pos, vel, C)
    tc = build_cell_table(cfg, pos, vel)
    pa, ca = seed_closest_from_table(cfg, ta, FAR)
    pc_, cc = seed_closest_from_table(cfg, tc, FAR)
    np.testing.assert_array_equal(np.asarray(pa), np.asarray(pc_))
    np.testing.assert_array_equal(np.asarray(ca), np.asarray(cc))
    pa2, ca2 = seed_overflow_correction(cfg, ta, pos, pa, ca)
    pc2, cc2 = seed_overflow_correction(cfg, tc, pos, pc_, cc)
    np.testing.assert_array_equal(np.asarray(pa2), np.asarray(pc2))
    np.testing.assert_array_equal(np.asarray(ca2), np.asarray(cc2))


@pytest.mark.slow
def test_step_apic_fast_matches_slow():
    """One fast step vs one slow (oracle transfer + direct level set) step
    from the same state: fields agree to fast/slow tolerance."""
    from fluidsimulation.solver.apic import init_apic_state, step_apic

    cfg = _cfg(16)
    s = init_apic_state(cfg)
    import jax

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


def test_apic_checkpoint_roundtrip(tmp_path):
    from fluidsimulation.solver.apic import init_apic_state, step_apic_jit
    from fluidsimulation.utils.checkpoint import (
        load_apic_state,
        save_apic_state,
    )

    cfg = _cfg(16)
    s = step_apic_jit(init_apic_state(cfg), 0.01, cfg)
    path = str(tmp_path / "apic.npz")
    save_apic_state(path, s, cfg)
    r = load_apic_state(path, cfg)
    for k in ("pos", "vel", "C", "u", "v", "w", "phi"):
        np.testing.assert_array_equal(
            np.asarray(getattr(r, k)), np.asarray(getattr(s, k)), err_msg=k)
    # resume steps
    r2 = step_apic_jit(
        jax.tree.map(jnp.asarray, r), 0.01, cfg
    )
    assert bool(jnp.isfinite(r2.vel).all())
    # cfg mismatch raises
    import pytest
    with pytest.raises(ValueError):
        load_apic_state(path, _cfg(8))


@pytest.mark.slow  # round 5: 26 s; 2D extension tier
def test_apic2d_affine_roundtrip_and_smoke():
    """2D APIC tier: affine fields round-trip exactly (interior), and the
    2D stepper runs a stable dam break (the reference's 2D stepping-stone
    methodology applied to the extension family)."""
    from fluidsimulation.core.config import SimConfig2D
    from fluidsimulation.solver.apic2d import (
        g2p_apic2d,
        init_apic_state2d,
        p2g_apic2d,
        step_apic2d_jit,
    )

    cfg = SimConfig2D(nx=32, ny=32, cells_per_meter=32.0)
    rng = np.random.default_rng(11)
    m = np.array([cfg.nx, cfg.ny], np.float32)
    # dense jittered block in [0.2, 0.8]^2
    cells = np.stack(np.meshgrid(np.arange(6, 26), np.arange(6, 26),
                                 indexing="ij"), -1).reshape(-1, 2)
    sub = np.stack(np.meshgrid(np.arange(2), np.arange(2), indexing="ij"),
                   -1).reshape(-1, 2)
    pc = (cells[:, None, :] + (sub[None, :, :] + 0.5) / 2 - 0.5
          + rng.uniform(-0.2, 0.2, (len(cells), len(sub), 2))).reshape(-1, 2)
    pos = jnp.asarray((pc / m).astype(np.float32))
    n = pos.shape[0]

    v0 = jnp.asarray([0.1, -0.2], jnp.float32)
    x0 = jnp.asarray([0.5, 0.5], jnp.float32)
    A = jnp.asarray([[0.4, 1.2], [-1.2, -0.3]], jnp.float32)
    vel = v0 + (pos - x0) @ A.T
    C = jnp.broadcast_to(A, (n, 2, 2))

    u, v, uv, vv = p2g_apic2d(cfg, pos, vel, C)
    vel2, C2 = g2p_apic2d(cfg, pos, u, v)
    pn = np.asarray(pos)
    margin = 2.5 / m[0]
    inner = np.all((pn > pn.min(0) + margin) & (pn < pn.max(0) - margin), axis=1)
    assert inner.sum() > 100
    np.testing.assert_allclose(np.asarray(vel2)[inner],
                               np.asarray(vel)[inner], atol=2e-4)
    np.testing.assert_allclose(np.asarray(C2)[inner],
                               np.asarray(C)[inner], atol=2e-2)

    s = init_apic_state2d(cfg)
    for _ in range(5):
        s = step_apic2d_jit(s, 0.01, cfg)
    for arr in (s.pos, s.vel, s.C, s.u, s.v, s.phi):
        assert bool(jnp.isfinite(arr).all())
    assert float(jnp.abs(s.vel).max()) < 10.0
