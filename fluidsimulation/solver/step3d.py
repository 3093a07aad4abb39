"""The 3D solver step: one frame of simulation as a single pure function.

Composes the op set in the order of GPFluidSim::Simulate
(Simulation.cpp:513-566):

  advect -> cell table (bin/count/prefix-sum equivalent) -> level set
  (seed + 24 sweeps) -> P2G -> extrapolate -> snapshot old grids -> gravity
  -> project (RHS/diag/SOR x100/apply) -> FLIP blend -> blur phi

Everything runs under one ``jax.jit``: XLA program order replaces the
reference's dispatch-order synchronization, the old-grid snapshot is just a
value binding (no CopyResource), and the reference's 52 ms host prefix-sum
round-trip (Simulation.cpp:657) does not exist — particle->cell indexing is
one device-side sort (ops/celltable.py; ops/binning.py exposes the classic
counting-sort form).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.state import SimState
from ..ops.advect import advect_rk3
from ..ops.blur import blur_phi
from ..ops.extrapolate import extrapolate_one_ring
from ..ops.flip import flip_update
from ..ops.forces import add_gravity
from ..ops.levelset import compute_level_set
from ..ops.p2g import transfer_to_grid
from ..ops.project import project


def pic_flip_alpha(cfg: SimConfig, dt):
    """alpha = clamp(6*dt*nu*cpm^2, 0, 1) (Simulation.cpp:541)."""
    return jnp.clip(
        6.0 * dt * jnp.float32(cfg.nu * cfg.cells_per_meter**2), 0.0, 1.0
    )


def use_super_table(cfg: SimConfig) -> bool:
    """Whether the fast path bins at (2,2,1) supercell granularity
    (ops/supertable.py).  Supercell pooling wins when per-cell occupancy is
    low (ppc_axis == 1: one sort+gather per 4 cells, break-even P2G window
    work); at ppc_axis >= 2 the coarser windows read ~2x more slots per face
    than the per-cell table, so the per-cell path stays."""
    from ..ops.supertable import F

    return (
        cfg.particles_per_cell_axis == 1
        and cfg.nx % F[0] == 0
        and cfg.ny % F[1] == 0
        and cfg.nz % F[2] == 0
    )


@functools.partial(jax.jit, static_argnames=("cfg",))
def overflow_count(pos, cfg: SimConfig):
    """Particles past the dense table's slot budget at cfg's binning
    granularity (per-cell K or per-supercell Ks) — exactly what the bounded
    overflow fallback must cover for the fast path to be EXACT.  Standalone
    histogram over positions (no table build) so drivers can monitor
    fidelity cheaply; the reference needs no equivalent because its per-cell
    lists are unbounded (gpParticleIndexing.hlsli:28-45)."""
    from ..ops.common import cell_of

    pc = pos * jnp.array([cfg.nx, cfg.ny, cfg.nz], jnp.float32)
    cell = cell_of(pc)
    if use_super_table(cfg):
        from ..ops.supertable import F, _sdims, super_k

        sx, sy, sz = _sdims(cfg)
        k = super_k(cfg)
        lin = (
            (cell[:, 0] // F[0]) * sy + cell[:, 1] // F[1]
        ) * sz + cell[:, 2] // F[2]
        nbins = sx * sy * sz
    else:
        from ..ops.celltable import default_k

        k = default_k(cfg)
        lin = (cell[:, 0] * cfg.ny + cell[:, 1]) * cfg.nz + cell[:, 2]
        nbins = cfg.nx * cfg.ny * cfg.nz
    counts = jnp.zeros(nbins, jnp.int32).at[lin].add(1, mode="drop")
    return jnp.maximum(counts - k, 0).sum().astype(jnp.int32)


def overflow_autotune(
    cfg: SimConfig, n_overflow: int, floor: int = 4096
) -> SimConfig:
    """Size cfg.overflow_cap so the exact bounded fallback covers the
    OBSERVED overflow with 2x headroom (the worst 4-step clumping growth
    through the 64³/ppc2 slosh was ~1.6x — the headroom absorbs the
    check-cadence lag).  Power-of-4 tiers from ``floor``: each tier is
    a separate compiled program, so tiers are few and both jit and the
    persistent compile cache make revisits free — which is also why the
    policy is symmetric: after the slosh peak it steps back DOWN instead
    of paying the top tier's fallback price forever (the fallback's cost
    grows with the cap).  Returns cfg unchanged when the tier
    already matches."""
    import dataclasses

    cap = floor
    n = cfg.num_particles
    while cap < n and cap < 2 * int(n_overflow):
        cap *= 4
    cap = min(cap, n)
    if cap == cfg.overflow_cap:
        return cfg
    return dataclasses.replace(cfg, overflow_cap=cap)


def step(state: SimState, dt, cfg: SimConfig, fast: bool = True) -> SimState:
    """Advance the simulation by one (already clamped) dt.

    dt may be a traced scalar; cfg must be static.

    ``fast=True`` (default) uses the dense-table formulations — packed-row
    interpolation (core/interp_packed.py), the dense (super)cell particle
    table (ops/celltable.py, ops/supertable.py) for seeding + P2G, and the
    level-set sweeps of levelset.sweep_closest_fast; particles keep their
    original order (no per-step permutation).  ``fast=False`` runs the
    direct gather/scatter formulations (ops/p2g.py, ops/levelset.py), which
    mirror the NumPy twin op-for-op; both paths agree up to float
    reassociation and are cross-checked in tests.
    """
    from ..ops.celltable import (
        build_cell_table,
        p2g_from_table,
        seed_closest_from_table,
        seed_overflow_correction,
    )
    from ..ops.levelset import FAR, neighborhood_pass, sweep_closest_fast

    # Stage scopes name the device ops in profiler traces (advect, bin,
    # levelset, p2g, extrapolate, project, flip, blur).
    scope = jax.named_scope
    with scope("advect"):
        if fast and state.cache is not None:
            from ..ops.advect import advect_rk3_cached

            pos = advect_rk3_cached(cfg, state.cache, state.pos, dt)
        else:
            pos = advect_rk3(
                cfg, state.u, state.v, state.w, state.pos, dt, packed=fast
            )
    vel = state.vel

    if fast:
        if use_super_table(cfg):
            from ..ops.supertable import (
                build_super_table,
                p2g_from_super,
                seed_closest_from_super,
            )

            build, seed, p2g = (build_super_table, seed_closest_from_super,
                                p2g_from_super)
        else:
            build, seed, p2g = (build_cell_table, seed_closest_from_table,
                                p2g_from_table)
        with scope("bin"):
            table = build(cfg, pos, vel)
        with scope("levelset"):
            phi0, cpos0 = seed(cfg, table, FAR)
            phi0, cpos0 = seed_overflow_correction(cfg, table, pos, phi0, cpos0)
            phi, cpos = neighborhood_pass(cfg, cpos0)
            phi, _ = sweep_closest_fast(cfg, phi, cpos)
        with scope("p2g"):
            u, v, w, uv, vv, wv = p2g(cfg, table, pos, vel)
    else:
        with scope("levelset"):
            phi, _ = compute_level_set(cfg, pos)
        with scope("p2g"):
            u, v, w, uv, vv, wv = transfer_to_grid(cfg, pos, vel)

    with scope("extrapolate"):
        u = extrapolate_one_ring(u, uv)
        v = extrapolate_one_ring(v, vv)
        w = extrapolate_one_ring(w, wv)

    old_u, old_v, old_w = u, v, w  # snapshot (Simulation.cpp:529-531)

    with scope("project"):
        v = add_gravity(cfg, v, dt)
        u, v, w, _ = project(cfg, u, v, w, phi, dt)

    alpha = pic_flip_alpha(cfg, dt)
    # Cache discipline: a new AdvectCache is emitted exactly when the input
    # state carried one (structure-preserving, so lax.scan over steps works
    # for every (fast, cache) combination); a cache=None state steps to
    # bit-identical (pos, vel, grids, phi) via the uncached paths.
    with scope("flip"):
        if fast and state.cache is not None:
            from ..ops.flip import flip_update_carry

            vel, cache = flip_update_carry(
                cfg, pos, vel, u, v, w, old_u, old_v, old_w, alpha
            )
        else:
            vel = flip_update(
                cfg, pos, vel, u, v, w, old_u, old_v, old_w, alpha,
                packed=fast,
            )
            if state.cache is not None:
                from ..core.interp_packed import (
                    interp_mac3_packed_vec,
                    pack_mac3,
                )
                from ..core.state import AdvectCache

                pn = pack_mac3(u, v, w)
                m = jnp.array([cfg.nx, cfg.ny, cfg.nz], jnp.float32)
                k1 = interp_mac3_packed_vec(
                    *pn, (cfg.nx, cfg.ny, cfg.nz), pos * m
                )
                cache = AdvectCache(k1=k1, pu=pn[0], pv=pn[1], pw=pn[2])
            else:
                cache = None

    with scope("blur"):
        phi = blur_phi(phi)

    return SimState(pos=pos, vel=vel, u=u, v=v, w=w, phi=phi, cache=cache)


@functools.partial(jax.jit, static_argnames=("cfg", "fast"))
def step_jit(state: SimState, dt, cfg: SimConfig, fast: bool = True) -> SimState:
    return step(state, dt, cfg, fast)


@functools.partial(jax.jit, static_argnames=("cfg", "fast"))
def step_guarded(state: SimState, dt, cfg: SimConfig, fast: bool = True):
    """step() plus the reference's stability checks as a device-side flag
    (velocity-explosion assert Simulation3D.cpp:172-175 and NaN guards,
    SURVEY.md §5.2/§5.3): returns (new_state, healthy).  Callers decide the
    recovery policy — the reference's is the user-facing 'r' reset."""
    from ..utils.metrics import velocity_guard

    out = step(state, dt, cfg, fast)
    healthy = (
        velocity_guard(out.vel)
        & jax.numpy.isfinite(out.pos).all()
        & jax.numpy.isfinite(out.u).all()
    )
    return out, healthy


@functools.partial(jax.jit, static_argnames=("cfg", "n_steps", "fast"))
def simulate(state: SimState, dt, cfg: SimConfig, n_steps: int, fast: bool = True) -> SimState:
    """Advance n_steps under one compiled program (lax.scan over steps) —
    amortizes dispatch latency when no per-step host output is needed."""

    def body(s, _):
        return step(s, dt, cfg, fast), None

    out, _ = jax.lax.scan(body, state, None, length=n_steps)
    return out


def clamp_dt(cfg: SimConfig, dt, simulation_rate: float = 1.0):
    """dt clamp (Simulation.cpp:515): dt*rate clamped to [0, max_dt]."""
    return float(min(max(dt * simulation_rate, 0.0), cfg.max_dt))
