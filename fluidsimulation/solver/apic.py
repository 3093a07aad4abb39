"""APIC stepper — the PIC/FLIP pipeline with the transfer pair swapped.

Extension model family (the reference ships PIC/FLIP only; see
ops/apic.py for the method and design notes).  Stage order follows
`GPFluidSim::Simulate` (Simulation.cpp:513-566) exactly, with two
substitutions: P2G carries the affine term (ops/apic.py::p2g_apic) and
the particle update is the APIC G2P (pure-PIC velocities + affine rows)
instead of the FLIP blend — APIC needs no old-grid snapshot.

State is `ApicState` (SimState fields + C), its own pytree so the
existing SimState paths (checkpoint, halo step, demo) are untouched.
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.state import init_state
from ..ops.advect import advect_rk3_pic
from ..ops.blur import blur_phi
from ..ops.apic import g2p_apic, g2p_apic_packed, p2g_apic
from ..ops.extrapolate import extrapolate_one_ring
from ..ops.forces import add_gravity
from ..ops.levelset import compute_level_set
from ..ops.project import project


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class ApicState:
    pos: jax.Array  # (N, 3) meters
    vel: jax.Array  # (N, 3) m/s
    C: jax.Array    # (N, 3, 3) 1/s — affine rows per component
    u: jax.Array
    v: jax.Array
    w: jax.Array
    phi: jax.Array


def init_apic_state(cfg: SimConfig) -> ApicState:
    """Reference dam-break seeding (core/state.py) with C = 0."""
    s = init_state(cfg)
    n = s.pos.shape[0]
    return ApicState(
        pos=s.pos, vel=s.vel, C=jnp.zeros((n, 3, 3), jnp.float32),
        u=s.u, v=s.v, w=s.w, phi=s.phi,
    )


def step_apic(state: ApicState, dt, cfg: SimConfig,
              fast: bool = True) -> ApicState:
    """One APIC step (dt already clamped; cfg static).

    fast=True routes G2P through the packed 9x32-row gather
    (ops/apic.py::g2p_apic_packed) and P2G through the dense spline
    windows over the 16-field slot table (p2g_apic_from_table) — both
    equality-tested vs the oracle pair (fast=False).

    Advection is RK3 with stage 1 = state.vel (ops/advect.py::
    advect_rk3_pic): APIC's particle velocity IS the spline sample of
    state's grids at state.pos, so the stage-1 gather is free.  Both
    paths use it, so fast == slow equality is unaffected."""
    pos = advect_rk3_pic(cfg, state.u, state.v, state.w, state.pos,
                         state.vel, dt)
    if fast:
        from ..ops.celltable import seed_overflow_correction
        from ..ops.levelset import FAR, neighborhood_pass, sweep_closest_fast
        from .step3d import use_super_table

        use_super = use_super_table(cfg)
        if use_super:
            # ppc_axis == 1: bin at (2,2,1) supercell granularity like the
            # FLIP fast path — table 2.5x smaller, 4x fewer build-gather
            # rows, ~0.67x P2G window volume (ops/apic_super.py).
            from ..ops.apic_super import build_apic_super_table
            from ..ops.supertable import seed_closest_from_super

            table = build_apic_super_table(cfg, pos, state.vel, state.C)
            phi0, cpos0 = seed_closest_from_super(cfg, table, FAR)
        else:
            from ..ops.apic import build_apic_table
            from ..ops.celltable import seed_closest_from_table

            table = build_apic_table(cfg, pos, state.vel, state.C)
            # Level set from the SAME table (fields 0-2/6 are layout-shared
            # with CellTable): replaces the direct 27-neighborhood seed.
            phi0, cpos0 = seed_closest_from_table(cfg, table, FAR)
        phi0, cpos0 = seed_overflow_correction(cfg, table, pos, phi0, cpos0)
        phi, cpos = neighborhood_pass(cfg, cpos0)
        phi, _ = sweep_closest_fast(cfg, phi, cpos)
        if use_super:
            from ..ops.apic_super import p2g_apic_from_super_fused

            u, v, w, uv, vv, wv = p2g_apic_from_super_fused(
                cfg, table, pos, state.vel, state.C
            )
        else:
            from ..ops.apic import p2g_apic_from_table_fused

            # Union-window fused form: bit-identical to the unfused
            # windows with 54 instead of 108 window reads.
            u, v, w, uv, vv, wv = p2g_apic_from_table_fused(
                cfg, table, pos, state.vel, state.C
            )
    else:
        phi, _ = compute_level_set(cfg, pos)
        u, v, w, uv, vv, wv = p2g_apic(cfg, pos, state.vel, state.C)
    # One ring like the reference: sufficient by construction — the same
    # spline weights define both transfer directions, so every face G2P
    # reads with nonzero weight was itself P2G-weighted (valid); a 2-ring
    # variant (ops/apic.py::extrapolate_rings) measured bit-identical
    # spinning-ball L_y decay.
    u = extrapolate_one_ring(u, uv)
    v = extrapolate_one_ring(v, vv)
    w = extrapolate_one_ring(w, wv)
    v = add_gravity(cfg, v, dt)
    u, v, w, _ = project(cfg, u, v, w, phi, dt)
    g2p = g2p_apic_packed if fast else g2p_apic
    vel, C = g2p(cfg, pos, u, v, w)
    # Cosmetic pre-render blur like the reference/FLIP step (gpBlur).
    phi = blur_phi(phi)
    return ApicState(pos=pos, vel=vel, C=C, u=u, v=v, w=w, phi=phi)


step_apic_jit = jax.jit(step_apic, static_argnames=("cfg", "fast"))
