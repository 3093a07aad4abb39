"""Per-stage profiling: the JAX equivalent of GPUProfiler (GPUProfiler.h:46).

The reference records 23 ordered pipeline marks with double-buffered D3D11
timestamp queries and prints a per-frame ms table (FluidSimDemo.cpp:211-236).
Here, profile mode runs each pipeline stage as its own blocked-on computation
and reports wall-clock per stage under the same mark names; normal mode runs
the whole fused step (one jit) and reports only totals.  Three of the
reference's marks (the host prefix-sum COPYMAP/WAIT/UNMAPUPDATE stages,
Simulation.cpp:660-686, measured at 52 ms/frame) are structurally eliminated
by the on-device cumsum and always report 0.
"""

from __future__ import annotations

import functools
import time
from typing import Callable

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.state import SimState

# Mark names mirror the GPUProfilerMark enum (GPUProfiler.h:16-44).
MARKS = [
    "ADVECT",
    "TRANSFERPTG_CLEARCOUNTS",
    "TRANSFERPTG_COUNTPARTICLES",
    "TRANSFERPTG_PREFIXSUM_COPYMAP",   # eliminated (on-device cumsum)
    "TRANSFERPTG_PREFIXSUM_WAIT",      # eliminated
    "TRANSFERPTG_PREFIXSUM_UNMAPUPDATE",  # eliminated
    "TRANSFERPTG_BIN",
    "TRANSFERPTG_LEVELSET_CLEAR",
    "TRANSFERPTG_LEVELSET_ZERO",
    "TRANSFERPTG_LEVELSET_SWEEP",
    "TRANSFERPTG_VELOCITY",
    "TRANSFERPTG_VELOCITY_EXTRAPOLATE",
    "FLIP_COPYVELOCITIES",
    "BODYFORCES",
    "PROJECT_RHS",
    "PROJECT_DIAGCOEFFS",
    "PROJECT_PCLEAR",
    "PROJECT_SOR",
    "PROJECT_TOVELOCITY",
    "FLIP_APPLY",
    "BLURLEVELSET",
    "DRAW",
    "END_FRAME",
]

# Short column headers, as in the reference's console table
# (FluidSimDemo.cpp:211).
SHORT = [
    "A", "TCC", "TCP", "TPC", "TPW", "TPMU", "TB", "TLC", "TLZ", "TLS",
    "TV", "TE", "FC", "B", "PR", "PD", "PP", "PS", "PTV", "FCV", "BLS",
    "D", "EF",
]


_block = jax.block_until_ready


class StageProfiler:
    """Collects per-stage seconds; DT(mark) mirrors GPUProfiler::DT."""

    def __init__(self):
        self.times: dict[str, float] = {m: 0.0 for m in MARKS}

    def timed(self, mark: str, fn: Callable, *args, **kwargs):
        t0 = time.perf_counter()
        out = _block(fn(*args, **kwargs))
        self.times[mark] = time.perf_counter() - t0
        return out

    def DT(self, mark: str) -> float:
        return self.times.get(mark, 0.0)

    def table(self) -> str:
        head = "GPU time:\t" + "\t".join(f"{s:<6}" for s in SHORT)
        vals = "GPU time:\t" + "\t".join(
            f"{1000.0 * self.times[m]:.2f}ms" for m in MARKS
        )
        return head + "\n" + vals


@functools.lru_cache(maxsize=None)
def _jitted_nostatic(fn):
    return jax.jit(fn)


@functools.lru_cache(maxsize=None)
def _jitted(fn):
    """Module-level jit cache: re-wrapping in jax.jit per call would
    recompile every profile_step invocation."""
    return jax.jit(fn, static_argnums=0)


@functools.lru_cache(maxsize=None)
def _jitted2(fn):
    """As _jitted, with the first two arguments static."""
    return jax.jit(fn, static_argnums=(0, 1))


def _bin_stage(cfg, use_super, pos, vel):
    if use_super:
        from ..ops import supertable

        return supertable.build_super_table(cfg, pos, vel)
    from ..ops import celltable

    return celltable.build_cell_table(cfg, pos, vel)


def _seed_stage(cfg, use_super, table, pos):
    from ..ops import celltable, levelset

    if use_super:
        from ..ops import supertable

        phi0, cpos0 = supertable.seed_closest_from_super(
            cfg, table, levelset.FAR
        )
    else:
        phi0, cpos0 = celltable.seed_closest_from_table(
            cfg, table, levelset.FAR
        )
    phi0, cpos0 = celltable.seed_overflow_correction(cfg, table, pos, phi0, cpos0)
    return levelset.neighborhood_pass(cfg, cpos0)


def _p2g_stage(cfg, use_super, table, pos, vel):
    if use_super:
        from ..ops import supertable

        return supertable.p2g_from_super(cfg, table, pos, vel)
    from ..ops import celltable

    return celltable.p2g_from_table(cfg, table, pos, vel)


def profile_step(
    state: SimState, dt, cfg: SimConfig, render_fn=None, fast: bool = True
) -> tuple[SimState, StageProfiler]:
    """Run one step stage-by-stage with per-stage timing.

    Stage boundaries follow GPFluidSim::Simulate's TimestampComplete calls
    (Simulation.cpp:513-566), and each stage runs the SAME formulation the
    fused step picks (table kind, sweep kernel), so attribution matches
    reality.
    Because stages are separately dispatched (and each timed fetch pays the
    host round-trip), the totals here exceed the fused-step time — use for
    relative attribution, like the reference's RenderDoc captures.

    ``render_fn(state) -> image``, if given, is timed as DRAW — the
    reference's 30 fps number includes DrawScene (FluidSimDemo.cpp:175-208).
    END_FRAME times the final full-state fetch (the reference's blocking
    profiler collect, GPUProfiler.cpp:49-84).
    """
    from ..ops import advect, blur, extrapolate, flip, forces, levelset, project
    from ..solver.step3d import pic_flip_alpha, use_super_table

    prof = StageProfiler()
    dt = jnp.float32(dt)
    use_super = fast and use_super_table(cfg)

    if fast and state.cache is not None:
        # Time the kernel the fused fast step actually runs: cached advect
        # (stage 1 from the carried k1, stages 2/3 from the fat tables).
        pos = prof.timed(
            "ADVECT", _jitted(advect.advect_rk3_cached),
            cfg, state.cache, state.pos, dt,
        )
    else:
        pos = prof.timed(
            "ADVECT", _jitted(advect.advect_rk3),
            cfg, state.u, state.v, state.w, state.pos, dt,
        )
    vel = state.vel
    # The dense (super)cell table subsumes the reference's count/prefix-sum/
    # bin trio (no host round trip, no atomics).
    table = prof.timed(
        "TRANSFERPTG_BIN", _jitted2(_bin_stage),
        cfg, use_super, pos, vel,
    )
    phi0, cpos0 = prof.timed(
        "TRANSFERPTG_LEVELSET_ZERO", _jitted2(_seed_stage),
        cfg, use_super, table, pos,
    )
    phi, _ = prof.timed(
        "TRANSFERPTG_LEVELSET_SWEEP", _jitted(levelset.sweep_closest_fast),
        cfg, phi0, cpos0,
    )
    u, v, w, uv, vv, wv = prof.timed(
        "TRANSFERPTG_VELOCITY", _jitted2(_p2g_stage),
        cfg, use_super, table, pos, vel,
    )
    ex = _jitted_nostatic(extrapolate.extrapolate_one_ring)
    u = prof.timed("TRANSFERPTG_VELOCITY_EXTRAPOLATE", lambda: (ex(u, uv)))
    v = _block(ex(v, vv))
    w = _block(ex(w, wv))
    old_u, old_v, old_w = u, v, w
    v = prof.timed(
        "BODYFORCES", _jitted(forces.add_gravity), cfg, v, dt
    )
    b = prof.timed(
        "PROJECT_RHS", _jitted(project.compute_rhs),
        cfg, u, v, w, dt,
    )
    diag = prof.timed(
        "PROJECT_DIAGCOEFFS", _jitted(project.compute_diag),
        cfg, phi,
    )
    p = prof.timed(
        "PROJECT_SOR", _jitted(project.sor_pressure),
        cfg, phi, diag, b,
    )
    u, v, w = prof.timed(
        "PROJECT_TOVELOCITY", _jitted(project.apply_pressure),
        cfg, u, v, w, p, phi, dt,
    )
    alpha = pic_flip_alpha(cfg, dt)
    if fast and state.cache is not None:
        vel, cache = prof.timed(
            "FLIP_APPLY", _jitted(flip.flip_update_carry),
            cfg, pos, vel, u, v, w, old_u, old_v, old_w, alpha,
        )
    else:
        vel = prof.timed(
            "FLIP_APPLY", _jitted(flip.flip_update),
            cfg, pos, vel, u, v, w, old_u, old_v, old_w, alpha,
        )
        cache = None
    phi = prof.timed("BLURLEVELSET", _jitted_nostatic(blur.blur_phi), phi)

    new_state = SimState(pos=pos, vel=vel, u=u, v=v, w=w, phi=phi, cache=cache)
    if render_fn is not None:
        prof.timed("DRAW", render_fn, new_state)
    prof.timed("END_FRAME", lambda: new_state)
    return new_state, prof


def _apic_seed_stage(cfg, table, pos):
    from ..ops.apic_super import ApicSuperTable
    from ..ops.celltable import seed_closest_from_table, seed_overflow_correction
    from ..ops.levelset import FAR, neighborhood_pass

    if isinstance(table, ApicSuperTable):
        from ..ops.supertable import seed_closest_from_super

        phi0, cpos0 = seed_closest_from_super(cfg, table, FAR)
    else:
        phi0, cpos0 = seed_closest_from_table(cfg, table, FAR)
    phi0, cpos0 = seed_overflow_correction(cfg, table, pos, phi0, cpos0)
    return neighborhood_pass(cfg, cpos0)


def profile_step_apic(state, dt, cfg: SimConfig, render_fn=None):
    """profile_step for the APIC extension stepper (solver/apic.py):
    the same 23 mark names, with the APIC pipeline's stages mapped onto
    them (TRANSFERPTG_BIN = the 16-field table build, TRANSFERPTG_VELOCITY
    = the fused spline-window P2G, FLIP_APPLY = the packed APIC G2P; the
    FLIP old-grid snapshot mark FLIP_COPYVELOCITIES reports 0 — APIC has
    no old-grid).  Stage routing matches step_apic(fast=True) exactly."""
    from ..ops import blur, extrapolate, forces, project
    from ..ops.advect import advect_rk3_pic
    from ..ops.apic import (
        build_apic_table,
        g2p_apic_packed,
        p2g_apic_from_table_fused,
    )
    from ..ops.apic_super import (
        build_apic_super_table,
        p2g_apic_from_super_fused,
    )
    from ..ops.levelset import sweep_closest_fast
    from ..solver.apic import ApicState
    from ..solver.step3d import use_super_table

    prof = StageProfiler()
    dt = jnp.float32(dt)
    use_super = use_super_table(cfg)
    build = build_apic_super_table if use_super else build_apic_table
    p2g_fused = (p2g_apic_from_super_fused if use_super
                 else p2g_apic_from_table_fused)

    pos = prof.timed(
        "ADVECT", _jitted(advect_rk3_pic),
        cfg, state.u, state.v, state.w, state.pos, state.vel, dt,
    )
    table = prof.timed(
        "TRANSFERPTG_BIN", _jitted(build),
        cfg, pos, state.vel, state.C,
    )
    phi0, cpos0 = prof.timed(
        "TRANSFERPTG_LEVELSET_ZERO", _jitted(_apic_seed_stage),
        cfg, table, pos,
    )
    phi, _ = prof.timed(
        "TRANSFERPTG_LEVELSET_SWEEP", _jitted(sweep_closest_fast),
        cfg, phi0, cpos0,
    )
    u, v, w, uv, vv, wv = prof.timed(
        "TRANSFERPTG_VELOCITY", _jitted(p2g_fused),
        cfg, table, pos, state.vel, state.C,
    )
    ex = _jitted_nostatic(extrapolate.extrapolate_one_ring)
    u = prof.timed("TRANSFERPTG_VELOCITY_EXTRAPOLATE", lambda: (ex(u, uv)))
    v = _block(ex(v, vv))
    w = _block(ex(w, wv))
    v = prof.timed("BODYFORCES", _jitted(forces.add_gravity), cfg, v, dt)
    b = prof.timed(
        "PROJECT_RHS", _jitted(project.compute_rhs), cfg, u, v, w, dt
    )
    diag = prof.timed(
        "PROJECT_DIAGCOEFFS", _jitted(project.compute_diag), cfg, phi
    )
    p = prof.timed(
        "PROJECT_SOR", _jitted(project.sor_pressure), cfg, phi, diag, b
    )
    u, v, w = prof.timed(
        "PROJECT_TOVELOCITY", _jitted(project.apply_pressure),
        cfg, u, v, w, p, phi, dt,
    )
    vel, C = prof.timed(
        "FLIP_APPLY", _jitted(g2p_apic_packed), cfg, pos, u, v, w
    )
    phi = prof.timed("BLURLEVELSET", _jitted_nostatic(blur.blur_phi), phi)

    new_state = ApicState(pos=pos, vel=vel, C=C, u=u, v=v, w=w, phi=phi)
    if render_fn is not None:
        prof.timed("DRAW", render_fn, new_state)
    prof.timed("END_FRAME", lambda: new_state)
    return new_state, prof
