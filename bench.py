"""Benchmark: sim steps/sec at the north-star config (BASELINE.json).

Config: 900k-particle dam break on a 128^3 grid (the reference demo runs
953,312 particles at 64^3, README.md:15; BASELINE.json scales the target to
128^3 with ~900k particles -> 1 particle/cell in the dam-break block =
1,000,188 particles).  Baseline: the reference's 30 fps end-to-end rate.

Every run also measures the PHYSICAL config (the reference demo's seeding
density: ppc 2 -> 8M particles at 128^3, dt=1/120, overflow fallback
auto-tiered to exactness) so the recorded line always carries one number
with the reference's unbounded-transfer fidelity (gpParticleIndexing
.hlsli:28-45 has no cap).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

from __future__ import annotations

import json
import sys
import time

import jax
import numpy as np

from fluidsimulation.utils.cache import enable_compilation_cache

enable_compilation_cache()

from fluidsimulation.core.config import SimConfig
from fluidsimulation.core.state import init_state
from fluidsimulation.solver.step3d import (
    overflow_autotune,
    overflow_count,
    step_jit,
)


fetch = jax.block_until_ready


def measure_steps(cfg, dt, *, n_steps, n_rounds=3, autotune=False,
                  warmup=1):
    """Best-round steps/s for one config (compilation excluded)."""
    state = jax.device_put(init_state(cfg))
    state = step_jit(state, dt, cfg)
    fetch(state)
    for _ in range(warmup):
        state = step_jit(state, dt, cfg)
        if autotune:
            fetch(state)
            cfg = overflow_autotune(cfg, int(overflow_count(state.pos, cfg)))
    fetch(state)

    steps_per_sec = 0.0
    for _ in range(n_rounds):
        t0 = time.perf_counter()
        for _ in range(n_steps):
            state = step_jit(state, dt, cfg)
        fetch(state)
        elapsed = time.perf_counter() - t0
        steps_per_sec = max(steps_per_sec, n_steps / elapsed)
        if autotune:
            cfg = overflow_autotune(cfg, int(overflow_count(state.pos, cfg)))
    assert np.isfinite(np.asarray(state.vel)).all(), "NaN in benchmark run"
    return steps_per_sec, state, cfg


def main():
    physical_only = "--physical" in sys.argv[1:]
    grid = 128
    cfg = SimConfig(
        nx=grid, ny=grid, nz=grid,
        cells_per_meter=float(grid),
        # Throughput config: 63*126*126 = 1,000,188 particles (ppc 1).
        particles_per_cell_axis=1,
    )
    # Physical config: the reference demo's seeding density (ppc 2, 8M
    # particles) at dt=1/120 — holds volume (docs/PARITY.md) and runs with
    # the overflow fallback auto-tiered to exactness.
    cfg_phys = SimConfig(
        nx=grid, ny=grid, nz=grid,
        cells_per_meter=float(grid),
        particles_per_cell_axis=2,
    )

    if not physical_only:
        steps_per_sec, state, cfg = measure_steps(
            cfg, 1.0 / 60.0, n_steps=10
        )
        # Fidelity tag: fraction of particles past the dense table's slot
        # budget at the measured state — what the bounded fallback must
        # cover (covered exactly iff n_overflow <= cfg.overflow_cap; the
        # throughput config's collapsed state exceeds it by design,
        # docs/PARITY.md).
        n_over = int(overflow_count(state.pos, cfg))
        overflow_frac = n_over / cfg.num_particles
        overflow_exact = n_over <= cfg.overflow_cap

        # Render throughput at the same 128^3 phi (the reference's 30 fps
        # number includes DrawScene, FluidSimDemo.cpp:175-208): one 800x600
        # frame.
        from fluidsimulation.render.camera import OrbitCamera
        from fluidsimulation.render.raytrace import render_frame

        co, right, up, fwd = OrbitCamera().frame(800, 600)

        def draw(phi):
            return jax.block_until_ready(
                render_frame(phi, co, right, up, fwd,
                             width=800, height=600, band_rows=100))

        draw(state.phi)  # compile
        n_frames = 3
        render_s = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n_frames):
                img = draw(state.phi)
            render_s = min(render_s, (time.perf_counter() - t0) / n_frames)
        assert np.isfinite(np.asarray(img)).all(), "NaN in rendered frame"

        # Certified fast stack (opt-in modes): the
        # default sphere-trace march plus overstep omega=1.4 (enhanced
        # sphere tracing with certified backtracking; pixel bound ~3% px
        # > 1/255 on this scene, docs/PARITY.md).  Recorded so the fast-
        # mode capability is in the driver-captured JSON; the headline
        # render_ms_800x600 stays the exact-image-mode number.
        def draw_fast(phi):
            return jax.block_until_ready(
                render_frame(phi, co, right, up, fwd,
                             width=800, height=600, band_rows=100,
                             overstep=1.4))

        draw_fast(state.phi)  # compile
        render_fast_s = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(n_frames):
                img_f = draw_fast(state.phi)
            render_fast_s = min(
                render_fast_s, (time.perf_counter() - t0) / n_frames)
        assert np.isfinite(np.asarray(img_f)).all()

        sim_render_fps = 1.0 / (1.0 / steps_per_sec + render_s)

        # Interactive sim+render loop — the OPT-IN temporal mode
        # (app/demo.py --temporal): step, then draw with the frame's
        # water marches seeded from the previous frame's per-pixel ts
        # (raytrace t_seed; pixel-diff bound in docs/PARITY.md).  Recorded
        # alongside the exact-mode numbers so the interactive capability
        # is on the record; the headline
        # render_ms_800x600 stays exact-image-mode.
        def draw_seeded(phi, t_seed):
            return jax.block_until_ready(
                render_frame(phi, co, right, up, fwd,
                             width=800, height=600, band_rows=100,
                             t_seed=t_seed, return_t=True))

        _, t_prev = draw_seeded(state.phi, None)          # compile + seed
        draw_seeded(state.phi, t_prev)                    # compile seeded
        n_it = 5
        inter_s = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(n_it):
                state = step_jit(state, 1.0 / 60.0, cfg)
                img_i, t_prev = draw_seeded(state.phi, t_prev)
            inter_s = min(inter_s, (time.perf_counter() - t0) / n_it)
        assert np.isfinite(np.asarray(img_i)).all()
        interactive_fps = 1.0 / inter_s

        # Exact-fidelity HEADLINE config: continue the SAME collapsed state with the
        # overflow fallback auto-tiered until it covers it — at this
        # state the tier rises to num_particles, i.e. the transfer
        # matches the reference's unbounded per-cell lists exactly
        # (gpParticleIndexing.hlsli:28-45).  Slower by design; recorded
        # so the headline workload has a number at reference fidelity.
        ecfg, estate = cfg, state
        for _ in range(3):
            ecfg = overflow_autotune(
                ecfg, int(overflow_count(estate.pos, ecfg)))
            estate = step_jit(estate, 1.0 / 60.0, ecfg)
        fetch(estate)
        exact_sps = 0.0
        for _ in range(2):
            t0 = time.perf_counter()
            for _ in range(4):
                estate = step_jit(estate, 1.0 / 60.0, ecfg)
            fetch(estate)
            exact_sps = max(exact_sps, 4 / (time.perf_counter() - t0))
            ecfg = overflow_autotune(
                ecfg, int(overflow_count(estate.pos, ecfg)))
        exact_exact = (int(overflow_count(estate.pos, ecfg))
                       <= ecfg.overflow_cap)

    # Exact-fidelity physical config (always measured; the cache makes the
    # revisit cheap).  4 autotuned warmup steps let the overflow tier lock
    # in before timing, exactly like the demo's auto-tier cadence.
    phys_sps, phys_state, phys_cfg = measure_steps(
        cfg_phys, 1.0 / 120.0, n_steps=4, autotune=True, warmup=4
    )
    phys_over = int(overflow_count(phys_state.pos, phys_cfg))
    phys_exact = phys_over <= phys_cfg.overflow_cap

    if physical_only:
        print(json.dumps({
            "metric": f"sim_steps_per_sec_{grid}c_{cfg_phys.num_particles}p_physical",
            "value": round(phys_sps, 3),
            "unit": "steps/s",
            "vs_baseline": round(phys_sps / 30.0, 3),
            "overflow_exact": phys_exact,
        }))
        return

    name = f"sim_steps_per_sec_{grid}c_{cfg.num_particles}p"
    print(
        json.dumps(
            {
                "metric": name,
                "value": round(steps_per_sec, 3),
                "unit": "steps/s",
                "vs_baseline": round(steps_per_sec / 30.0, 3),
                "render_ms_800x600": round(1000.0 * render_s, 1),
                "render_fast_ms_800x600": round(1000.0 * render_fast_s, 1),
                "sim_render_fps": round(sim_render_fps, 3),
                "interactive_fps": round(interactive_fps, 3),
                "overflow_frac": round(overflow_frac, 4),
                "overflow_exact": overflow_exact,
                "exact_steps_per_sec": round(exact_sps, 3),
                "exact_overflow_cap": ecfg.overflow_cap,
                "exact_overflow_exact": exact_exact,
                "physical_steps_per_sec": round(phys_sps, 3),
                "physical_num_particles": cfg_phys.num_particles,
                "physical_overflow_exact": phys_exact,
            }
        )
    )


if __name__ == "__main__":
    sys.exit(main())
