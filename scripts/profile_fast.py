"""Per-stage profile of the FAST path (the kernels the fused step actually
runs) on the live backend, plus the fused-step and render times.

Usage: python scripts/profile_fast.py [grid] [--render]
"""

import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from fluidsimulation.utils.cache import enable_compilation_cache

enable_compilation_cache()

from fluidsimulation.core.config import SimConfig
from fluidsimulation.core.state import init_state
from fluidsimulation.solver.step3d import step_jit
from fluidsimulation.utils.profiling import MARKS, profile_step


fetch = jax.block_until_ready


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    grid = int(args[0]) if args else 128
    do_render = "--render" in sys.argv
    ppc = 1 if grid >= 128 else 2
    dt_v = 1 / 60
    for a in sys.argv[1:]:
        if a.startswith("--ppc="):
            ppc = int(a.split("=")[1])
        if a.startswith("--dt="):  # e.g. --dt=1/120
            num, den = a.split("=")[1].split("/")
            dt_v = float(num) / float(den)
    cfg = SimConfig(
        nx=grid, ny=grid, nz=grid, cells_per_meter=float(grid),
        particles_per_cell_axis=ppc,
    )
    print(f"backend {jax.default_backend()}, grid {grid}^3, "
          f"particles {cfg.num_particles}, dt {dt_v:.5f}")
    dt = jnp.float32(dt_v)
    state = jax.device_put(init_state(cfg))

    # Advance a few fused steps first so the profiled state is "typical".
    state = step_jit(state, dt, cfg)
    fetch(state)
    t0 = time.perf_counter()
    for _ in range(5):
        state = step_jit(state, dt, cfg)
    fetch(state)
    fused_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"fused step: {fused_ms:.1f} ms")

    render_fn = None
    if do_render:
        from fluidsimulation.render.camera import OrbitCamera
        from fluidsimulation.render.raytrace import render

        co, right, up, fwd = OrbitCamera().frame(800, 600)

        def render_fn(s):
            img = render(s.phi, co, right, up, fwd, 800, 600, band_rows=64)
            fetch(img)
            return img

        # warm the render compile outside the timed stage
        render_fn(state)

    # Run twice: first profile pass pays per-stage compiles, second is timing.
    for _ in range(2):
        out, prof = profile_step(state, dt, cfg, render_fn=render_fn)
    total = sum(prof.times.values())
    print(prof.table())
    print("\nstage breakdown (ms, sorted):")
    for m in sorted(MARKS, key=lambda m: -prof.times[m]):
        t = prof.times[m] * 1e3
        if t > 0.005:
            print(f"  {m:36s} {t:9.2f}  ({100*prof.times[m]/total:4.1f}%)")
    print(f"  {'SUM':36s} {total*1e3:9.2f}")


if __name__ == "__main__":
    main()
