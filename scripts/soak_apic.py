"""APIC soak on the live backend: many steps through the shipped fast
path (the supercell table at ppc1 configs since round 4), checking
stability invariants — no NaN, bounded velocity and affine rows, volume
(y_mean), and the overflow fidelity count.

Usage: python scripts/soak_apic.py [grid] [steps] [dt]
(defaults 128 200 1/60 — the flagship APIC config on the new path).
"""
import sys
import time

sys.path.insert(0, ".")

from fluidsimulation.utils.cache import enable_compilation_cache

enable_compilation_cache()

import jax
import jax.numpy as jnp

from fluidsimulation.core.config import SimConfig
from fluidsimulation.solver.apic import init_apic_state, step_apic_jit
from fluidsimulation.solver.step3d import (
    clamp_dt,
    overflow_autotune,
    overflow_count,
    use_super_table,
)


def main(grid=128, steps=200, dt_frame=1 / 60):
    cfg = SimConfig(nx=grid, ny=grid, nz=grid, cells_per_meter=float(grid),
                    particles_per_cell_axis=1 if grid >= 128 else 2)
    print(f"backend {jax.default_backend()}  grid {grid}^3  "
          f"ppc {cfg.particles_per_cell_axis}  n {cfg.num_particles}  "
          f"super_table {use_super_table(cfg)}", flush=True)
    dt = clamp_dt(cfg, dt_frame, simulation_rate=0.5)
    s = jax.device_put(init_apic_state(cfg))
    t0 = time.perf_counter()
    for i in range(steps):
        s = step_apic_jit(s, dt, cfg)
        if i % 4 == 3:
            n_over = int(overflow_count(s.pos, cfg))
            new_cfg = overflow_autotune(cfg, n_over)
            if new_cfg is not cfg:
                print(f"step {i}: overflow autotune n={n_over} -> cap "
                      f"{new_cfg.overflow_cap}", flush=True)
                cfg = new_cfg
        if i % 25 == 0 or i == steps - 1:
            vmax = float(jnp.abs(s.vel).max())
            cmax = float(jnp.abs(s.C).max())
            ymean = float(s.pos[:, 1].mean())
            finite = bool(jnp.isfinite(s.vel).all()) and bool(
                jnp.isfinite(s.C).all())
            print(f"step {i}: finite={finite} |v|max={vmax:.3f} "
                  f"|C|max={cmax:.1f} y_mean={ymean:.4f}", flush=True)
            assert finite and vmax < 50.0, "anomaly"
    el = time.perf_counter() - t0
    print(f"{steps} steps in {el:.1f}s = {steps / el:.2f} steps/s "
          f"(incl. compiles/retiers)", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 128,
         int(sys.argv[2]) if len(sys.argv) > 2 else 200,
         float(sys.argv[3]) if len(sys.argv) > 3 else 1 / 60)
