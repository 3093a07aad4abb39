"""Soak test: run the dam break for many steps on the live backend and
check stability invariants (no NaN, bounded velocity, mass/particle bounds,
post-projection divergence)."""
import sys, time
sys.path.insert(0, ".")
import jax
import jax.numpy as jnp
import numpy as np
from fluidsimulation.core.config import SimConfig
from fluidsimulation.core.state import init_state
from fluidsimulation.solver.step3d import step_jit, step_guarded
from fluidsimulation.ops.levelset import compute_level_set
from fluidsimulation.reference.solver3d import divergence_stats

def main(grid=64, steps=200, dt=1/60):
    cfg = SimConfig(nx=grid, ny=grid, nz=grid, cells_per_meter=float(grid),
                    particles_per_cell_axis=1 if grid >= 128 else 2)
    s = jax.device_put(init_state(cfg))
    t0 = time.perf_counter()
    for i in range(steps):
        s, ok = step_guarded(s, dt, cfg)
        if i % 50 == 0 or i == steps - 1:
            vmax = float(jnp.abs(s.vel).max())
            ymean = float(s.pos[:, 1].mean())
            print(f"step {i}: healthy={bool(ok)} |v|max={vmax:.3f} y_mean={ymean:.4f}")
            assert bool(ok), "anomaly"
    el = time.perf_counter() - t0
    print(f"{steps} steps in {el:.1f}s = {steps/el:.2f} steps/s")
    phi, _ = jax.jit(compute_level_set, static_argnums=0)(cfg, s.pos)
    l2, mx, _ = divergence_stats(cfg, np.asarray(s.u), np.asarray(s.v), np.asarray(s.w), np.asarray(phi))
    print(f"final divergence: L2={l2:.4f} max={mx:.2e}  (reference 64^3 max: 6.65e-3)")

if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 64,
         int(sys.argv[2]) if len(sys.argv) > 2 else 200,
         float(sys.argv[3]) if len(sys.argv) > 3 else 1 / 60)
