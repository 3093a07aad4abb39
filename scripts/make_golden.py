"""Regenerate golden test data (run on CPU for platform stability)."""
import os, sys
sys.path.insert(0, ".")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from fluidsimulation.core.config import SimConfig
from fluidsimulation.core.state import init_state
from fluidsimulation.solver.step3d import step_jit

CFG = SimConfig(nx=16, ny=16, nz=16, cells_per_meter=16.0)
state = step_jit(init_state(CFG), 0.01, CFG)
out = {k: np.asarray(getattr(state, k)) for k in ("pos", "vel", "u", "v", "w", "phi")}
path = os.path.join("tests", "golden", "step16_r1.npz")
np.savez_compressed(path, **out)
print("wrote", path)

# Golden rendered frame (tiny, CPU-deterministic).
from fluidsimulation.render.camera import OrbitCamera
from fluidsimulation.render.raytrace import render

cam = OrbitCamera()
co, right, up, fwd = cam.frame(48, 36)
img = np.asarray(render(state.phi, co, right, up, fwd, 48, 36))
np.savez_compressed(os.path.join("tests", "golden", "frame16_r1.npz"), img=img)
print("wrote tests/golden/frame16_r1.npz")
