"""Generate the 128^3 golden step fingerprint (tests/test_golden128.py).
Stores a compact fingerprint of the state after 2 steps at the north-star
config: strided phi/u slices + summary stats.  The regression test compares
loosely (cross-backend fp-reassociation tolerance), so the golden may come
from an accelerator run while the test runs on the CPU."""
import os
import sys

sys.path.insert(0, ".")
import jax
import jax.numpy as jnp
import numpy as np

from fluidsimulation.core.config import SimConfig
from fluidsimulation.core.state import init_state
from fluidsimulation.solver.step3d import step_jit

CFG = SimConfig(nx=128, ny=128, nz=128, cells_per_meter=128.0,
                particles_per_cell_axis=1)


def fingerprint(state):
    return {
        "phi_slice": np.asarray(state.phi[::16, ::16, ::16]),
        "u_slice": np.asarray(state.u[::16, ::16, ::16]),
        "pos_head": np.asarray(state.pos[:256]),
        "vel_mean_abs": np.float64(jnp.abs(state.vel).mean()),
        "phi_mean": np.float64(state.phi.mean()),
    }


def main():
    state = init_state(CFG)
    for _ in range(2):
        state = step_jit(state, 1.0 / 60.0, CFG)
    jax.block_until_ready(state.pos)
    out = fingerprint(state)
    path = os.path.join("tests", "golden", "step128_r2.npz")
    np.savez_compressed(path, **out)
    print("wrote", path, {k: (v.shape if hasattr(v, "shape") else v)
                          for k, v in out.items()})


if __name__ == "__main__":
    main()
