"""128^3 north-star-config golden fingerprint.

The golden was generated on an accelerator (scripts/make_golden128.py); the CPU
suite runs the XLA op formulations instead of the Pallas kernels, so
tolerances are cross-backend/fp-reassociation loose.  This is a SLOW test
(two 128^3 steps on CPU, ~4 min): marked so `-m "not slow"` can skip it.
"""

import os

import numpy as np
import pytest

from fluidsimulation.core.config import SimConfig
from fluidsimulation.core.state import init_state
from fluidsimulation.solver.step3d import step_jit

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "step128_r2.npz")

CFG = SimConfig(nx=128, ny=128, nz=128, cells_per_meter=128.0,
                particles_per_cell_axis=1)


@pytest.mark.slow
def test_golden_step128():
    if not os.path.exists(GOLDEN):
        pytest.skip("golden fingerprint not generated")
    state = init_state(CFG)
    for _ in range(2):
        state = step_jit(state, 1.0 / 60.0, CFG)
    with np.load(GOLDEN) as z:
        np.testing.assert_allclose(
            np.asarray(state.pos[:256]), z["pos_head"], atol=5e-5,
            err_msg="particle positions diverged from the 128^3 golden",
        )
        np.testing.assert_allclose(
            np.asarray(state.phi[::16, ::16, ::16]), z["phi_slice"],
            atol=5e-3, err_msg="phi diverged",
        )
        np.testing.assert_allclose(
            np.asarray(state.u[::16, ::16, ::16]), z["u_slice"],
            atol=5e-3, err_msg="u diverged",
        )
        assert abs(float(np.abs(np.asarray(state.vel)).mean())
                   - float(z["vel_mean_abs"])) < 1e-4
