"""Kernels compiled for the GPU: run only on a machine with an NVIDIA GPU.

The CPU suite checks the Triton sweep kernel in interpret mode
(tests/test_sweep_kernel.py); these tests compile it for the card, and the
fused step around it.  Run them on the card with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/

(``python chip_smoke.py`` does so as one of its phases).
"""

import numpy as np
import pytest

import jax

from fluidsimulation.core.config import SimConfig
from fluidsimulation.core.state import init_state

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")
    return jax.devices()[0]


@pytest.mark.parametrize("dims", [(16, 16, 16), (12, 20, 36)])
def test_sweep_kernel_compiles_and_matches_scans(gpu, dims):
    from fluidsimulation.ops import levelset
    from fluidsimulation.ops.pallas_sweep import sweep_closest_pallas

    cfg = SimConfig(nx=dims[0], ny=dims[1], nz=dims[2],
                    cells_per_meter=float(dims[0]))
    state = init_state(cfg)
    phi0, cpos0 = levelset.seed_closest(cfg, state.pos)
    want_phi, want_cpos = levelset.sweep_closest(cfg, phi0, cpos0)
    got_phi, got_cpos = jax.jit(
        lambda p, c: sweep_closest_pallas(cfg, p, c))(phi0, cpos0)
    np.testing.assert_array_equal(np.asarray(got_cpos), np.asarray(want_cpos))
    np.testing.assert_allclose(np.asarray(got_phi), np.asarray(want_phi),
                               rtol=0, atol=1e-5)


def test_fused_step_runs_with_kernel(gpu):
    """The fast step compiles with the sweep kernel in it and stays
    finite over a few steps."""
    from fluidsimulation.solver.step3d import step_jit

    cfg = SimConfig(nx=16, ny=16, nz=16, cells_per_meter=16.0)
    state = init_state(cfg)
    hlo = step_jit.lower(state, 0.01, cfg).as_text()
    assert "levelset_sweep" in hlo
    for _ in range(3):
        state = step_jit(state, 0.01, cfg)
    for name in ("pos", "vel", "u", "v", "w", "phi"):
        assert np.isfinite(np.asarray(getattr(state, name))).all(), name
