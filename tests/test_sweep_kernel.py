"""The Triton level-set sweep kernel (ops/pallas_sweep.py) in interpret
mode against the XLA scans, and the gate that picks between them."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fluidsimulation.core.config import SimConfig
from fluidsimulation.ops import levelset
from fluidsimulation.ops.pallas_sweep import _sweep, sweep_closest_pallas

SHAPES = [(16, 16, 16), (12, 20, 36)]  # cubic; non-cubic, not powers of 2


def _cfg(dims):
    return SimConfig(nx=dims[0], ny=dims[1], nz=dims[2],
                     cells_per_meter=float(dims[0]))


@functools.lru_cache(maxsize=None)
def _seeded(dims):
    """A sparse random candidate field after the 27-neighbourhood pass."""
    rng = np.random.default_rng(sum(dims))
    hit = rng.random(dims + (1,)) < 0.05
    cand = np.where(hit, rng.random(dims + (3,)) * np.array(dims),
                    levelset.FAR).astype(np.float32)
    return levelset.neighborhood_pass(_cfg(dims), jnp.asarray(cand))


# The distance is one float32 sqrt of a 3-term sum; the kernel and XLA may
# round it differently by an ulp, never more (values stay below ~40 cells).
PHI_ATOL = 1e-5


@pytest.mark.parametrize("dims", SHAPES)
@pytest.mark.parametrize("code", range(6), ids=["xm", "xp", "ym", "yp", "zm", "zp"])
def test_sweep_kernel_direction_matches_scan(dims, code):
    axis, reverse = levelset._CODE[code]
    cfg = _cfg(dims)
    phi, cpos = _seeded(dims)
    want_phi, want_cpos = levelset._sweep_axis(
        phi, cpos, jnp.float32(cfg.particle_radius), axis, reverse)
    fields = (phi.reshape(-1),) + tuple(cpos[..., i].reshape(-1)
                                        for i in range(3))
    out = _sweep(fields, dims, axis, reverse, float(cfg.particle_radius),
                 interpret=True)
    got_cpos = np.stack([np.asarray(o).reshape(dims) for o in out[1:]], -1)
    np.testing.assert_array_equal(got_cpos, np.asarray(want_cpos))
    np.testing.assert_allclose(np.asarray(out[0]).reshape(dims),
                               np.asarray(want_phi), rtol=0, atol=PHI_ATOL)


def test_all_24_sweeps_match_sweep_closest():
    dims = SHAPES[1]
    cfg = _cfg(dims)
    phi, cpos = _seeded(dims)
    want_phi, want_cpos = levelset.sweep_closest(cfg, phi, cpos)
    got_phi, got_cpos = sweep_closest_pallas(cfg, phi, cpos, interpret=True)
    np.testing.assert_array_equal(np.asarray(got_cpos), np.asarray(want_cpos))
    np.testing.assert_allclose(np.asarray(got_phi), np.asarray(want_phi),
                               rtol=0, atol=PHI_ATOL)


def test_sweep_kernel_rejects_mismatched_grid():
    cfg = _cfg((8, 8, 8))
    with pytest.raises(ValueError):
        sweep_closest_pallas(cfg, jnp.zeros((8, 8, 4)),
                             jnp.zeros((8, 8, 4, 3)), interpret=True)


@pytest.mark.parametrize("platform,kernel", [("cpu", False), ("cuda", True)])
def test_gate_picks_kernel_only_for_cuda(platform, kernel):
    """sweep_closest_fast lowers to the Triton kernels for an NVIDIA GPU and
    to the scans elsewhere, whatever the default backend and device count
    (the suite runs with 8 virtual CPU devices)."""
    assert len(jax.devices()) == 8
    cfg = _cfg((8, 8, 8))
    phi, cpos = jnp.zeros((8, 8, 8)), jnp.zeros((8, 8, 8, 3))
    text = (jax.jit(functools.partial(levelset.sweep_closest_fast, cfg))
            .trace(phi, cpos).lower(lowering_platforms=(platform,)).as_text())
    assert ("levelset_sweep_xm" in text) == kernel
    assert ("stablehlo.while" in text) == (not kernel)


def test_fast_step_lowers_with_kernel_for_cuda():
    from fluidsimulation.core.state import init_state
    from fluidsimulation.solver.step3d import step_jit

    cfg = _cfg((16, 16, 16))
    text = (step_jit.trace(init_state(cfg), 0.01, cfg)
            .lower(lowering_platforms=("cuda",)).as_text())
    for name in ("xm", "xp", "ym", "yp", "zm", "zp"):
        assert f"levelset_sweep_{name}" in text
