"""Checkpoint/resume + TSV debug IO + golden-data regression."""

import os

import numpy as np

from fluidsimulation.core.config import SimConfig
from fluidsimulation.core.state import init_state
from fluidsimulation.solver.step3d import step_jit
from fluidsimulation.utils import checkpoint as cp

CFG = SimConfig(nx=16, ny=16, nz=16, cells_per_meter=16.0)
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "step16_r1.npz")


def test_npz_roundtrip(tmp_path):
    state = init_state(CFG)
    state = step_jit(state, 0.01, CFG)
    path = str(tmp_path / "state.npz")
    cp.save_state(path, state, CFG)
    loaded = cp.load_state(path)
    for k in ("pos", "vel", "u", "v", "w", "phi"):
        np.testing.assert_array_equal(
            np.asarray(getattr(state, k)), np.asarray(getattr(loaded, k))
        )


def test_resume_continues_identically(tmp_path):
    """save -> load -> step == step twice (determinism by construction,
    SURVEY.md §4.7)."""
    s0 = init_state(CFG)
    s1 = step_jit(s0, 0.01, CFG)
    path = str(tmp_path / "s1.npz")
    cp.save_state(path, s1)
    s2a = step_jit(s1, 0.01, CFG)
    s2b = step_jit(cp.load_state(path), 0.01, CFG)
    np.testing.assert_array_equal(np.asarray(s2a.pos), np.asarray(s2b.pos))
    np.testing.assert_array_equal(np.asarray(s2a.vel), np.asarray(s2b.vel))


def test_tsv_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    arr = rng.normal(size=(5, 4, 3)).astype(np.float32)
    path = str(tmp_path / "grid.tsv")
    cp.export_array_tsv(path, arr)
    back = cp.import_array_tsv(path, arr.shape)
    np.testing.assert_array_equal(arr, back)
    assert cp.l2_norm_diff(arr, back) == 0.0

    pos = rng.normal(size=(7, 3)).astype(np.float32)
    vel = rng.normal(size=(7, 3)).astype(np.float32)
    cp.export_particles_tsv(str(tmp_path / "p.tsv"), pos, vel)
    lines = open(tmp_path / "p.tsv").read().strip().split("\n")
    assert len(lines) == 7 and len(lines[0].split("\t")) == 6


def test_golden_step():
    """Golden .npz regression (replaces the reference's TSV golden diffing,
    debugroutines.h / SURVEY.md §4.3): one step from the dam break at 16^3
    must reproduce the recorded state.  Regenerate intentionally with
    scripts/make_golden.py when numerics change."""
    state = step_jit(init_state(CFG), 0.01, CFG)
    if not os.path.exists(GOLDEN):
        import pytest

        pytest.skip("golden file not generated yet")
    with np.load(GOLDEN) as z:
        for k in ("pos", "vel", "u", "v", "w", "phi"):
            np.testing.assert_allclose(
                np.asarray(getattr(state, k)), z[k], atol=1e-5,
                err_msg=f"golden mismatch in {k}",
            )
