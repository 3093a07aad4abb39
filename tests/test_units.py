"""Small-unit tests: camera math, LCG stream, config properties, profiler
table, and the golden rendered frame."""

import math
import os

import numpy as np

from fluidsimulation.core.config import SimConfig, SimConfig2D
from fluidsimulation.core.lcg import MinstdRand, minstd_uniform_stream
from fluidsimulation.render.camera import OrbitCamera

GOLDEN_FRAME = os.path.join(os.path.dirname(__file__), "golden", "frame16_r1.npz")


def test_lcg_matches_minstd_reference():
    # First values of std::minstd_rand seeded with 1: x_{n+1} = 48271*x_n mod (2^31-1)
    g = MinstdRand(0)  # seed 0 -> state 1 per the C++ engine spec
    vals = [g.next_u32() for _ in range(4)]
    assert vals[0] == 48271
    assert vals[1] == (48271 * 48271) % (2**31 - 1)
    # Vectorized stream equals sequential draws.
    s = minstd_uniform_stream(8, -0.25, 0.25, seed=0)
    g2 = MinstdRand(0)
    seq = [g2.uniform(-0.25, 0.25) for _ in range(8)]
    np.testing.assert_allclose(s, seq, atol=1e-7)
    # skip parameter fast-forwards the stream.
    s2 = minstd_uniform_stream(4, -0.25, 0.25, seed=0, skip=4)
    np.testing.assert_allclose(s2, s[4:], atol=0)


def test_config_properties():
    cfg = SimConfig()
    assert cfg.num_particles == 953312  # reference demo count (Simulation.cpp:47-74)
    assert abs(cfg.omega - (2 - 3.16343 / 64)) < 1e-9
    assert cfg.u_shape() == (65, 64, 64)
    cfg2 = SimConfig2D()
    assert abs(cfg2.omega - (2 - 3.22133 / 64)) < 1e-9
    assert cfg2.sor_iterations == 120


def test_camera_frame_and_controls():
    cam = OrbitCamera()
    co, right, up, fwd = cam.frame(800, 600)
    # Default: theta=0, phi=pi/2 -> camera at (0, 0, -1.5) looking at origin.
    np.testing.assert_allclose(co, [0, 0, -1.5], atol=1e-6)
    np.testing.assert_allclose(fwd, [0, 0, 1], atol=1e-6)
    # FOV scaling: |up| = tan(30 deg), |right| = |up| * 800/600.
    assert abs(np.linalg.norm(up) - math.tan(math.pi / 6)) < 1e-6
    assert abs(np.linalg.norm(right) - math.tan(math.pi / 6) * 800 / 600) < 1e-5
    # Orbit changes the frame; reset restores it.
    cam.orbit(100, 50)
    co2, *_ = cam.frame(800, 600)
    assert not np.allclose(co, co2)
    cam.zoom(40, 600)
    cam.reset()
    co3, *_ = cam.frame(800, 600)
    np.testing.assert_allclose(co, co3, atol=1e-6)
    # Phi clamp (reference: [0.1, pi-0.1], FluidSimDemo.cpp:265).
    cam.orbit(0, 1e6)
    assert 0.1 <= cam.cam_phi <= math.pi - 0.1


def test_profiler_table_format():
    from fluidsimulation.utils.profiling import MARKS, SHORT, StageProfiler

    assert len(MARKS) == 23 == len(SHORT)  # GPUProfiler.h:16-44 mark count
    prof = StageProfiler()
    prof.times["ADVECT"] = 0.00123
    table = prof.table()
    lines = table.split("\n")
    assert lines[0].startswith("GPU time:")
    assert "1.23ms" in lines[1]
    assert abs(prof.DT("ADVECT") - 0.00123) < 1e-9


def test_golden_rendered_frame():
    import pytest

    if not os.path.exists(GOLDEN_FRAME):
        pytest.skip("golden frame not generated")
    from fluidsimulation.core.state import init_state
    from fluidsimulation.render.raytrace import render
    from fluidsimulation.solver.step3d import step_jit

    cfg = SimConfig(nx=16, ny=16, nz=16, cells_per_meter=16.0)
    state = step_jit(init_state(cfg), 0.01, cfg)
    cam = OrbitCamera()
    co, right, up, fwd = cam.frame(48, 36)
    img = np.asarray(render(state.phi, co, right, up, fwd, 48, 36))
    with np.load(GOLDEN_FRAME) as z:
        np.testing.assert_allclose(img, z["img"], atol=1e-4)
