"""App-layer tests: guarded step, scan driver, debug renderers, PPM IO,
and the CLI demo end-to-end (tiny config)."""

import os
import subprocess
import sys

import numpy as np
import pytest

from fluidsimulation.core.config import SimConfig
from fluidsimulation.core.state import init_state
from fluidsimulation.render.debug import (
    checkerboard,
    splat_particles_2d,
    splat_particles_3d,
)
from fluidsimulation.solver.step3d import simulate, step_guarded, step_jit
from fluidsimulation.app.demo import write_ppm

CFG = SimConfig(nx=16, ny=16, nz=16, cells_per_meter=16.0)


def test_step_guarded_healthy():
    state = init_state(CFG)
    out, ok = step_guarded(state, 0.01, CFG)
    assert bool(ok)
    # Poison the state -> unhealthy flag.
    import jax.numpy as jnp

    bad = init_state(CFG)
    bad.vel = np.asarray(bad.vel).copy()
    bad.vel[0, 0] = np.inf
    out, ok = step_guarded(bad, 0.01, CFG)
    assert not bool(ok)


@pytest.mark.slow
def test_simulate_scan_equals_loop():
    # slow tier since round 5: scan-driver equality is a round-3 record,
    # not a regression surface (the demo drives step_jit directly).
    state = init_state(CFG)
    a = simulate(state, 0.01, CFG, 3)
    b = state
    for _ in range(3):
        b = step_jit(b, 0.01, CFG)
    np.testing.assert_allclose(np.asarray(a.pos), np.asarray(b.pos), atol=1e-6)
    np.testing.assert_allclose(np.asarray(a.vel), np.asarray(b.vel), atol=1e-5)


def test_debug_renderers():
    state = init_state(CFG)
    bg = checkerboard(64, 48)
    assert bg.shape == (48, 64, 3)
    img2 = np.asarray(splat_particles_2d(np.asarray(state.pos)[:, :2], 64, 48))
    img3 = np.asarray(splat_particles_3d(np.asarray(state.pos), 64, 48))
    for img in (img2, img3):
        assert img.shape == (48, 64, 3)
        assert np.isfinite(img).all()
        assert not np.allclose(img, np.asarray(bg))  # particles visible


def test_write_ppm(tmp_path):
    img = np.random.default_rng(0).random((12, 10, 3)).astype(np.float32)
    path = str(tmp_path / "f.ppm")
    write_ppm(path, img)
    data = open(path, "rb").read()
    assert data.startswith(b"P6\n10 12\n255\n")
    assert len(data) == len(b"P6\n10 12\n255\n") + 12 * 10 * 3


def test_demo_cli(tmp_path):
    """End-to-end CLI: 3 steps at 16^3 with a rendered frame."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [
            sys.executable, "-m", "fluidsimulation.app.demo",
            "--grid", "16", "--steps", "3", "--render-every", "2",
            "--width", "64", "--height", "48", "--out", str(tmp_path),
            "--save-state",
        ],
        capture_output=True, text=True, timeout=600, env=env,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert (tmp_path / "frame_00000.ppm").exists()
    assert (tmp_path / "final_state.npz").exists()


def test_liveview_roundtrip():
    """LiveView (app/liveview.py): publish a frame, fetch the page, one
    MJPEG part off /stream, and push a command through /cmd — the headless
    equivalent of the reference's interactive window."""
    import urllib.request

    from fluidsimulation.app.liveview import LiveView

    lv = LiveView(port=0)  # ephemeral port
    try:
        img = np.random.default_rng(1).random((24, 32, 3)).astype(np.float32)
        lv.publish(img)
        base = f"http://127.0.0.1:{lv.port}"

        page = urllib.request.urlopen(f"{base}/", timeout=10).read()
        assert b"/stream" in page

        r = urllib.request.urlopen(f"{base}/stream", timeout=10)
        head = r.read(200)
        assert b"--frame" in head and (
            b"image/jpeg" in head or b"image/png" in head
        )
        r.close()

        urllib.request.urlopen(
            f"{base}/cmd?c=o%2010%20-5", timeout=10
        ).read()
        urllib.request.urlopen(f"{base}/cmd?c=%2B", timeout=10).read()
        assert lv.poll_cmds() == ["o 10 -5", "+"]
        assert lv.poll_cmds() == []
    finally:
        lv.close()
