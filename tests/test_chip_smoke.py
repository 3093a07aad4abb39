"""chip_smoke.py reports ok only from a GPU, in the shape the chip check
reads."""

import importlib.util
import json
import os

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_refuses_ok_without_gpu(monkeypatch, capsys):
    """With the host-side phases stubbed out, a CPU backend fails the device
    phase: non-zero exit and no result line."""
    assert jax.devices()[0].platform == "cpu"
    smoke = _load()
    monkeypatch.setattr(smoke, "card_name_and_power", lambda: "stub, 0 W")
    monkeypatch.setattr(smoke, "run_card_tests", lambda: None)
    assert smoke.main([]) != 0
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("FAILED: JAX's first device is cpu")
    assert not any('"ok"' in line for line in out)


def test_result_line_shape():
    smoke = _load()
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = smoke.result_line(device)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": device}
