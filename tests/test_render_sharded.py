"""Tile-sharded multi-chip renderer vs the single-chip tiled renderer.

Runs on the 8-virtual-device CPU mesh (conftest).  Each sharded tile runs
the same `_render_tile` program the single-chip scan runs, so images
should match exactly (up to XLA refusing bitwise determinism across
program contexts — tolerance 1e-6 guards that)."""

import pytest

import jax
import numpy as np

from fluidsimulation.core.config import SimConfig
from fluidsimulation.core.state import init_state
from fluidsimulation.parallel.sharding import make_mesh
from fluidsimulation.render.camera import OrbitCamera
from fluidsimulation.render.raytrace import render
from fluidsimulation.render.sharded import make_sharded_render
from fluidsimulation.solver.step3d import step_jit


def _scene():
    cfg = SimConfig(nx=16, ny=16, nz=16, cells_per_meter=16.0)
    state = step_jit(init_state(cfg), 0.01, cfg)
    return state.phi


@pytest.mark.slow
def test_sharded_render_matches_tiled():
    phi = _scene()
    w, h = 96, 80
    co, right, up, fwd = OrbitCamera().frame(w, h)
    mesh = make_mesh(jax.devices()[:8])

    frame = make_sharded_render(mesh, w, h, tile_h=40, tile_w=32)
    img_sharded = np.asarray(frame(phi, co, right, up, fwd))

    img_single = np.asarray(
        render(phi, co, right, up, fwd, w, h, band_rows=40, band_cols=32)
    )
    assert img_sharded.shape == (h, w, 3)
    np.testing.assert_allclose(img_sharded, img_single, atol=1e-6)


@pytest.mark.slow  # round 5: 33 s; the collective-budget pin +
# driver dryrun keep the fast sharded-render signal
def test_sharded_render_tile_padding():
    # 6 tiles over 8 devices: padding slots render tile (0,0) redundantly
    # and must be dropped on reassembly.
    phi = _scene()
    w, h = 64, 48
    co, right, up, fwd = OrbitCamera().frame(w, h)
    mesh = make_mesh(jax.devices()[:4])  # 5 tiles -> pad to 8 over 4 devs

    frame = make_sharded_render(mesh, w, h, tile_h=24, tile_w=26)
    img_sharded = np.asarray(frame(phi, co, right, up, fwd))
    img_single = np.asarray(
        render(phi, co, right, up, fwd, w, h, band_rows=24, band_cols=26)
    )
    assert img_sharded.shape == (h, w, 3)
    np.testing.assert_allclose(img_sharded, img_single, atol=1e-6)


def test_sharded_render_collective_budget():
    """The tile-sharded renderer's hot path has ZERO collectives — all data
    movement is the up-front texture replication (boundary all-gathers;
    docs/PARALLEL.md).  Pin it so a refactor cannot
    silently reintroduce per-tile communication."""
    import jax

    from fluidsimulation.core.config import SimConfig
    from fluidsimulation.core.state import init_state
    from fluidsimulation.parallel.hlo import compiled_collectives
    from fluidsimulation.parallel.sharding import make_mesh
    from fluidsimulation.render.camera import OrbitCamera

    mesh = make_mesh(jax.devices()[:8])
    cfg = SimConfig(nx=32, ny=32, nz=32, cells_per_meter=32.0)
    phi = init_state(cfg).phi
    co, right, up, fwd = OrbitCamera().frame(160, 120)
    counts = compiled_collectives(
        make_sharded_render(mesh, 160, 120, tile_h=40, tile_w=40),
        phi, co, right, up, fwd,
    )
    # Full budget dict pinned EXACTLY: boundary
    # replication only — 3 all-gathers before the tile loop at this config
    # (6 at the full 128^3+Phi9 config), zero everything else.
    assert dict(counts) == {
        "collective-permute": 0,
        "all-gather": 3,
        "all-reduce": 0,
        "all-to-all": 0,
        "reduce-scatter": 0,
    }, counts
