"""Debug visualization: particle splats over a checkerboard.

The reference keeps archival debug renderers for its CPU solvers — point
sprites / quads over a checkerboard texture (DebugPoints.fx,
DebugPointsQuads.fx, Basic.fx; drivers FluidSimDemoOld.cpp:256-346,
FluidSimDemoOld3D.cpp:263-268).  These were its "does the dam break look
right" integration test (SURVEY.md §4.6).  The JAX equivalents here rasterize
particles directly into an image array with a scatter — no geometry pipeline
needed.
"""

from __future__ import annotations

import jax.numpy as jnp


def checkerboard(width: int, height: int, squares: int = 8):
    """Basic.fx-style checkerboard background, (H, W, 3) in [0,1]."""
    ys = (jnp.arange(height) * squares // height) % 2
    xs = (jnp.arange(width) * squares // width) % 2
    board = (ys[:, None] ^ xs[None, :]).astype(jnp.float32)
    shade = 0.35 + 0.3 * board
    return jnp.broadcast_to(shade[..., None], (height, width, 3))


def splat_particles_2d(pos, width: int, height: int, background=None,
                       color=(0.2, 0.4, 1.0)):
    """Render 2D particles (positions in meters over a unit domain) as
    single-pixel splats, y-up (FluidSimDemoOld.cpp point rendering)."""
    img = checkerboard(width, height) if background is None else background
    px = jnp.clip((pos[:, 0] * width).astype(jnp.int32), 0, width - 1)
    py = jnp.clip(((1.0 - pos[:, 1]) * height).astype(jnp.int32), 0, height - 1)
    col = jnp.array(color, jnp.float32)
    return img.at[py, px].set(col)


def splat_particles_3d(pos, width: int, height: int, axis: int = 2,
                       background=None, color=(0.2, 0.4, 1.0)):
    """Orthographic 3D particle view: project along `axis` (default z),
    shading by depth — the JAX analogue of the 3D CPU demo's point view
    (FluidSimDemoOld3D.cpp:263-268)."""
    img = checkerboard(width, height) if background is None else background
    keep = [0, 1, 2]
    keep.remove(axis)
    u_, v_, d_ = pos[:, keep[0]], pos[:, keep[1]], pos[:, axis]
    px = jnp.clip((u_ * width).astype(jnp.int32), 0, width - 1)
    py = jnp.clip(((1.0 - v_) * height).astype(jnp.int32), 0, height - 1)
    shade = jnp.clip(0.4 + 0.6 * d_, 0.0, 1.0)[:, None]
    col = jnp.array(color, jnp.float32) * shade
    return img.at[py, px].set(col)
