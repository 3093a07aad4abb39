"""Multi-chip tile-sharded renderer (SURVEY.md §5.8 applied to L5).

The reference renderer is a single-GPU fullscreen pass (Render.fx:518,
FluidSimDemo.cpp:200); its parallelism is per-pixel.  The raytraced frame
is embarrassingly parallel over screen tiles, and the packed level-set
textures are small enough to replicate (PackedPhi at 128³ ≈ 41 MB, +
PackedPhi9 ≈ 95 MB), so the multi-chip formulation is plain
data parallelism over the mesh: replicate the textures, shard the tile
list over a 1-D device mesh with ``shard_map``, run the SAME per-tile
program (`_render_tile`, with its whole-batch early-exit march loops) in
a ``lax.scan`` over each shard's local tiles, and reassemble.  There are
no collectives in the hot path — the only communication is the output
tile gather at the jit boundary.

This is a capability the reference cannot express (single-device by
construction): the frame's cost divides over the cards, and the
sim+render loop can overlap the step (card set A) with the frame (set B).

Equality: each tile runs the identical compiled program the single-chip
tiled renderer runs, so the image matches `render()`'s tiled path exactly
per tile (bit-equal on the 8-device CPU mesh, tests/test_render_sharded.py);
only the scan grouping differs.  Tile-count padding renders the (0,0)
tile redundantly on the padding slots and drops it on reassembly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from .raytrace import PackedPhi, PackedPhi9, _render_tile, gradient_fits_phi9


def make_sharded_render(mesh: Mesh, width: int, height: int,
                        tile_h: int = 100, tile_w: int = 100,
                        bounces: int = 2, overstep: float = 0.0):
    """Build a jitted frame(phi, cam_pos, cam_right, cam_up, cam_fwd) that
    renders (height, width, 3) with the frame's tiles sharded over `mesh`
    (1-D).  Tile defaults match the single-card renderer's 128³ tiles
    (100×100).  ``overstep``: the single-chip renderer's
    certified outside-march mode (raytrace.intersect_water; 0/1.0 =
    exact), applied identically per tile."""
    assert len(mesh.axis_names) == 1, "1-D mesh"
    axis = mesh.axis_names[0]
    n_dev = int(mesh.devices.size)

    nty = -(-height // tile_h)
    ntx = -(-width // tile_w)
    n_tiles = nty * ntx
    n_pad = -(-n_tiles // n_dev) * n_dev
    ys = np.repeat(np.arange(nty, dtype=np.float32) * tile_h, ntx)
    xs = np.tile(np.arange(ntx, dtype=np.float32) * tile_w, nty)
    ys = jnp.asarray(np.pad(ys, (0, n_pad - n_tiles)))
    xs = jnp.asarray(np.pad(xs, (0, n_pad - n_tiles)))

    ov = jnp.float32(overstep) if overstep and overstep > 1.0 else None

    def local_tiles(tex, g9, co, right, up, fwd, ys_l, xs_l):
        def body(_, yx):
            img = _render_tile(
                tex, co, right, up, fwd, width, height, tile_h, tile_w,
                yx[0], yx[1], g9=g9, bounces=bounces, overstep=ov,
            )
            return 0, img

        _, tiles = jax.lax.scan(body, 0, jnp.stack([ys_l, xs_l], axis=1))
        return tiles  # (n_pad / n_dev, tile_h, tile_w, 3)

    # check_vma=False: the march loops' carries start from replicated
    # constants but become shard-varying once mixed with the sharded tile
    # origins — the computation is embarrassingly parallel (no collectives),
    # so the varying-axis bookkeeping is pure friction here.
    sharded = shard_map(
        local_tiles, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(), P(), P(axis), P(axis)),
        out_specs=P(axis), check_vma=False,
    )

    @jax.jit
    def frame(phi, cam_pos, cam_right, cam_up, cam_fwd):
        tex = PackedPhi(phi)
        g9 = PackedPhi9(phi) if gradient_fits_phi9(phi.shape) else None
        tiles = sharded(tex, g9, cam_pos, cam_right, cam_up, cam_fwd, ys, xs)
        img = tiles[:n_tiles].reshape(nty, ntx, tile_h, tile_w, 3)
        img = img.transpose(0, 2, 1, 3, 4).reshape(nty * tile_h, ntx * tile_w, 3)
        return img[:height, :width]

    return frame
