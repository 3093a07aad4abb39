"""Packed-row interpolation (core/interp_packed.py): the padded-U-stride
fat tables interpolate bit-identically to the plain ones."""

import jax.numpy as jnp
import numpy as np

from fluidsimulation.core.interp_packed import (
    interp_mac3_packed_pair_vec,
    interp_mac3_packed_vec,
    pack_mac3,
    pack_mac3_pair,
    pack_mac3_pair_padded,
)


def _grids(rng, nx, ny, nz):
    shapes = ((nx + 1, ny, nz), (nx, ny + 1, nz), (nx, ny, nz + 1))
    ga = tuple(rng.normal(size=s).astype(np.float32) for s in shapes)
    gb = tuple(rng.normal(size=s).astype(np.float32) for s in shapes)
    return ga, gb


def test_padded_layout_interp_bit_identical():
    """The padded-U-stride tables interpolate bit-identically to the plain
    pair tables (stride inferred from the row count)."""
    nx, ny, nz = 16, 16, 16
    rng = np.random.default_rng(5)
    ga, gb = _grids(rng, nx, ny, nz)
    q = rng.uniform(-0.2, 1.2, size=(700, 3)).astype(np.float32) * nx

    plain = pack_mac3_pair(ga, gb)
    padded = pack_mac3_pair_padded(ga, gb)
    assert padded[0].shape[0] > plain[0].shape[0]  # dead U rows exist
    va, vb = interp_mac3_packed_pair_vec(*plain, (nx, ny, nz), jnp.asarray(q))
    wa, wb = interp_mac3_packed_pair_vec(*padded, (nx, ny, nz), jnp.asarray(q))
    np.testing.assert_array_equal(np.asarray(va), np.asarray(wa))
    np.testing.assert_array_equal(np.asarray(vb), np.asarray(wb))


def test_padded_plain_half_slices_interp_bit_identical():
    """flip_update_carry slices the fat tables' new-grid half into plain
    512 B tables for the advect cache; the padded-layout slices must
    interpolate bit-identically to pack_mac3 of the new grids."""
    nx, ny, nz = 16, 16, 16
    rng = np.random.default_rng(7)
    ga, gb = _grids(rng, nx, ny, nz)
    q = rng.uniform(-0.2, 1.2, size=(700, 3)).astype(np.float32) * nx

    padded = pack_mac3_pair_padded(ga, gb)
    L = padded[0].shape[1] // 2
    sliced = tuple(t[:, L:] for t in padded)
    ref = pack_mac3(*gb)
    got = interp_mac3_packed_vec(*sliced, (nx, ny, nz), jnp.asarray(q))
    want = interp_mac3_packed_vec(*ref, (nx, ny, nz), jnp.asarray(q))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
