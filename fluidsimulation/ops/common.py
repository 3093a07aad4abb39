"""Shared grid helpers for the 3D op set."""

from __future__ import annotations

import jax.numpy as jnp


def shift(a, axis: int, s: int, fill):
    """result[i] = a[i + s] along `axis`, out-of-range entries = fill.

    Mirrors HLSL's out-of-bounds read semantics (reads return 0) when
    fill=0 — several reference kernels lean on that behavior
    (e.g. gpProjectComputeDiagCoeffs.hlsl:36-45).
    """
    if s == 0:
        return a
    pad = [(0, 0)] * a.ndim
    sl = [slice(None)] * a.ndim
    if s > 0:
        pad[axis] = (0, s)
        sl[axis] = slice(s, None)
    else:
        pad[axis] = (-s, 0)
        sl[axis] = slice(0, s)
    return jnp.pad(a, pad, constant_values=fill)[tuple(sl)]


def rank_ge(keys_sorted, k: int):
    """For a SORTED key vector: mask of elements whose rank within their
    run of equal keys is >= k.

    In sorted order, element i has at least k predecessors with the same
    key iff position i-k holds the same key — one shift + compare.  This
    replaces the rank formulation ``i - starts[keys_sorted[i]]`` whose
    starts-table lookup is a full-length row gather with two elementwise
    passes."""
    mask = keys_sorted[k:] == keys_sorted[:-k]
    return jnp.concatenate([jnp.zeros((k,), bool), mask])


def cell_of(pos_cells):
    """Cell id of a particle: uint3(mM*p + 0.5) (gpCountParticles.hlsl:22).

    pos_cells = positions already scaled to cell units.  Positions are clamped
    in-domain by advection (gpAdvect.hlsl:65-67) so no bounds check is needed.
    """
    return jnp.floor(pos_cells + 0.5).astype(jnp.int32)
