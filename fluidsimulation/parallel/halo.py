"""Hand-scheduled multi-chip SOR: shard_map + ppermute halo exchange.

parallel/sharding.py relies on the GSPMD partitioner to insert collectives
for the whole step.  For the iteration-heavy pressure solve that is
wasteful (the partitioner may re-shard per half-update); this module is the
explicit collective formulation from SURVEY.md §5.8: the grid is block-
sharded along x across the mesh, each checkerboard half-update exchanges
one boundary plane with each neighbor via ``jax.lax.ppermute``, and the
fluid-mask halos are exchanged once up front.

Numerically identical to ops/project.sor_pressure (same masked half-updates,
zero-velocity domain boundary = zero halo at the mesh edges).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from ..core.config import SimConfig

AXIS = "grid"


def _exchange_x(local, axis_name):
    """Returns (lo_halo, hi_halo): the neighbor shards' boundary x-planes
    (zeros at the global domain edges, matching zero-padded stencils)."""
    n_dev = jax.lax.axis_size(axis_name)
    idx = jax.lax.axis_index(axis_name)
    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    # lo halo of shard i == last plane of shard i-1 (sent forward).
    lo = jax.lax.ppermute(local[-1:], axis_name, fwd)
    hi = jax.lax.ppermute(local[:1], axis_name, bwd)
    zero = jnp.zeros_like(lo)
    lo = jnp.where(idx == 0, zero, lo)
    hi = jnp.where(idx == n_dev - 1, zero, hi)
    return lo, hi


def _shift_with_halo(a, lo, hi, s):
    """out[i] = a[i + s] along axis 0 with neighbor halos at the ends."""
    if s == 1:
        return jnp.concatenate([a[1:], hi], axis=0)
    return jnp.concatenate([lo, a[:-1]], axis=0)


def _shift_pad(a, axis, s):
    pad = [(0, 0)] * a.ndim
    sl = [slice(None)] * a.ndim
    if s > 0:
        pad[axis] = (0, s)
        sl[axis] = slice(s, None)
    else:
        pad[axis] = (-s, 0)
        sl[axis] = slice(0, s)
    return jnp.pad(a, pad)[tuple(sl)]


def _sor_local(cfg: SimConfig, iters, phi, diag, b):
    """Runs on each shard: phi/diag/b are local (nx/D, ny, nz) blocks."""
    omega = jnp.float32(cfg.omega)
    nxl, ny, nz = phi.shape
    idx = jax.lax.axis_index(AXIS)
    x0 = idx * nxl  # global x offset of this shard

    fluid = phi < 0.0
    fluid_f = jnp.where(fluid, 1.0, 0.0)
    flo, fhi = _exchange_x(fluid_f, AXIS)

    xg = x0 + jax.lax.broadcasted_iota(jnp.int32, (nxl, ny, nz), 0)
    yg = jax.lax.broadcasted_iota(jnp.int32, (nxl, ny, nz), 1)
    zg = jax.lax.broadcasted_iota(jnp.int32, (nxl, ny, nz), 2)
    parity = (xg + yg + zg) % 2

    nb_fluid_x = [_shift_with_halo(fluid_f, flo, fhi, s) for s in (-1, 1)]
    nb_fluid_yz = [
        _shift_pad(fluid_f, axis, s) for axis in (1, 2) for s in (-1, 1)
    ]

    def half(p, color):
        plo, phi_halo = _exchange_x(p, AXIS)
        nms = -nb_fluid_x[0] * _shift_with_halo(p, plo, phi_halo, -1)
        nms = nms - nb_fluid_x[1] * _shift_with_halo(p, plo, phi_halo, 1)
        k = 0
        for axis in (1, 2):
            for s in (-1, 1):
                nms = nms - nb_fluid_yz[k] * _shift_pad(p, axis, s)
                k += 1
        upd = (1.0 - omega) * p + omega * (b - nms) / diag
        return jnp.where(fluid & (parity == color), upd, p)

    def body(_, p):
        return half(half(p, 0), 1)

    return jax.lax.fori_loop(0, iters, body, jnp.zeros_like(b))


@functools.lru_cache(maxsize=None)
def sor_sharded_fn(cfg: SimConfig, mesh: Mesh, iters: int):
    """The shard_map'd SOR body for (cfg, mesh, iters) — built once per key
    (lru_cache; Mesh is hashable).  Composable under an outer jit (the
    sharded-step path calls it inside make_sharded_step's program)."""
    spec = P(AXIS, None, None)
    return shard_map(
        functools.partial(_sor_local, cfg, iters),
        mesh=mesh,
        in_specs=(spec, spec, spec),
        out_specs=spec,
    )


@functools.lru_cache(maxsize=None)
def _sor_sharded_jit(cfg: SimConfig, mesh: Mesh, iters: int):
    return jax.jit(sor_sharded_fn(cfg, mesh, iters))


def sor_pressure_sharded(
    cfg: SimConfig, mesh: Mesh, phi, diag, b, iterations: int | None = None
):
    """Checkerboard SOR over an x-sharded grid with explicit halo exchange.
    Equivalent to ops/project.sor_pressure.

    Inputs should already be placed with an x-sharded NamedSharding (see
    ``x_sharding``); placement is the caller's job so this composes — the
    jitted shard_map is cached per (cfg, mesh, iters), no retrace per call."""
    iters = cfg.sor_iterations if iterations is None else iterations
    return _sor_sharded_jit(cfg, mesh, iters)(phi, diag, b)


def x_sharding(mesh: Mesh) -> NamedSharding:
    """The placement sor_pressure_sharded expects: block-sharded along x."""
    return NamedSharding(mesh, P(AXIS, None, None))
