"""Simulation state pytrees.

The reference stores particle state as an AoS structured buffer
(ParticleDefs.h:39-60) and grids as D3D11 Texture3Ds (Simulation.h:91-130).
Here state is a pytree of device-resident arrays: SoA particles (pos/vel as
(N,3) float32, better for vectorization than AoS) plus the MAC grids and
the cell-centered level set.  One timestep is a pure function
``step(state, dt, cfg) -> state`` under a single jit; XLA program order
replaces the reference's dispatch-ordering synchronization (SURVEY.md §5.8).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax
import numpy as np

from .config import SimConfig
from .seeding import dam_break_particles


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class AdvectCache:
    """Pure per-step cache carried between fast-path steps (NOT part of the
    externalizable state — checkpoint skips it; step() reconstructs it).

    k1         : (N, 3) grid velocity interpolated at pos — next-step
                 advect's RK3 stage-1 value, produced for free by FLIP's
                 fat-row gather (ops/flip.py flip_update_carry).
    pu, pv, pw : pack_mac3 tables of the final (u, v, w) grids (sliced
                 from FLIP's fat pair pack) — next-step advect's stage-2/3
                 interpolation tables, skipping its pack.

    All values are pure functions of (pos, vel, u, v, w): a state with
    cache=None steps to bit-identical (pos, vel, grids, phi) via the
    uncached advect path.
    """

    k1: Any
    pu: Any
    pv: Any
    pw: Any


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SimState:
    """Full 3D solver state (externalizable; see utils/checkpoint.py).

    pos, vel : (N, 3) float32, meters / m/s
    u, v, w  : MAC velocity grids, indexed [x, y, z]
               shapes (nx+1,ny,nz), (nx,ny+1,nz), (nx,ny,nz+1)
    phi      : (nx, ny, nz) level set in *cell* units (Simulation3D.h:156-158)
    cache    : AdvectCache or None (fast-path acceleration only)
    """

    pos: Any
    vel: Any
    u: Any
    v: Any
    w: Any
    phi: Any
    cache: Any = None


def zero_cache(cfg: SimConfig, n_particles: int) -> AdvectCache:
    """The exact cache for the all-zero initial grids: pack_mac3 of zeros is
    zeros, and interp of zeros at any position is zero."""
    from .interp_packed import _L, _nseg

    f32 = np.float32
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    ns, nsx = _nseg(nz), _nseg(nx)
    return AdvectCache(
        k1=np.zeros((n_particles, 3), f32),
        pu=np.zeros((nx * (ny - 1) * ns, 4 * _L), f32),
        pv=np.zeros(((nx - 1) * ny * ns, 4 * _L), f32),
        pw=np.zeros(((ny - 1) * nz * nsx, 4 * _L), f32),
    )


def init_state(cfg: SimConfig, with_cache: bool = True) -> SimState:
    """Dam-break initial state matching GPFluidSim::ResetSimulation
    (Simulation.cpp:39-90): jittered particle block, zero velocities,
    zero velocity grids, phi cleared to +inf."""
    pos, vel = dam_break_particles(cfg)
    f32 = np.float32
    return SimState(
        pos=pos,
        vel=vel,
        u=np.zeros(cfg.u_shape(), f32),
        v=np.zeros(cfg.v_shape(), f32),
        w=np.zeros(cfg.w_shape(), f32),
        phi=np.full(cfg.grid_shape(), np.inf, f32),
        cache=zero_cache(cfg, pos.shape[0]) if with_cache else None,
    )


def device_put_state(state: SimState, sharding=None) -> SimState:
    return jax.tree.map(
        lambda x: jax.device_put(x, sharding) if sharding is not None else jax.device_put(x),
        state,
    )
