"""Particle advection (RK3, Ralston).

JAX equivalent of gpAdvect.hlsl: instead of hardware trilinear
samplers we interpolate the MAC grids manually with the CPU-oracle semantics
(core/interp.py), which removes the reference's fixed-point-lerp parity gap
(Simulation.cpp:569-576, README.md:55).  Stage offsets 0.5*dt and 0.75*dt and
weights (2/9, 3/9, 4/9) per Simulation3D.cpp:211-221; final position clamp to
[-0.4/m, 1-0.6/m] per gpAdvect.hlsl:65-67 (equal to the CPU's
(-0.5+0.1)/m .. 1+(-0.5-0.1)/m clamp).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.interp import interp_mac3_vec
from ..core.interp_packed import interp_mac3_packed_vec, pack_mac3


def advect_rk3(cfg: SimConfig, u, v, w, pos, dt, packed: bool = True):
    m = jnp.array([cfg.nx, cfg.ny, cfg.nz], jnp.float32)

    if packed:
        # Fast path: pack the grids once, reuse across the 3 RK stages
        # (core/interp_packed.py — one 512 B row gather per component per
        # stage).  The combined-key single-gather variant
        # (core/interp_combined.py) needs a costlier interleaved pack.
        pu, pv, pw = pack_mac3(u, v, w)
        dims = (cfg.nx, cfg.ny, cfg.nz)

        def vel_at(p):
            return interp_mac3_packed_vec(pu, pv, pw, dims, p * m)

    else:

        def vel_at(p):
            return interp_mac3_vec(u, v, w, p * m)

    k1 = vel_at(pos)
    k2 = vel_at(pos + 0.5 * dt * k1)
    k3 = vel_at(pos + 0.75 * dt * k2)
    newpos = pos + dt * (
        (2.0 / 9.0) * k1 + (3.0 / 9.0) * k2 + (4.0 / 9.0) * k3
    )
    return jnp.clip(newpos, -0.4 / m, 1.0 - 0.6 / m)


def advect_rk3_pic(cfg: SimConfig, u, v, w, pos, vel, dt):
    """RK3 with stage 1 = the particle's OWN velocity (APIC/PIC semantics).

    For pure-PIC transfer families (APIC), vel IS the grid interpolation at
    pos — the quadratic-spline G2P sample taken at exactly these positions
    from exactly these grids at the end of the previous step — so stage 1
    needs no gather at all.
    Stages 2/3 use the packed hat interp like advect_rk3(packed=True):
    mixing interpolants across RK stages keeps the integrator consistent
    (each stage samples a valid approximation of the same grid field).
    NOT for FLIP states, whose particle velocity is a blend, not a grid
    sample."""
    m = jnp.array([cfg.nx, cfg.ny, cfg.nz], jnp.float32)
    pu, pv, pw = pack_mac3(u, v, w)
    dims = (cfg.nx, cfg.ny, cfg.nz)

    def vel_at(p):
        return interp_mac3_packed_vec(pu, pv, pw, dims, p * m)

    k1 = vel
    k2 = vel_at(pos + 0.5 * dt * k1)
    k3 = vel_at(pos + 0.75 * dt * k2)
    newpos = pos + dt * (
        (2.0 / 9.0) * k1 + (3.0 / 9.0) * k2 + (4.0 / 9.0) * k3
    )
    return jnp.clip(newpos, -0.4 / m, 1.0 - 0.6 / m)


def advect_rk3_cached(cfg: SimConfig, cache, pos, dt):
    """advect_rk3 fast path using the previous step's AdvectCache: stage 1
    comes out of the cache (it was produced by FLIP's fat-row gather at
    exactly these positions from exactly these grids) and stages 2/3 gather
    from the cached pack_mac3 tables of the same grids — skipping this
    step's pack and 3 of its 9 row gathers.  Bit-identical to
    advect_rk3(..., packed=True) by construction."""
    m = jnp.array([cfg.nx, cfg.ny, cfg.nz], jnp.float32)
    dims = (cfg.nx, cfg.ny, cfg.nz)

    def vel_at(p):
        return interp_mac3_packed_vec(cache.pu, cache.pv, cache.pw, dims, p * m)

    k1 = cache.k1
    k2 = vel_at(pos + 0.5 * dt * k1)
    k3 = vel_at(pos + 0.75 * dt * k2)
    newpos = pos + dt * (
        (2.0 / 9.0) * k1 + (3.0 / 9.0) * k2 + (4.0 / 9.0) * k3
    )
    return jnp.clip(newpos, -0.4 / m, 1.0 - 0.6 / m)
