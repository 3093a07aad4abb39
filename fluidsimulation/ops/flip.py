"""Hybrid PIC/FLIP particle velocity update (gpUpdateParticleVelocities.hlsl).

u_new = (1-alpha)*u_particle + interp(new_grid) - (1-alpha)*interp(old_grid).

The GPU evaluates two hardware-sampler interpolations; the CPU builds the
difference grid new - (1-alpha)*old and interpolates once
(Simulation3D.cpp:144-165).  Interpolation is linear, so both are identical
in exact arithmetic; we use the single diff-grid interpolation (half the
gathers).  alpha = clamp(6*dt*nu*cpm^2, 0, 1) (Simulation.cpp:541, Bridson
pg. 118) is computed in the solver step.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.config import SimConfig
from ..core.interp import interp_mac3_vec
from ..core.interp_packed import interp_mac3_packed_vec, pack_mac3


def flip_update(
    cfg: SimConfig, pos, vel, u, v, w, old_u, old_v, old_w, alpha,
    packed: bool = True,
):
    du = u - (1.0 - alpha) * old_u
    dv = v - (1.0 - alpha) * old_v
    dw = w - (1.0 - alpha) * old_w
    m = jnp.array([cfg.nx, cfg.ny, cfg.nz], jnp.float32)
    if packed:
        pu, pv, pw = pack_mac3(du, dv, dw)
        diff = interp_mac3_packed_vec(
            pu, pv, pw, (cfg.nx, cfg.ny, cfg.nz), pos * m
        )
    else:
        diff = interp_mac3_vec(du, dv, dw, pos * m)
    return (1.0 - alpha) * vel + diff


def flip_update_carry(
    cfg: SimConfig, pos, vel, u, v, w, old_u, old_v, old_w, alpha
):
    """flip_update (packed) that additionally returns the next step's
    AdvectCache for free: the diff-grid AND the final-grid packs ride the
    same fat 1 KB rows (gather cost is per-transaction), so interpolating
    the new grids at pos — RK3 stage 1 of the NEXT advect — adds no gather
    traffic.  The FLIP result is bit-identical to flip_update(packed=True)
    (same keys, same reduce order on the diff half).  The cache carries the
    FAT tables (advect reads their new-grid half via
    interp_mac3_packed_half; 1 KB rows cost the same per transaction)."""
    from ..core.interp_packed import (
        interp_mac3_packed_pair_vec,
        pack_mac3_pair,
    )
    from ..core.state import AdvectCache

    du = u - (1.0 - alpha) * old_u
    dv = v - (1.0 - alpha) * old_v
    dw = w - (1.0 - alpha) * old_w
    m = jnp.array([cfg.nx, cfg.ny, cfg.nz], jnp.float32)
    fat = pack_mac3_pair((du, dv, dw), (u, v, w))
    diff, k1 = interp_mac3_packed_pair_vec(
        *fat, (cfg.nx, cfg.ny, cfg.nz), pos * m
    )
    # Cache the PLAIN new-grid half: advect's stage-2/3 gathers then fetch
    # 512 B rows instead of 1 KB fat rows whose diff half they'd discard
    # (1 KB row gathers are ~30-60% dearer — bandwidth, not transactions).
    L = fat[0].shape[1] // 2
    cache = AdvectCache(
        k1=k1, pu=fat[0][:, L:], pv=fat[1][:, L:], pw=fat[2][:, L:]
    )
    return (1.0 - alpha) * vel + diff, cache
