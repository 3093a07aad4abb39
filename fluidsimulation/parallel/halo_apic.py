"""Explicit multi-chip APIC step — the engineered halo formulation of
parallel/halo_step.py applied to the APIC extension family (solver/apic.py).

Same collective skeleton as the FLIP halo step (ONE shard_map per frame,
x-sharded grids, ppermute halos, relay x-sweeps, fixed-capacity particle
slab exchange), with the APIC-specific differences:

* the slab exchange also carries the affine rows C (one more all-gather,
  (N, 9) f32);
* the quadratic-spline windows reach 2 cells, so the shard-local frame is
  the slab + a 2-CELL x halo (FLIP's hats need 1) — extended extent
  slabx + 4, particles compacted from cells [x0-2, x0+slabx+1];
* the shard-local table is the 16-field per-cell ApicTable
  (ops/apic.py::_build_apic_from_cells) — per-cell rather than supercell:
  the halo frame is already 1/D-sized, and supercell parity bookkeeping
  does not compose with the odd halo offset;
* P2G is the fused union-window form with the local-frame/global-meters
  split (p2g_apic_from_table_fused(pc=..., m_meters=...): spline weights
  in the shifted local cell frame, the affine lever arm converted with
  GLOBAL dims);
* advection is RK3 with stage 1 = the particle's own velocity
  (ops/advect.py::advect_rk3_pic semantics — one less gather than FLIP);
* the particle update is the packed APIC G2P over the projected full
  grids (all-gathered like FLIP's diff grids; each shard packs the mac9
  rows for its own particle block — the pack is duplicated per shard,
  unlike the 1/D mac3 pack, because mac9's (gx+1)-row layout does not
  tile evenly; an acceptable trade at the grid sizes where this runs).

Level set, extrapolation, gravity, projection, and blur reuse the FLIP
halo-step helpers verbatim (the stages are shared between the families).
Numerics: identical op formulations to the single-device APIC fast path
up to fp reassociation (per-cell vs supercell table summation order);
tests/test_parallel.py pins equality on the 8-device CPU mesh.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from ..core.config import SimConfig
from ..core.interp_packed import interp_mac3_packed_vec
from ..ops import celltable as ct
from ..ops.apic import (
    _build_apic_from_cells,
    g2p_apic_packed,
    p2g_apic_from_table_fused,
)
from ..ops.blur import blur_phi
from ..ops.levelset import _CODE, FAR, SWEEP_ORDER, _sweep_axis, neighborhood_pass
from ..solver.apic import ApicState
from .halo import _sor_local
from .halo_step import (
    AXIS,
    _apply_pressure_local,
    _compute_diag_local,
    _from_lo,
    _full_grids,
    _halo_x,
    _pack_mac3_sharded,
    _sweep_x_relay,
)


def make_halo_apic_step(cfg: SimConfig, mesh: Mesh,
                        capacity: int | None = None,
                        with_diagnostics: bool = False):
    """Build the jitted explicit-collective APIC step(state, dt) over
    `mesh`.  capacity = per-shard particle-slab capacity (slab + 2-cell
    halo); with_diagnostics=True returns (state, n_dropped) like
    make_halo_step."""
    n_dev = int(mesh.devices.size)
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    assert nx % n_dev == 0, "grid x must divide the mesh"
    assert ny % n_dev == 0, "grid y must divide the mesh (sharded pack)"
    slabx = nx // n_dev
    N = cfg.num_particles
    assert N % n_dev == 0, "particle count must divide the mesh"
    # Default capacity: FLIP's 4x-uniform-share heuristic scaled by the
    # WINDOW WIDTH ratio — the APIC frame spans slabx+4 x-cells (2-cell
    # quadratic halo) vs FLIP's slabx+2, so at small slabs the same
    # particle density needs proportionally more slots (at 32^3/D=8 the
    # dam-break block fills 57.6k of a 4x share's 54k: 3584 silent drops
    # without this scaling).
    # `is not None` (not `or`): an explicit capacity=0 must be rejected by
    # the shape machinery below, not silently replaced with the default.
    C_cap = capacity if capacity is not None else min(
        N,
        (4 * N * (slabx + 4) // (n_dev * (slabx + 2)) + 127) // 128 * 128,
    )
    K = ct.default_k(cfg)
    cfg_ext = dataclasses.replace(cfg, nx=slabx + 4)
    r = jnp.float32(cfg.particle_radius)
    m = jnp.array([nx, ny, nz], jnp.float32)

    def local_step(pos_b, vel_b, c_b, u_ci, v_ci, w_ci, phi, dt):
        me = jax.lax.axis_index(AXIS)
        x0 = me * slabx

        # ---- advect: RK3, stage 1 = own velocity (advect_rk3_pic) -------
        uf, vf, wf = _full_grids(u_ci, v_ci, w_ci)
        pu, pv, pw = _pack_mac3_sharded(uf, vf, wf, (nx, ny, nz), me, n_dev)

        def vel_at(p):
            return interp_mac3_packed_vec(pu, pv, pw, (nx, ny, nz), p * m)

        k1 = vel_b
        k2 = vel_at(pos_b + 0.5 * dt * k1)
        k3 = vel_at(pos_b + 0.75 * dt * k2)
        pos2 = pos_b + dt * (
            (2.0 / 9.0) * k1 + (3.0 / 9.0) * k2 + (4.0 / 9.0) * k3
        )
        pos2 = jnp.clip(pos2, -0.4 / m, 1.0 - 0.6 / m)

        # ---- particle slab exchange (pos, vel, C; 2-cell x halo) ---------
        pos_all = jax.lax.all_gather(pos2, AXIS, axis=0, tiled=True)
        vel_all = jax.lax.all_gather(vel_b, AXIS, axis=0, tiled=True)
        c_all = jax.lax.all_gather(
            c_b.reshape(-1, 9), AXIS, axis=0, tiled=True
        )
        pc_all = pos_all * m
        cellx = jnp.floor(pc_all[:, 0] + 0.5).astype(jnp.int32)
        mine = (cellx >= x0 - 2) & (cellx <= x0 + slabx + 1)
        n_dropped = jax.lax.pmax(
            jnp.maximum(mine.sum() - C_cap, 0).astype(jnp.int32), AXIS
        )
        (idxs,) = jnp.nonzero(mine, size=C_cap, fill_value=N)
        valid = idxs < N
        safe = jnp.minimum(idxs, N - 1)
        # local EXTENDED frame: x shifted so halo cell x0-2 -> 0
        off = jnp.concatenate(
            [(x0 - 2).astype(jnp.float32)[None], jnp.zeros(2, jnp.float32)]
        )
        pc_l = pc_all[safe] - off
        vel_l = vel_all[safe]
        c_l = c_all[safe].reshape(-1, 3, 3)

        table = _build_apic_from_cells(
            (slabx + 4, ny, nz), K, pc_l, vel_l, c_l, valid
        )

        # ---- level set on the extended slab, crop, 24 sweeps -------------
        phi0e, cpos0e = ct.seed_closest_from_table(cfg_ext, table, FAR)
        phi0e, cpos0e = ct.seed_overflow_correction(
            cfg_ext, table, None, phi0e, cpos0e, pc_all=pc_l
        )
        phie, cpose = neighborhood_pass(cfg_ext, cpos0e)
        phi_s = phie[2:-2]
        cpos_s = cpose[2:-2] - jnp.array([2.0, 0.0, 0.0], jnp.float32)

        for code in SWEEP_ORDER:
            axis, reverse = _CODE[code]
            if axis == 0:
                phi_s, cpos_s = _sweep_x_relay(phi_s, cpos_s, r, reverse, slabx)
            else:
                phi_s, cpos_s = _sweep_axis(phi_s, cpos_s, r, axis, reverse)

        # ---- P2G (fused spline windows; local frame, global meters) ------
        ue, ve, we, uve, vve, wve = p2g_apic_from_table_fused(
            cfg_ext, table, None, vel_l, c_l, pc=pc_l, m_meters=(nx, ny, nz)
        )
        # U: global faces x0+1..x0+slabx = extended faces 3..slabx+2
        u = ue[3: slabx + 3]
        uv = uve[3: slabx + 3]
        # global face nx (last shard's last entry) is a boundary face
        last_u = jnp.where(me == n_dev - 1, 0.0, u[-1:])
        last_uv = jnp.where(me == n_dev - 1, True, uv[-1:])
        u = jnp.concatenate([u[:-1], last_u], axis=0)
        uv = jnp.concatenate([uv[:-1], last_uv], axis=0)
        v = ve[2:-2, 1:, :]
        vv = vve[2:-2, 1:, :]
        w = we[2:-2, :, 1:]
        wv = wve[2:-2, :, 1:]

        # ---- extrapolate one ring (x halos via ppermute) ------------------
        from ..ops.extrapolate import extrapolate_one_ring

        def extrap(g, val):
            ge = _halo_x(g, 0.0, 0.0)
            vale = _halo_x(val, True, True)
            return extrapolate_one_ring(ge, vale)[1:-1]

        u = extrap(u, uv)
        v = extrap(v, vv)
        w = extrap(w, wv)

        # ---- gravity on interior V faces ----------------------------------
        v = v.at[:, 0: ny - 1, :].add(jnp.float32(cfg.gravity_y) * dt)

        # ---- project -------------------------------------------------------
        dxm = 1.0 / cfg.cells_per_meter
        u_lo = _from_lo(u[-1:], 0.0)
        div = (
            u - jnp.concatenate([u_lo, u[:-1]], axis=0)
            + v - jnp.pad(v[:, :-1], ((0, 0), (1, 0), (0, 0)))
            + w - jnp.pad(w[:, :, :-1], ((0, 0), (0, 0), (1, 0)))
        )
        b = jnp.float32(-dxm * cfg.rho) / dt * div

        phi_e = _halo_x(phi_s, 0.0, 0.0)
        diag = _compute_diag_local(cfg, phi_e, x0, slabx)
        p = _sor_local(cfg, cfg.sor_iterations, phi_s, diag, b)
        p_e = _halo_x(p, 0.0, 0.0)
        u, v, w = _apply_pressure_local(cfg, u, v, w, p_e, phi_e, dt, slabx)

        # ---- APIC G2P over the projected full grids ------------------------
        uf2, vf2, wf2 = _full_grids(u, v, w)
        vel2, c2 = g2p_apic_packed(cfg, pos2, uf2, vf2, wf2)

        # ---- blur (x halos) -------------------------------------------------
        phi_out = blur_phi(_halo_x(phi_s, 0.0, 0.0))[1:-1]

        return pos2, vel2, c2, u, v, w, phi_out, n_dropped

    spec_p = P(AXIS, None)
    spec_c = P(AXIS, None, None)
    spec_g = P(AXIS, None, None)
    local = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(spec_p, spec_p, spec_c, spec_g, spec_g, spec_g, spec_g,
                  P()),
        out_specs=(spec_p, spec_p, spec_c, spec_g, spec_g, spec_g, spec_g,
                   P()),
    )

    def step_fn(state: ApicState, dt):
        u_ci = state.u[1:]
        v_ci = state.v[:, 1:]
        w_ci = state.w[:, :, 1:]
        pos, vel, c, u_ci, v_ci, w_ci, phi, n_dropped = local(
            state.pos, state.vel, state.C, u_ci, v_ci, w_ci, state.phi,
            jnp.float32(dt),
        )
        out = ApicState(
            pos=pos,
            vel=vel,
            C=c,
            u=jnp.pad(u_ci, ((1, 0), (0, 0), (0, 0))),
            v=jnp.pad(v_ci, ((0, 0), (1, 0), (0, 0))),
            w=jnp.pad(w_ci, ((0, 0), (0, 0), (1, 0))),
            phi=phi,
        )
        return (out, n_dropped.max()) if with_diagnostics else out

    state_sh = _apic_state_shardings_x(mesh)
    out_sh = (state_sh, None) if with_diagnostics else state_sh
    return jax.jit(step_fn, in_shardings=(state_sh, None), out_shardings=out_sh)


def _apic_state_shardings_x(mesh: Mesh) -> ApicState:
    """x-sharded APIC state layout (halo_step._state_shardings_x + C)."""
    sh_p = NamedSharding(mesh, P(AXIS, None))
    sh_c = NamedSharding(mesh, P(AXIS, None, None))
    sh_g = NamedSharding(mesh, P(AXIS, None, None))
    sh_u = NamedSharding(mesh, P(None, None, AXIS))
    return ApicState(pos=sh_p, vel=sh_p, C=sh_c, u=sh_u, v=sh_g, w=sh_g,
                     phi=sh_g)


def shard_apic_state_x(state: ApicState, mesh: Mesh) -> ApicState:
    """Place an ApicState with the layout make_halo_apic_step expects."""
    return jax.tree.map(jax.device_put, state, _apic_state_shardings_x(mesh))
