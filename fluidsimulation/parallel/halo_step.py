"""Explicit multi-chip step: ONE shard_map over the whole frame, x-sharded
grids, ppermute halo exchanges, all-gather particle redistribution, and a
relay for the x-directional level-set sweeps (SURVEY.md §5.8).

Contrast with parallel/sharding.py (GSPMD auto-partitioning of the same
step): here every collective is explicit and countable — per step:

  * 2 all-gathers of particle blocks (positions after advection, velocities)
    — the "particle slab exchange": particles stay block-sharded in ORIGINAL
    order (SimState layout is unchanged and deterministic); each shard
    compacts the particles of its x-slab (+1-cell halo) out of the gathered
    array with a fixed capacity.  At 1M particles this is 24+24 MB —
    cheaper and simpler than a true all-to-all until particle counts grow
    ~100x (documented scaling limit).
  * 2 all-gathers of the three MAC grids (pre-step for advection, the
    FLIP diff grids at the end) — grids are small (3 x 8 MB at 128^3);
    interpolation then needs no halo logic at all.  The packed-table
    BUILD on top of them is sharded 1/D (``_pack_mac3_sharded``): each
    shard packs one row chunk and the tables are all-gathered tiled
    (2 x 3 more all-gathers, ~2x grid bytes each) — per-shard pack work
    scales down with the mesh instead of every shard packing the full
    domain.
  * 1-plane ppermute halo exchanges for the stencil stages: extrapolate
    (8 arrays), RHS (1), diag (1), SOR (1 mask + 1 per half-iteration inside
    parallel/halo.py's _sor_local), apply-pressure (2), blur (1).
  * the 8 x-directional sweeps relay a carry plane of candidate positions
    around the mesh: D rounds of (local sweep + 1 ppermute); correctness
    propagates one shard per round, every shard commits its round's result
    (total work = one full-grid sweep per x-sweep, zero idle deadlock).
    The 16 y/z sweeps are embarrassingly parallel (whole lines are local).

Grids inside the shard_map use the CELL-INDEXED face representation: entry
c of u holds staggered face c+1; face 0 is identically zero at all times in
the reference pipeline (transfer forces boundary faces to 0,
gpTransferParticleVelocitiesU.hlsl:30-33, and nothing downstream writes
them), so the (nx+1) staggered axis becomes an evenly-shardable nx.

Numerics: identical op formulations to the single-device fast path (the
level-set sweeps as XLA scans, which the x-sweep relay splits per shard)
up to fp reassociation in the P2G/seed reductions; test_parallel.py pins equality
against the single-device step.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from jax import shard_map

from ..core.config import SimConfig
from ..core.interp_packed import _L, _segments, interp_mac3_packed_vec
from ..core.state import SimState
from ..ops import celltable as ct
from ..ops.extrapolate import extrapolate_one_ring
from ..ops.levelset import _CODE, FAR, SWEEP_ORDER, _sweep_axis, neighborhood_pass
from ..solver.step3d import pic_flip_alpha
from .halo import _sor_local

AXIS = "grid"


# -- halo helpers -------------------------------------------------------------

def _from_lo(plane, fill):
    """Receive the left neighbor's plane (shard i gets shard i-1's); the
    global-low shard gets `fill`."""
    n_dev = jax.lax.axis_size(AXIS)
    me = jax.lax.axis_index(AXIS)
    out = jax.lax.ppermute(plane, AXIS, [(i, i + 1) for i in range(n_dev - 1)])
    return jnp.where(me == 0, jnp.full_like(out, fill), out)


def _from_hi(plane, fill):
    n_dev = jax.lax.axis_size(AXIS)
    me = jax.lax.axis_index(AXIS)
    out = jax.lax.ppermute(plane, AXIS, [(i, i - 1) for i in range(1, n_dev)])
    return jnp.where(me == n_dev - 1, jnp.full_like(out, fill), out)


def _halo_x(a, lo_fill, hi_fill):
    """Extend a local (sx, ny, nz) block to (sx+2, ny, nz) with 1-plane x
    halos from the neighbor shards (global edges get the fills)."""
    lo = _from_lo(a[-1:], lo_fill)
    hi = _from_hi(a[:1], hi_fill)
    return jnp.concatenate([lo, a, hi], axis=0)


# -- x-relay sweep ------------------------------------------------------------

def _sweep_x_carry(phi, cpos, r, reverse, carry_in):
    """One x-directional sweep over a local block, updating EVERY plane
    against an explicit incoming candidate plane.  Same update rule as
    ops.levelset._sweep_axis (gpClosestParticlesSweepXm.hlsl:24-42); with
    carry_in = FAR candidates this equals the single-device sweep (a FAR
    candidate never wins plane 0).  Returns (phi, cpos, carry_out)."""
    n = phi.shape[0]
    phi_m = phi[::-1] if reverse else phi
    cpos_m = cpos[::-1] if reverse else cpos

    a, b = phi.shape[1], phi.shape[2]
    og = jnp.stack(
        jnp.meshgrid(
            jnp.arange(a, dtype=jnp.float32),
            jnp.arange(b, dtype=jnp.float32),
            indexing="ij",
        ),
        axis=-1,
    )
    steps = jnp.arange(n, dtype=jnp.float32)
    if reverse:
        steps = jnp.float32(n - 1) - steps

    def f(carry, inp):
        phi_p, cpos_p, s = inp
        center = jnp.concatenate(
            [jnp.full((a, b, 1), 1.0) * s, og], axis=-1
        )
        d = jnp.sqrt(((carry - center) ** 2).sum(axis=-1)) - r
        better = d < phi_p
        phi2 = jnp.where(better, d, phi_p)
        cpos2 = jnp.where(better[..., None], carry, cpos_p)
        return cpos2, (phi2, cpos2)

    carry_out, (phi_m, cpos_m) = jax.lax.scan(f, carry_in, (phi_m, cpos_m, steps))
    if reverse:
        phi_m = phi_m[::-1]
        cpos_m = cpos_m[::-1]
    return phi_m, cpos_m, carry_out


def _sweep_x_relay(phi, cpos, r, reverse, slabx):
    """The x-sweep over the x-sharded grid: D relay rounds; in round k the
    correct carry reaches shard k (forward) / D-1-k (reverse), which commits
    its result.  Carry positions are in the sender's local frame — shifted
    by -+slabx when crossing a shard boundary."""
    n_dev = jax.lax.axis_size(AXIS)
    me = jax.lax.axis_index(AXIS)
    a, b = phi.shape[1], phi.shape[2]
    # mark the constant carry as device-varying (shard_map VMA typing)
    far = jnp.full((a, b, 3), FAR, jnp.float32)
    try:
        far = jax.lax.pcast(far, (AXIS,), to="varying")
    except (AttributeError, TypeError):  # pragma: no cover - older JAX
        far = jax.lax.pvary(far, (AXIS,))
    shift = jnp.array([-slabx if not reverse else slabx, 0.0, 0.0], jnp.float32)

    out_phi, out_cpos = phi, cpos
    carry = far
    for rnd in range(int(n_dev)):
        p2, c2, carry_out = _sweep_x_carry(phi, cpos, r, reverse, carry)
        commit_shard = rnd if not reverse else int(n_dev) - 1 - rnd
        commit = me == commit_shard
        out_phi = jnp.where(commit, p2, out_phi)
        out_cpos = jnp.where(commit, c2, out_cpos)
        if rnd < int(n_dev) - 1:
            nxt = _from_lo if not reverse else _from_hi
            carry = nxt(carry_out[None], FAR)[0] + jnp.where(
                jnp.isfinite(FAR), shift, 0.0
            )
            # re-force FAR at the sourceless edge shard (ppermute zeros +
            # shift would otherwise look like a real candidate)
            edge = 0 if not reverse else int(n_dev) - 1
            carry = jnp.where(me == edge, far, carry)
    return out_phi, out_cpos


# -- local stage helpers ------------------------------------------------------

def _compute_diag_local(cfg: SimConfig, phi_e, x0, slabx):
    """Ghost-fluid diagonal on a local slab; phi_e is halo-extended in x
    (gpProjectComputeDiagCoeffs.hlsl semantics; OOB phi reads are 0).
    Non-solid-neighbor count uses GLOBAL x coordinates."""
    from ..ops.common import shift as _shift

    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    maxr = jnp.float32(cfg.max_ls_ratio)
    phi = phi_e[1:-1]
    fluid = phi < 0.0

    xg = x0 + jnp.arange(slabx)
    ex = ((xg > 0) & (xg < nx - 1)).astype(jnp.float32)[:, None, None]
    ey = (
        ((jnp.arange(ny) > 0) & (jnp.arange(ny) < ny - 1))
        .astype(jnp.float32)[None, :, None]
    )
    ez = (
        ((jnp.arange(nz) > 0) & (jnp.arange(nz) < nz - 1))
        .astype(jnp.float32)[None, None, :]
    )
    num = jnp.broadcast_to(3.0 + ex + ey + ez, phi.shape)

    recip = 1.0 / jnp.where(fluid, phi, -1.0)
    ghost = jnp.zeros_like(phi)
    for s in (-1, 1):  # x neighbors from the halo-extended block
        nb = phi_e[1 + s : 1 + s + slabx]
        ghost = ghost + jnp.clip(-nb * recip, 0.0, maxr)
    for axis in (1, 2):
        for s in (-1, 1):
            nb = _shift(phi, axis, s, 0.0)
            ghost = ghost + jnp.clip(-nb * recip, 0.0, maxr)
    return jnp.where(fluid, num + ghost, 1.0)


def _apply_pressure_local(cfg: SimConfig, u, v, w, p_e, phi_e, dt, slabx):
    """gpProjectToVel.hlsl on cell-indexed faces (entry c = face c+1).
    p_e/phi_e are x-halo-extended local blocks; the globally-last face along
    each axis is left untouched (it is already 0)."""
    n_dev = jax.lax.axis_size(AXIS)
    me = jax.lax.axis_index(AXIS)
    maxr = jnp.float32(cfg.max_ls_ratio)
    dx = 1.0 / cfg.cells_per_meter
    scale = dt / jnp.float32(cfg.rho * dx)

    def face_val(cur, phiL, phiR, pL, pR):
        safeL = jnp.where(phiL != 0.0, phiL, -1e-30)
        safeR = jnp.where(phiR != 0.0, phiR, -1e-30)
        both = cur - scale * (pR - pL)
        lonly = cur + scale * pL * (1.0 + jnp.clip(-phiR / safeL, 0.0, maxr))
        ronly = cur - scale * pR * (1.0 + jnp.clip(-phiL / safeR, 0.0, maxr))
        return jnp.where(
            phiL < 0.0,
            jnp.where(phiR < 0.0, both, lonly),
            jnp.where(phiR < 0.0, ronly, 0.0),
        )

    # x faces: entry c = face c+1 -> cells (c, c+1) = extended (c+1, c+2).
    val = face_val(u, phi_e[1:-1], phi_e[2:], p_e[1:-1], p_e[2:])
    # the global face nx (last entry of the last shard) stays 0
    last = jnp.where(me == n_dev - 1, 0.0, val[-1:])
    u = jnp.concatenate([val[:-1], last], axis=0)

    phi, pp = phi_e[1:-1], p_e[1:-1]
    ny, nz = cfg.ny, cfg.nz
    val = face_val(v[:, : ny - 1], phi[:, : ny - 1], phi[:, 1:], pp[:, : ny - 1], pp[:, 1:])
    v = jnp.concatenate([val, v[:, ny - 1 :]], axis=1)
    val = face_val(w[:, :, : nz - 1], phi[:, :, : nz - 1], phi[:, :, 1:], pp[:, :, : nz - 1], pp[:, :, 1:])
    w = jnp.concatenate([val, w[:, :, nz - 1 :]], axis=2)
    return u, v, w


def _pack_mac3_sharded(uf, vf, wf, dims, me, n_dev):
    """Shard-parallel pack_mac3: each shard builds a 1/D row chunk of the
    packed tables from the (already gathered) full MAC grids, and the
    chunks are all-gathered tiled.  Row order is the tables' major key
    (x for U/V, y for W), so the tiled concat reproduces pack_mac3's row
    indexing exactly; V/W gain one appended DEAD row group (x = nx-1 /
    y = ny-1, zeros) so the (nx-1)/(ny-1) major ranges split evenly — the
    interp keys never address them.

    Per-shard pack WORK (the 4-corner stack +
    reshape, the pack's dominant cost) now scales 1/D instead of every
    shard packing the full domain; the traded cost is one table
    all-gather (~3x2x grid bytes).
    """
    nx, ny, nz = dims
    sx = nx // n_dev
    sy = ny // n_dev
    x0 = me * sx
    y0 = me * sy

    su = _segments(uf)  # (nx+1, ny, ns, L)
    a = jax.lax.dynamic_slice_in_dim(su, x0, sx + 1, 0)
    cu = jnp.stack(
        [a[0:sx, 0: ny - 1], a[0:sx, 1:ny],
         a[1: sx + 1, 0: ny - 1], a[1: sx + 1, 1:ny]],
        axis=3,
    )
    cu = cu.reshape(sx * (ny - 1) * cu.shape[2], 4 * _L)
    pu = jax.lax.all_gather(cu, AXIS, axis=0, tiled=True)

    sv = _segments(vf)  # (nx, ny+1, ns, L)
    svp = jnp.pad(sv, ((0, 1), (0, 0), (0, 0), (0, 0)))
    a = jax.lax.dynamic_slice_in_dim(svp, x0, sx + 1, 0)
    cv = jnp.stack(
        [a[0:sx, 0:ny], a[0:sx, 1: ny + 1],
         a[1: sx + 1, 0:ny], a[1: sx + 1, 1: ny + 1]],
        axis=3,
    )
    cv = cv.reshape(sx * ny * cv.shape[2], 4 * _L)
    pv = jax.lax.all_gather(cv, AXIS, axis=0, tiled=True)

    sw = _segments(jnp.transpose(wf, (1, 2, 0)))  # (ny, nz+1, nsx, L)
    swp = jnp.pad(sw, ((0, 1), (0, 0), (0, 0), (0, 0)))
    a = jax.lax.dynamic_slice_in_dim(swp, y0, sy + 1, 0)
    cw = jnp.stack(
        [a[0:sy, 0:nz], a[0:sy, 1: nz + 1],
         a[1: sy + 1, 0:nz], a[1: sy + 1, 1: nz + 1]],
        axis=3,
    )
    cw = cw.reshape(sy * nz * cw.shape[2], 4 * _L)
    pw = jax.lax.all_gather(cw, AXIS, axis=0, tiled=True)
    return pu, pv, pw


def _full_grids(u_ci, v_ci, w_ci):
    """All-gather cell-indexed local face grids into full MAC grids (the
    implicit zero boundary face re-attached)."""
    ug = jax.lax.all_gather(u_ci, AXIS, axis=0, tiled=True)
    vg = jax.lax.all_gather(v_ci, AXIS, axis=0, tiled=True)
    wg = jax.lax.all_gather(w_ci, AXIS, axis=0, tiled=True)
    u = jnp.pad(ug, ((1, 0), (0, 0), (0, 0)))
    v = jnp.pad(vg, ((0, 0), (1, 0), (0, 0)))
    w = jnp.pad(wg, ((0, 0), (0, 0), (1, 0)))
    return u, v, w


# -- the sharded step ---------------------------------------------------------

def make_halo_step(cfg: SimConfig, mesh: Mesh, capacity: int | None = None,
                   with_diagnostics: bool = False):
    """Build the jitted explicit-collective step(state, dt) over `mesh`.

    capacity = per-shard particle-slab capacity (slab + 1-cell halo); the
    default 4x average holds the dam break's 2x-concentrated start with 2x
    slosh headroom.  Overfull slabs DROP the highest-index particles from
    the local slab; with_diagnostics=True makes the step return
    (state, n_dropped) where n_dropped is the max per-shard count of
    particles lost to the capacity cap this step (0 in a healthy run) —
    monitor it in soaks instead of discovering a mass leak downstream.
    """
    n_dev = int(mesh.devices.size)
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    assert nx % n_dev == 0, "grid x must divide the mesh"
    assert ny % n_dev == 0, "grid y must divide the mesh (sharded W pack)"
    slabx = nx // n_dev
    N = cfg.num_particles
    assert N % n_dev == 0, "particle count must divide the mesh"
    C = capacity or min(N, ((4 * N // n_dev) + 127) // 128 * 128)
    K = ct.default_k(cfg)
    cfg_ext = dataclasses.replace(cfg, nx=slabx + 2)
    r = jnp.float32(cfg.particle_radius)
    m = jnp.array([nx, ny, nz], jnp.float32)

    def local_step(pos_b, vel_b, u_ci, v_ci, w_ci, phi, dt):
        me = jax.lax.axis_index(AXIS)
        x0 = me * slabx

        # ---- advect (full grids via all-gather; local particle block;
        # pack work sharded 1/D) ----
        uf, vf, wf = _full_grids(u_ci, v_ci, w_ci)
        pu, pv, pw = _pack_mac3_sharded(uf, vf, wf, (nx, ny, nz), me, n_dev)

        def vel_at(p):
            return interp_mac3_packed_vec(pu, pv, pw, (nx, ny, nz), p * m)

        k1 = vel_at(pos_b)
        k2 = vel_at(pos_b + 0.5 * dt * k1)
        k3 = vel_at(pos_b + 0.75 * dt * k2)
        pos2 = pos_b + dt * ((2.0 / 9.0) * k1 + (3.0 / 9.0) * k2 + (4.0 / 9.0) * k3)
        pos2 = jnp.clip(pos2, -0.4 / m, 1.0 - 0.6 / m)

        # ---- particle slab exchange: gather + compact my slab (+1 halo) --
        pos_all = jax.lax.all_gather(pos2, AXIS, axis=0, tiled=True)
        vel_all = jax.lax.all_gather(vel_b, AXIS, axis=0, tiled=True)
        pc_all = pos_all * m
        cellx = jnp.floor(pc_all[:, 0] + 0.5).astype(jnp.int32)
        mine = (cellx >= x0 - 1) & (cellx <= x0 + slabx)
        # Slab-capacity guard: particles beyond the static
        # capacity C would silently vanish from this shard's table;
        # count them (max over shards, since halo overlap double-counts)
        # so callers can detect undercapacity instead of debugging a
        # mass leak.  The reference has no analogue (its bins are exact);
        # this is the price of the fixed-capacity slab exchange.
        n_dropped = jax.lax.pmax(
            jnp.maximum(mine.sum() - C, 0).astype(jnp.int32), AXIS
        )
        (idxs,) = jnp.nonzero(mine, size=C, fill_value=N)
        valid = idxs < N
        safe = jnp.minimum(idxs, N - 1)
        # local EXTENDED frame: x shifted so halo cell x0-1 -> 0
        off = jnp.concatenate(
            [(x0 - 1).astype(jnp.float32)[None], jnp.zeros(2, jnp.float32)]
        )
        pc_l = pc_all[safe] - off
        vel_l = vel_all[safe]

        table = ct._build_from_cells((slabx + 2, ny, nz), K, pc_l, vel_l, valid)

        # ---- level set: seed on the extended slab, crop, 24 sweeps -------
        phi0e, cpos0e = ct.seed_closest_from_table(cfg_ext, table, FAR)
        phi0e, cpos0e = ct.seed_overflow_correction(
            cfg_ext, table, None, phi0e, cpos0e, pc_all=pc_l
        )
        phie, cpose = neighborhood_pass(cfg_ext, cpos0e)
        phi_s = phie[1:-1]
        cpos_s = cpose[1:-1] - jnp.array([1.0, 0.0, 0.0], jnp.float32)

        for code in SWEEP_ORDER:
            axis, reverse = _CODE[code]
            if axis == 0:
                phi_s, cpos_s = _sweep_x_relay(phi_s, cpos_s, r, reverse, slabx)
            else:
                phi_s, cpos_s = _sweep_axis(phi_s, cpos_s, r, axis, reverse)

        # ---- P2G on the extended slab; crop to cell-indexed faces --------
        ue, ve, we, uve, vve, wve = ct.p2g_from_table(
            cfg_ext, table, vel=vel_l, pc=pc_l
        )
        # u: global faces x0+1..x0+slabx = extended faces 2..slabx+1
        u = ue[2 : slabx + 2]
        uv = uve[2 : slabx + 2]
        # global face nx (last shard's last entry) is a boundary face: 0/valid
        last_u = jnp.where(me == n_dev - 1, 0.0, u[-1:])
        last_uv = jnp.where(me == n_dev - 1, True, uv[-1:])
        u = jnp.concatenate([u[:-1], last_u], axis=0)
        uv = jnp.concatenate([uv[:-1], last_uv], axis=0)
        v = ve[1:-1, 1:, :]
        vv = vve[1:-1, 1:, :]
        w = we[1:-1, :, 1:]
        wv = wve[1:-1, :, 1:]

        # ---- extrapolate one ring (x halos via ppermute) -----------------
        def extrap(g, val):
            ge = _halo_x(g, 0.0, 0.0)
            vale = _halo_x(val, True, True)
            return extrapolate_one_ring(ge, vale)[1:-1]

        u = extrap(u, uv)
        v = extrap(v, vv)
        w = extrap(w, wv)

        old_u, old_v, old_w = u, v, w

        # ---- gravity on interior V faces (cell-indexed: entries 0..ny-2) -
        v = v.at[:, 0 : ny - 1, :].add(jnp.float32(cfg.gravity_y) * dt)

        # ---- project ------------------------------------------------------
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

        # ---- FLIP blend ---------------------------------------------------
        alpha = pic_flip_alpha(cfg, dt)
        du, dv, dw = (
            u - (1.0 - alpha) * old_u,
            v - (1.0 - alpha) * old_v,
            w - (1.0 - alpha) * old_w,
        )
        duf, dvf, dwf = _full_grids(du, dv, dw)
        pdu, pdv, pdw = _pack_mac3_sharded(
            duf, dvf, dwf, (nx, ny, nz), me, n_dev
        )
        diff = interp_mac3_packed_vec(pdu, pdv, pdw, (nx, ny, nz), pos2 * m)
        vel2 = (1.0 - alpha) * vel_b + diff

        # ---- blur (x halos) ----------------------------------------------
        from ..ops.blur import blur_phi

        phi_out = blur_phi(_halo_x(phi_s, 0.0, 0.0))[1:-1]

        return pos2, vel2, u, v, w, phi_out, n_dropped

    spec_p = P(AXIS, None)
    spec_g = P(AXIS, None, None)
    local = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(spec_p, spec_p, spec_g, spec_g, spec_g, spec_g, P()),
        out_specs=(spec_p, spec_p, spec_g, spec_g, spec_g, spec_g, P()),
    )

    def step_fn(state: SimState, dt):
        u_ci = state.u[1:]
        v_ci = state.v[:, 1:]
        w_ci = state.w[:, :, 1:]
        pos, vel, u_ci, v_ci, w_ci, phi, n_dropped = local(
            state.pos, state.vel, u_ci, v_ci, w_ci, state.phi,
            jnp.float32(dt),
        )
        out = SimState(
            pos=pos,
            vel=vel,
            u=jnp.pad(u_ci, ((1, 0), (0, 0), (0, 0))),
            v=jnp.pad(v_ci, ((0, 0), (1, 0), (0, 0))),
            w=jnp.pad(w_ci, ((0, 0), (0, 0), (1, 0))),
            phi=phi,
        )
        return (out, n_dropped.max()) if with_diagnostics else out

    state_sh = _state_shardings_x(mesh)
    out_sh = (state_sh, None) if with_diagnostics else state_sh
    return jax.jit(step_fn, in_shardings=(state_sh, None), out_shardings=out_sh)


def _state_shardings_x(mesh: Mesh) -> SimState:
    """x-sharded state layout; u's staggered (nx+1) x-dim is indivisible, so
    u is sharded along z at the jit boundary (the step re-slices it to the
    cell-indexed x-sharded form internally; one boundary reshard)."""
    sh_p = NamedSharding(mesh, P(AXIS, None))
    sh_g = NamedSharding(mesh, P(AXIS, None, None))
    sh_u = NamedSharding(mesh, P(None, None, AXIS))
    return SimState(pos=sh_p, vel=sh_p, u=sh_u, v=sh_g, w=sh_g, phi=sh_g)


def shard_state_x(state: SimState, mesh: Mesh) -> SimState:
    """Place a SimState with the layout make_halo_step expects.  The
    single-chip AdvectCache (if any) is dropped — the halo step runs the
    uncached advect, which is bit-identical."""
    import dataclasses

    state = dataclasses.replace(state, cache=None)
    return jax.tree.map(jax.device_put, state, _state_shardings_x(mesh))
