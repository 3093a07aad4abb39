"""2D PIC/FLIP solver step (JAX) — rebuild of FluidSim
(Simulation2D.cpp).

The 2D pipeline mirrors the 3D design (solver/step3d.py) in two dimensions:
scatter-based P2G, candidate-position fast sweeping, checkerboard SOR with
the 2D constants (120 iterations, omega = 2 - 3.22133/nx,
Simulation2D.cpp:699-701), and the 2D air-side pressure-gradient '+' sign
quirk (Simulation2D.cpp:780,797 — see reference/solver2d.py).

The 2D reference has no GPU path; the sweep schedule here decomposes its 4
Zhao-order nested sweeps (Simulation2D.cpp:280-314) into 8 single-axis line
sweeps covering the same direction set — the same redesign the reference
itself applied going 3D-CPU -> 3D-GPU (24 single-axis sweeps,
Simulation.cpp:736-794).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import SimConfig2D
from ..core.interp import interp_mac2

FAR = 1.0e9


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SimState2D:
    pos: Any
    vel: Any
    u: Any
    v: Any
    phi: Any


def init_state2d(cfg: SimConfig2D) -> SimState2D:
    from ..reference.solver2d import reset

    pos, vel, u, v = reset(cfg)
    return SimState2D(
        pos=pos, vel=vel, u=u, v=v,
        phi=np.full((cfg.nx, cfg.ny), np.inf, np.float32),
    )


# -- stages ------------------------------------------------------------------

def advect_rk3(cfg: SimConfig2D, u, v, pos, dt):
    m = jnp.array([cfg.nx, cfg.ny], jnp.float32)

    def vel_at(p):
        uu, vv = interp_mac2(u, v, p[:, 0] * m[0], p[:, 1] * m[1])
        return jnp.stack([uu, vv], axis=-1)

    k1 = vel_at(pos)
    k2 = vel_at(pos + 0.5 * dt * k1)
    k3 = vel_at(pos + 0.75 * dt * k2)
    newpos = pos + dt * ((2 / 9) * k1 + (3 / 9) * k2 + (4 / 9) * k3)
    return jnp.clip(newpos, -0.4 / m, 1.0 - 0.6 / m)


def seed_closest(cfg: SimConfig2D, pos):
    nx, ny = cfg.nx, cfg.ny
    r = jnp.float32(cfg.particle_radius)
    m = jnp.array([nx, ny], jnp.float32)
    pc = pos * m
    cell = jnp.floor(pc + 0.5).astype(jnp.int32)
    lin = cell[:, 0] + nx * cell[:, 1]
    ncells = nx * ny
    d = jnp.sqrt(((pc - cell.astype(jnp.float32)) ** 2).sum(-1)) - r
    best_d = jnp.full(ncells, jnp.inf, jnp.float32).at[lin].min(d)
    idx = jnp.arange(pos.shape[0], dtype=jnp.int32)
    big = jnp.int32(2**31 - 1)
    win = (
        jnp.full(ncells, big, jnp.int32)
        .at[lin]
        .min(jnp.where(d == best_d[lin], idx, big))
    )
    seeded = win != big
    cpos0 = jnp.where(seeded[:, None], pc[jnp.where(seeded, win, 0)], FAR)
    cpos0 = cpos0.reshape(ny, nx, 2).transpose(1, 0, 2)

    xg = jnp.arange(nx, dtype=jnp.float32)[:, None]
    yg = jnp.arange(ny, dtype=jnp.float32)[None, :]
    center = jnp.stack(jnp.broadcast_arrays(xg, yg), axis=-1)
    cpad = jnp.pad(cpos0, ((1, 1), (1, 1), (0, 0)), constant_values=FAR)
    phi = jnp.full((nx, ny), jnp.inf, jnp.float32)
    cpos = jnp.full((nx, ny, 2), FAR, jnp.float32)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            cand = cpad[1 + dx : 1 + dx + nx, 1 + dy : 1 + dy + ny]
            dist = jnp.sqrt(((cand - center) ** 2).sum(-1)) - r
            better = dist < phi
            phi = jnp.where(better, dist, phi)
            cpos = jnp.where(better[..., None], cand, cpos)
    return phi, cpos


def _sweep_axis2(phi, cpos, r, axis, reverse):
    phi_m = jnp.moveaxis(phi, axis, 0)
    cpos_m = jnp.moveaxis(cpos, axis, 0)
    if reverse:
        phi_m = phi_m[::-1]
        cpos_m = cpos_m[::-1]
    n, b = phi_m.shape
    og = jnp.arange(b, dtype=jnp.float32)
    steps = jnp.arange(1, n, dtype=jnp.float32)
    if reverse:
        steps = jnp.float32(n - 1) - steps

    def f(carry, inp):
        phi_p, cpos_p, s = inp
        if axis == 0:
            center = jnp.stack([jnp.full((b,), s), og], axis=-1)
        else:
            center = jnp.stack([og, jnp.full((b,), s)], axis=-1)
        d = jnp.sqrt(((carry - center) ** 2).sum(-1)) - r
        better = d < phi_p
        phi2 = jnp.where(better, d, phi_p)
        cpos2 = jnp.where(better[..., None], carry, cpos_p)
        carry2 = jnp.where(better[..., None], carry, cpos_p)
        return carry2, (phi2, cpos2)

    _, (phi_rest, cpos_rest) = jax.lax.scan(f, cpos_m[0], (phi_m[1:], cpos_m[1:], steps))
    phi_m = jnp.concatenate([phi_m[:1], phi_rest], axis=0)
    cpos_m = jnp.concatenate([cpos_m[:1], cpos_rest], axis=0)
    if reverse:
        phi_m = phi_m[::-1]
        cpos_m = cpos_m[::-1]
    return jnp.moveaxis(phi_m, 0, axis), jnp.moveaxis(cpos_m, 0, axis)


def compute_level_set(cfg: SimConfig2D, pos):
    phi, cpos = seed_closest(cfg, pos)
    r = jnp.float32(cfg.particle_radius)
    # Axis-decomposed Zhao order: (x-,y-), (x+,y-), (x+,y+), (x-,y+).
    for axis, rev in [
        (0, False), (1, False),
        (0, True), (1, False),
        (0, True), (1, True),
        (0, False), (1, True),
    ]:
        phi, cpos = _sweep_axis2(phi, cpos, r, axis, rev)
    return phi, cpos


def transfer_to_grid(cfg: SimConfig2D, pos, vel):
    nx, ny = cfg.nx, cfg.ny
    m = jnp.array([nx, ny], jnp.float32)
    p = pos * m
    out = []
    for comp_axis, shape in ((0, (nx + 1, ny)), (1, (nx, ny + 1))):
        base = []
        alpha = []
        for ax in range(2):
            c = p[:, ax] + (0.5 if ax == comp_axis else 0.0)
            b = jnp.floor(c)
            base.append(b.astype(jnp.int32))
            alpha.append(c - b)
        lin_list, w_list = [], []
        dims = (nx, ny)
        for ox in (0, 1):
            for oy in (0, 1):
                offs = (ox, oy)
                idx = [base[ax] + offs[ax] for ax in range(2)]
                ok = jnp.ones(p.shape[0], bool)
                for ax in range(2):
                    hi = dims[ax] + (1 if ax == comp_axis else 0)
                    ok = ok & (idx[ax] >= 0) & (idx[ax] < hi)
                wgt = jnp.ones(p.shape[0], jnp.float32)
                for ax in range(2):
                    a = alpha[ax]
                    wgt = wgt * (a if offs[ax] > 0 else 1.0 - a)
                lin = idx[0] * shape[1] + idx[1]
                lin_list.append(jnp.where(ok, lin, 0))
                w_list.append(jnp.where(ok, wgt, 0.0))
        lin = jnp.concatenate(lin_list)
        wgt = jnp.concatenate(w_list)
        vals = jnp.concatenate([wi * vel[:, comp_axis] for wi in w_list])
        ncells = shape[0] * shape[1]
        acc = jnp.zeros(ncells, jnp.float32).at[lin].add(vals).reshape(shape)
        amt = jnp.zeros(ncells, jnp.float32).at[lin].add(wgt).reshape(shape)
        g = acc / jnp.maximum(amt, 1e-30)
        valid = amt > cfg.zero_thresh
        if comp_axis == 0:
            g = g.at[0, :].set(0.0).at[nx, :].set(0.0)
            valid = valid.at[0, :].set(True).at[nx, :].set(True)
        else:
            g = g.at[:, 0].set(0.0).at[:, ny].set(0.0)
            valid = valid.at[:, 0].set(True).at[:, ny].set(True)
        out.append((g, valid))
    (u, uv), (v, vv) = out
    return u, v, uv, vv


def _shift2(a, axis, s, fill):
    pad = [(0, 0)] * a.ndim
    sl = [slice(None)] * a.ndim
    if s > 0:
        pad[axis] = (0, s)
        sl[axis] = slice(s, None)
    else:
        pad[axis] = (-s, 0)
        sl[axis] = slice(0, s)
    return jnp.pad(a, pad, constant_values=fill)[tuple(sl)]


def extrapolate_full(g, valid, iters: int):
    """Full-grid extrapolation, exactly equivalent to the 2D reference's
    Manhattan-distance-bucket BFS (Simulation2D.cpp:443-581): iterate a
    masked one-ring fill; each iteration assigns cells adjacent to the
    currently-valid set the mean of their valid neighbors, then grows the
    valid set.  Newly-filled cells never read same-distance neighbors —
    matching the bucket rule cd[nb] < cd[me].  ``iters`` must cover the
    grid's Manhattan diameter (nx + ny)."""

    def body(_, carry):
        g, valid = carry
        num = jnp.zeros(g.shape, jnp.float32)
        tot = jnp.zeros(g.shape, jnp.float32)
        for axis in range(2):
            for s in (-1, 1):
                nb = _shift2(g, axis, s, 0.0)
                ok = _shift2(valid, axis, s, False)
                num = num + ok
                tot = tot + jnp.where(ok, nb, 0.0)
        fill = (~valid) & (num > 0)
        g = jnp.where(fill, tot / jnp.maximum(num, 1.0), g)
        return g, valid | fill

    g, _ = jax.lax.fori_loop(0, iters, body, (g, valid))
    return g


def project(cfg: SimConfig2D, u, v, phi, dt, iterations=None):
    nx, ny = cfg.nx, cfg.ny
    maxr = jnp.float32(cfg.max_ls_ratio)
    dx = 1.0 / cfg.cells_per_meter
    scale = jnp.float32(-dx * cfg.rho) / dt
    fluid = phi < 0.0
    b = scale * (u[1:, :] - u[:-1, :] + v[:, 1:] - v[:, :-1])

    def interior(n, axis):
        i = jnp.arange(n)
        e = (i > 0) & (i < n - 1)
        return e.reshape((n, 1) if axis == 0 else (1, n))

    num = 2.0 + interior(nx, 0) + interior(ny, 1)
    recip = 1.0 / jnp.where(fluid, phi, -1.0)
    ghost = jnp.zeros_like(phi)
    for axis in range(2):
        for s in (-1, 1):
            nb = _shift2(phi, axis, s, 0.0)
            ghost = ghost + jnp.clip(-nb * recip, 0.0, maxr)
    diag = jnp.where(fluid, num + ghost, 1.0)

    omega = jnp.float32(cfg.omega)
    iters = cfg.sor_iterations if iterations is None else iterations
    parity = (jnp.arange(nx)[:, None] + jnp.arange(ny)[None, :]) % 2
    nb_fluid = [
        _shift2(fluid, axis, s, False) for axis in range(2) for s in (-1, 1)
    ]

    def half(p, color):
        nms = jnp.zeros_like(p)
        k = 0
        for axis in range(2):
            for s in (-1, 1):
                nms = nms - jnp.where(nb_fluid[k], _shift2(p, axis, s, 0.0), 0.0)
                k += 1
        upd = (1 - omega) * p + omega * (b - nms) / diag
        return jnp.where(fluid & (parity == color), upd, p)

    p = jax.lax.fori_loop(
        0, iters, lambda _, p: half(half(p, 0), 1), jnp.zeros_like(b)
    )

    scale2 = dt / jnp.float32(cfg.rho * dx)
    u = u.at[0, :].set(0.0).at[nx, :].set(0.0)
    v = v.at[:, 0].set(0.0).at[:, ny].set(0.0)

    def update(grid, axis):
        n = (nx, ny)[axis]
        slA = [slice(None)] * 2
        slA[axis] = slice(0, n - 1)
        slB = [slice(None)] * 2
        slB[axis] = slice(1, n)
        phiL, phiR = phi[tuple(slA)], phi[tuple(slB)]
        pL, pR = p[tuple(slA)], p[tuple(slB)]
        slF = [slice(None)] * 2
        slF[axis] = slice(1, n)
        cur = grid[tuple(slF)]
        safeL = jnp.where(phiL != 0, phiL, -1e-30)
        safeR = jnp.where(phiR != 0, phiR, -1e-30)
        both = cur - scale2 * (pR - pL)
        lonly = cur + scale2 * pL * (1 + jnp.clip(-phiR / safeL, 0.0, maxr))
        # 2D sign quirk: '+' in the air-left case (Simulation2D.cpp:780).
        ronly = cur + scale2 * pR * (1 + jnp.clip(-phiL / safeR, 0.0, maxr))
        val = jnp.where(
            phiL < 0,
            jnp.where(phiR < 0, both, lonly),
            jnp.where(phiR < 0, ronly, 0.0),
        )
        return grid.at[tuple(slF)].set(val)

    return update(u, 0), update(v, 1), p


def step2d(state: SimState2D, dt, cfg: SimConfig2D) -> SimState2D:
    pos = advect_rk3(cfg, state.u, state.v, state.pos, dt)
    alpha = jnp.clip(6.0 * dt * jnp.float32(cfg.nu * cfg.cells_per_meter**2), 0.0, 1.0)
    phi, _ = compute_level_set(cfg, pos)
    u, v, uv, vv = transfer_to_grid(cfg, pos, state.vel)
    iters = cfg.nx + cfg.ny + 2
    u = extrapolate_full(u, uv, iters)
    v = extrapolate_full(v, vv, iters)
    old_u, old_v = u, v
    v = v.at[:, 1 : cfg.ny].add(jnp.float32(cfg.gravity_y) * dt)
    u, v, _ = project(cfg, u, v, phi, dt)
    du = u - (1 - alpha) * old_u
    dv = v - (1 - alpha) * old_v
    m = jnp.array([cfg.nx, cfg.ny], jnp.float32)
    iu, iv = interp_mac2(du, dv, pos[:, 0] * m[0], pos[:, 1] * m[1])
    vel = (1 - alpha) * state.vel + jnp.stack([iu, iv], axis=-1)
    return SimState2D(pos=pos, vel=vel, u=u, v=v, phi=phi)


@functools.partial(jax.jit, static_argnames=("cfg",))
def step2d_jit(state: SimState2D, dt, cfg: SimConfig2D) -> SimState2D:
    return step2d(state, dt, cfg)
