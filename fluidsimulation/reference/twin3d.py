"""NumPy twin of the JAX pipeline (GPU-path semantics).

The reference validated its GPU pipeline stage-by-stage against its CPU
solver (README.md:55).  We do the same two-level validation:

  * this module — a plain-NumPy, independently-written implementation of
    exactly the semantics the JAX ops claim (GPU-path variants: one-ring
    extrapolation, 24 plane sweeps, f32 SOR) — gives *tight* per-op parity
    tests (float-roundoff tolerances);
  * reference/solver3d.py — the CPU-solver (FluidSim3) oracle — gives
    end-to-end behavioral parity with the looser tolerances the reference
    itself recorded (SURVEY.md §4.1).
"""

from __future__ import annotations

import numpy as np

from ..core.config import SimConfig


FAR = 1.0e9


# -- level set --------------------------------------------------------------

def seed_closest(cfg: SimConfig, pos):
    """Own-cell argmin + 27-neighborhood candidate pass (see ops/levelset.py)."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    r = cfg.particle_radius
    m = np.array([nx, ny, nz], np.float32)
    pc = (pos * m).astype(np.float32)
    cell = np.floor(pc + 0.5).astype(np.int64)

    best_d = np.full((nx, ny, nz), np.inf, np.float32)
    best_i = np.full((nx, ny, nz), -1, np.int64)
    d = (np.sqrt(((pc - cell) ** 2).sum(-1)) - r).astype(np.float32)
    for i in range(len(pc)):
        x, y, z = cell[i]
        if d[i] < best_d[x, y, z]:
            best_d[x, y, z] = d[i]
            best_i[x, y, z] = i

    cpos0 = np.full((nx, ny, nz, 3), FAR, np.float32)
    seeded = best_i >= 0
    cpos0[seeded] = pc[best_i[seeded]]

    # 27-neighborhood pass.
    xg, yg, zg = np.meshgrid(
        np.arange(nx, dtype=np.float32),
        np.arange(ny, dtype=np.float32),
        np.arange(nz, dtype=np.float32),
        indexing="ij",
    )
    center = np.stack([xg, yg, zg], axis=-1)
    cpad = np.full((nx + 2, ny + 2, nz + 2, 3), FAR, np.float32)
    cpad[1:-1, 1:-1, 1:-1] = cpos0
    phi = np.full((nx, ny, nz), np.inf, np.float32)
    cpos = np.full((nx, ny, nz, 3), FAR, np.float32)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                cand = cpad[1 + dx : 1 + dx + nx, 1 + dy : 1 + dy + ny, 1 + dz : 1 + dz + nz]
                dist = np.sqrt(((cand - center) ** 2).sum(-1)).astype(np.float32) - np.float32(r)
                better = dist < phi
                phi = np.where(better, dist, phi)
                cpos = np.where(better[..., None], cand, cpos)
    return phi, cpos


def sweep_closest(cfg: SimConfig, phi, cpos):
    """24 directional plane sweeps, reference order (Simulation.cpp:744-753)."""
    r = np.float32(cfg.particle_radius)

    def sweep(phi, cpos, axis, reverse):
        phi = np.moveaxis(phi, axis, 0).copy()
        cpos = np.moveaxis(cpos, axis, 0).copy()
        n = phi.shape[0]
        a, b = phi.shape[1], phi.shape[2]
        other = [ax for ax in (0, 1, 2) if ax != axis]
        og0, og1 = np.meshgrid(
            np.arange(a, dtype=np.float32), np.arange(b, dtype=np.float32), indexing="ij"
        )
        rng = range(1, n) if not reverse else range(n - 2, -1, -1)
        carry = cpos[0 if not reverse else n - 1].copy()
        for i in rng:
            coords = [None, None, None]
            coords[axis] = np.full((a, b), np.float32(i))
            coords[other[0]] = og0
            coords[other[1]] = og1
            center = np.stack(coords, axis=-1)
            d = np.sqrt(((carry - center) ** 2).sum(-1)).astype(np.float32) - r
            better = d < phi[i]
            old = cpos[i].copy()
            phi[i] = np.where(better, d, phi[i])
            cpos[i] = np.where(better[..., None], carry, cpos[i])
            carry = np.where(better[..., None], carry, old)
        return np.moveaxis(phi, 0, axis), np.moveaxis(cpos, 0, axis)

    code = {0: (0, False), 1: (0, True), 2: (1, False), 3: (1, True), 4: (2, False), 5: (2, True)}
    order = [0, 2, 4, 1, 2, 4, 0, 3, 4, 1, 3, 4, 0, 2, 5, 1, 2, 5, 0, 3, 5, 1, 3, 5]
    for c in order:
        axis, rev = code[c]
        phi, cpos = sweep(phi, cpos, axis, rev)
    return phi, cpos


# -- P2G + one-ring extrapolation ------------------------------------------

def transfer_to_grid(cfg: SimConfig, pos, vel):
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    m = np.array([nx, ny, nz], np.float32)
    p = (pos * m).astype(np.float32)
    out = []
    for comp_axis, shape in ((0, (nx + 1, ny, nz)), (1, (nx, ny + 1, nz)), (2, (nx, ny, nz + 1))):
        acc = np.zeros(shape, np.float32)
        amt = np.zeros(shape, np.float32)
        base = np.empty((len(p), 3), np.int64)
        alpha = np.empty((len(p), 3), np.float32)
        for ax in range(3):
            c = p[:, ax] + (0.5 if ax == comp_axis else 0.0)
            b = np.floor(c)
            base[:, ax] = b
            alpha[:, ax] = c - b
        dims = (nx, ny, nz)
        for ox in (0, 1):
            for oy in (0, 1):
                for oz in (0, 1):
                    offs = (ox, oy, oz)
                    idx = base + np.array(offs)
                    ok = np.ones(len(p), bool)
                    for ax in range(3):
                        hi = dims[ax] + (1 if ax == comp_axis else 0)
                        ok &= (idx[:, ax] >= 0) & (idx[:, ax] < hi)
                    w = np.ones(len(p), np.float32)
                    for ax in range(3):
                        a = alpha[:, ax]
                        w = w * np.where(offs[ax] > 0, a, 1.0 - a)
                    ii = idx[ok]
                    np.add.at(acc, (ii[:, 0], ii[:, 1], ii[:, 2]), w[ok] * vel[ok, comp_axis])
                    np.add.at(amt, (ii[:, 0], ii[:, 1], ii[:, 2]), w[ok])
        g = acc / np.maximum(amt, np.float32(1e-30))
        valid = amt > cfg.zero_thresh
        sl = [slice(None)] * 3
        for edge in (0, dims[comp_axis]):
            sl2 = list(sl)
            sl2[comp_axis] = edge
            g[tuple(sl2)] = 0.0
            valid[tuple(sl2)] = True
        out.append((g, valid))
    (u, uv), (v, vv), (w, wv) = out
    return u, v, w, uv, vv, wv


def extrapolate_one_ring(g, valid):
    gp = np.pad(g, 1, constant_values=0.0)
    vp = np.pad(valid, 1, constant_values=True)
    num = np.zeros(g.shape, np.float32)
    tot = np.zeros(g.shape, np.float32)
    nx, ny, nz = g.shape
    for axis, s in [(0, -1), (0, 1), (1, -1), (1, 1), (2, -1), (2, 1)]:
        o = [slice(1, 1 + nx), slice(1, 1 + ny), slice(1, 1 + nz)]
        o[axis] = slice(1 + s, 1 + s + g.shape[axis])
        nb_v = gp[tuple(o)]
        nb_ok = vp[tuple(o)]
        num += nb_ok
        tot += np.where(nb_ok, nb_v, 0.0)
    mean = np.where(num > 0, tot / np.maximum(num, 1.0), 0.0)
    return np.where(valid, g, mean).astype(np.float32)


# -- projection (f32, GPU-style) --------------------------------------------

def project_f32(cfg: SimConfig, u, v, w, phi, dt, iterations=None):
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    maxr = np.float32(cfg.max_ls_ratio)
    dx = np.float32(1.0 / cfg.cells_per_meter)
    scale = np.float32(-dx * cfg.rho / dt)
    b = scale * (
        u[1:, :, :] - u[:-1, :, :] + v[:, 1:, :] - v[:, :-1, :] + w[:, :, 1:] - w[:, :, :-1]
    )
    fluid = phi < 0.0

    def pad0(a):
        return np.pad(a, 1, constant_values=0.0)

    phip = pad0(phi)

    def nb(a_p, axis, s):
        o = [slice(1, 1 + nx), slice(1, 1 + ny), slice(1, 1 + nz)]
        o[axis] = slice(1 + s, 1 + s + (nx, ny, nz)[axis])
        return a_p[tuple(o)]

    ig = np.zeros((nx, ny, nz), np.float32) + 3.0
    for axis, n in ((0, nx), (1, ny), (2, nz)):
        i = np.arange(n)
        e = ((i > 0) & (i < n - 1)).astype(np.float32)
        sh = [1, 1, 1]
        sh[axis] = n
        ig = ig + e.reshape(sh)
    recip = np.where(fluid, 1.0 / np.where(fluid, phi, -1.0), 0.0).astype(np.float32)
    ghost = np.zeros_like(phi)
    for axis in range(3):
        for s in (-1, 1):
            ghost += np.clip(-nb(phip, axis, s) * recip, 0.0, maxr)
    diag = np.where(fluid, ig + ghost, 1.0).astype(np.float32)

    omega = np.float32(cfg.omega)
    iters = cfg.sor_iterations if iterations is None else iterations
    xg, yg, zg = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    parity = (xg + yg + zg) % 2
    p = np.zeros((nx, ny, nz), np.float32)
    fluidp = np.pad(fluid, 1, constant_values=False)
    for _ in range(iters):
        for color in (0, 1):
            pp = pad0(p)
            nms = np.zeros_like(p)
            for axis in range(3):
                for s in (-1, 1):
                    nms -= np.where(nb(fluidp, axis, s), nb(pp, axis, s), 0.0)
            upd = (1 - omega) * p + omega * (b - nms) / diag
            p = np.where(fluid & (parity == color), upd, p).astype(np.float32)

    # apply
    scale2 = np.float32(dt / (cfg.rho * dx))
    u, v, w = u.copy(), v.copy(), w.copy()
    for grid, axis in ((u, 0), (v, 1), (w, 2)):
        n = (nx, ny, nz)[axis]
        slA = [slice(None)] * 3
        slA[axis] = slice(0, n - 1)
        slB = [slice(None)] * 3
        slB[axis] = slice(1, n)
        phiL, phiR = phi[tuple(slA)], phi[tuple(slB)]
        pL, pR = p[tuple(slA)], p[tuple(slB)]
        slF = [slice(None)] * 3
        slF[axis] = slice(1, n)
        cur = grid[tuple(slF)]
        with np.errstate(divide="ignore", invalid="ignore"):
            safeL = np.where(phiL != 0, phiL, -1e-30)
            safeR = np.where(phiR != 0, phiR, -1e-30)
            both = cur - scale2 * (pR - pL)
            lonly = cur + scale2 * pL * (1 + np.clip(-phiR / safeL, 0.0, maxr))
            ronly = cur - scale2 * pR * (1 + np.clip(-phiL / safeR, 0.0, maxr))
        val = np.where(
            phiL < 0, np.where(phiR < 0, both, lonly), np.where(phiR < 0, ronly, 0.0)
        )
        grid[tuple(slF)] = val.astype(np.float32)
    return u, v, w, p


def blur_phi(phi):
    pp = np.pad(phi, 1, constant_values=0.0)
    acc = phi.copy()
    nx, ny, nz = phi.shape
    for axis, s in [(0, -1), (0, 1), (1, -1), (1, 1), (2, -1), (2, 1)]:
        o = [slice(1, 1 + nx), slice(1, 1 + ny), slice(1, 1 + nz)]
        o[axis] = slice(1 + s, 1 + s + phi.shape[axis])
        acc = acc + pp[tuple(o)]
    return (acc / 7.0).astype(np.float32)
