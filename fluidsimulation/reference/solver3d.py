"""NumPy oracle: CPU 3D PIC/FLIP solver (FluidSim3 semantics).

This is an independent transcription of the *semantics* of the reference's
CPU 3D solver (Simulation3D.cpp), which served as the reference's parity
oracle for its GPU pipeline (README.md:55).  It plays the same role here for
the JAX pipeline: tests compare the fused step against this module with
the tolerances the reference recorded inline (SURVEY.md §4.1).

Everything is vectorized NumPy except the fast-sweeping level set, whose
loop-carried dependence follows the reference's 8 nested triple-sweeps
(Simulation3D.cpp:307-416) and therefore runs as explicit loops — use small
grids (16^3/32^3) in tests, or the native C++ oracle (native/) when built.

Grid convention: arrays indexed [x, y, z]; u:(nx+1,ny,nz), v:(nx,ny+1,nz),
w:(nx,ny,nz+1), phi:(nx,ny,nz).  Positions in meters; phi in cell units.
"""

from __future__ import annotations

import numpy as np

from ..core.config import SimConfig

from ..core.seeding import dam_break_particles


# ---------------------------------------------------------------------------
# MAC interpolation (Simulation3D.h:55-123), vectorized over query points.
# ---------------------------------------------------------------------------

def interp_mac(u, v, w, pi, pj, pk):
    nx = u.shape[0] - 1
    ny = v.shape[1] - 1
    nz = w.shape[2] - 1

    def split_n(c, m):
        n = np.clip(c, 0.0, m - 1.0)
        i = np.minimum(np.floor(n), m - 2.0)
        return i.astype(np.int64), (n - i).astype(np.float32)

    def split_e(c, m):
        e = np.clip(c + 0.5, 0.0, float(m))
        i = np.minimum(np.floor(e), m - 1.0)
        return i.astype(np.int64), (e - i).astype(np.float32)

    iI, fI = split_n(pi, nx)
    iJ, fJ = split_n(pj, ny)
    iK, fK = split_n(pk, nz)
    iEI, fEI = split_e(pi, nx)
    iEJ, fEJ = split_e(pj, ny)
    iEK, fEK = split_e(pk, nz)

    def tri(g, i, j, k, fi, fj, fk):
        def L(a, b, t):
            return a + (b - a) * t

        t00 = L(g[i, j, k], g[i + 1, j, k], fi)
        t10 = L(g[i, j + 1, k], g[i + 1, j + 1, k], fi)
        t01 = L(g[i, j, k + 1], g[i + 1, j, k + 1], fi)
        t11 = L(g[i, j + 1, k + 1], g[i + 1, j + 1, k + 1], fi)
        return L(L(t00, t10, fj), L(t01, t11, fj), fk)

    return (
        tri(u, iEI, iJ, iK, fEI, fJ, fK),
        tri(v, iI, iEJ, iK, fI, fEJ, fK),
        tri(w, iI, iJ, iEK, fI, fJ, fEK),
    )


# ---------------------------------------------------------------------------
# Pipeline stages
# ---------------------------------------------------------------------------

def advect(cfg: SimConfig, u, v, w, pos, dt):
    """RK3 (Ralston) advection + inward clamp (Simulation3D.cpp:190-232)."""
    m = np.array([cfg.nx, cfg.ny, cfg.nz], np.float32)

    def vel_at(p):
        return np.stack(
            interp_mac(u, v, w, m[0] * p[:, 0], m[1] * p[:, 1], m[2] * p[:, 2]),
            axis=-1,
        )

    k1 = vel_at(pos)
    k2 = vel_at(pos + 0.5 * dt * k1)
    k3 = vel_at(pos + 0.75 * dt * k2)
    vel = (2.0 / 9.0) * k1 + (3.0 / 9.0) * k2 + (4.0 / 9.0) * k3
    newpos = pos + dt * vel
    eps = 0.1
    lo = (-0.5 + eps) / m
    hi = 1.0 + (-0.5 - eps) / m
    return np.clip(newpos, lo, hi).astype(np.float32)


def compute_level_set(cfg: SimConfig, pos):
    """CPU fast-sweeping level set (Simulation3D.cpp:255-420).

    Seeds only each particle's containing cell, then runs 8 octant triple-
    sweeps with the clsInner update.  Returns (phi, closest) where closest is
    the particle index per cell (-1 = none; note the reference's `otherPt > 0`
    check means particle 0 never propagates — replicated here).
    """
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    r = cfg.particle_radius
    m = np.array([nx, ny, nz], np.float32)
    pc = (pos * m).astype(np.float32)  # cell-space positions

    phi = np.full((nx, ny, nz), np.inf, np.float32)
    closest = np.full((nx, ny, nz), -1, np.int64)

    cell = np.round(pc).astype(np.int64)
    inb = (
        (cell[:, 0] >= 0) & (cell[:, 0] < nx)
        & (cell[:, 1] >= 0) & (cell[:, 1] < ny)
        & (cell[:, 2] >= 0) & (cell[:, 2] < nz)
    )
    # First-seen-wins with strict '<' (Simulation3D.cpp:296-299): iterate in
    # particle order.  Vectorized: sort by (cell, dist, index) and take the
    # first per cell, which equals the reference's result because update only
    # on strictly smaller dist and ties keep the earliest particle.
    idxs = np.nonzero(inb)[0]
    cells = cell[idxs]
    d = np.sqrt(((pc[idxs] - cells) ** 2).sum(axis=1)) - r
    lin = (cells[:, 0] * ny + cells[:, 1]) * nz + cells[:, 2]
    order = np.lexsort((idxs, d, lin))
    lin_s = lin[order]
    first = np.ones(len(order), bool)
    first[1:] = lin_s[1:] != lin_s[:-1]
    sel = order[first]
    phi_flat = phi.reshape(-1)
    cl_flat = closest.reshape(-1)
    phi_flat[lin[sel]] = d[sel]
    cl_flat[lin[sel]] = idxs[sel]

    # Native fast path (native/oracle.cpp) — identical semantics.
    from . import native as _native

    if _native.fs3_sweeps(nx, ny, nz, r, pc, phi, closest):
        return phi, closest

    def cls_inner(dx, dy, dz, x, y, z):
        other = closest[x + dx, y + dy, z + dz]
        if other > 0:  # sic: reference bug, particle 0 never propagates
            p = pc[other]
            dist = np.sqrt(
                (p[0] - x) ** 2 + (p[1] - y) ** 2 + (p[2] - z) ** 2
            ) - r
            if closest[x, y, z] < 0 or dist < phi[x, y, z]:
                closest[x, y, z] = other
                phi[x, y, z] = dist

    xr_f = range(nx)
    xr_b = range(nx - 1, -1, -1)
    yr_f = range(ny)
    yr_b = range(ny - 1, -1, -1)
    zr_f = range(nz)
    zr_b = range(nz - 1, -1, -1)

    # 8 octant sweeps (Simulation3D.cpp:307-416): (xdir, ydir, zdir) where
    # +1 = forward loop (looks at -1 neighbor), -1 = backward (looks at +1).
    for zdir, ydir, xdir in [
        (1, 1, 1), (1, 1, -1), (1, -1, 1), (1, -1, -1),
        (-1, 1, 1), (-1, 1, -1), (-1, -1, 1), (-1, -1, -1),
    ]:
        zs = zr_f if zdir == 1 else zr_b
        ys = yr_f if ydir == 1 else yr_b
        xs = xr_f if xdir == 1 else xr_b
        for z in zs:
            for y in ys:
                for x in xs:
                    if xdir == 1 and x != 0:
                        cls_inner(-1, 0, 0, x, y, z)
                    if xdir == -1 and x != nx - 1:
                        cls_inner(1, 0, 0, x, y, z)
                    if ydir == 1 and y != 0:
                        cls_inner(0, -1, 0, x, y, z)
                    if ydir == -1 and y != ny - 1:
                        cls_inner(0, 1, 0, x, y, z)
                    if zdir == 1 and z != 0:
                        cls_inner(0, 0, -1, x, y, z)
                    if zdir == -1 and z != nz - 1:
                        cls_inner(0, 0, 1, x, y, z)

    return phi, closest


def transfer_particles_to_grid(cfg: SimConfig, pos, vel):
    """Scatter P2G with trilinear hat weights + normalization + validity +
    full-grid extrapolation (Simulation3D.cpp:422-612).

    Returns (u, v, w).
    """
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    cpm = cfg.cells_per_meter
    p = pos * cpm  # == pos * m for the standard cpm == nx configs

    # Reference skips out-of-bounds with `px<-0.5 || px>nx+0.5`
    # (Simulation3D.cpp:446-450), so equality passes.
    keep = (
        (p[:, 0] >= -0.5) & (p[:, 0] <= nx + 0.5)
        & (p[:, 1] >= -0.5) & (p[:, 1] <= ny + 0.5)
        & (p[:, 2] >= -0.5) & (p[:, 2] <= nz + 0.5)
    )
    p = p[keep]
    pv = vel[keep]

    def scatter(comp_axis, shape):
        """Scatter one velocity component to its staggered grid."""
        acc = np.zeros(shape, np.float32)
        amt = np.zeros(shape, np.float32)
        # Base indices: the staggered axis uses floor(coord + 0.5), others floor.
        base = np.empty((len(p), 3), np.int64)
        alpha = np.empty((len(p), 3), np.float32)
        for ax in range(3):
            c = p[:, ax] + (0.5 if ax == comp_axis else 0.0)
            b = np.floor(c).astype(np.int64)
            base[:, ax] = b
            alpha[:, ax] = c - b
        for ox in (0, 1):
            for oy in (0, 1):
                for oz in (0, 1):
                    off = np.array([ox, oy, oz])
                    idx = base + off
                    # Bounds: staggered axis allows index == n (face on far
                    # wall); others require [0, n).
                    ok = np.ones(len(p), bool)
                    for ax, n in zip(range(3), (nx, ny, nz)):
                        if ax == comp_axis:
                            ok &= idx[:, ax] <= n
                            ok &= idx[:, ax] >= 0
                        else:
                            ok &= (idx[:, ax] >= 0) & (idx[:, ax] < n)
                    wgt = np.ones(len(p), np.float32)
                    for ax in range(3):
                        a = alpha[:, ax]
                        wgt = wgt * np.where(off[ax] > 0, a, 1.0 - a)
                    ii = idx[ok]
                    np.add.at(acc, (ii[:, 0], ii[:, 1], ii[:, 2]), wgt[ok] * pv[ok, comp_axis])
                    np.add.at(amt, (ii[:, 0], ii[:, 1], ii[:, 2]), wgt[ok])
        return acc, amt

    u, u_amt = scatter(0, (nx + 1, ny, nz))
    v, v_amt = scatter(1, (nx, ny + 1, nz))
    w, w_amt = scatter(2, (nx, ny, nz + 1))

    tiny = np.float64(np.finfo(np.float32).smallest_subnormal)
    u = (u / (tiny + u_amt)).astype(np.float32)
    v = (v / (tiny + v_amt)).astype(np.float32)
    w = (w / (tiny + w_amt)).astype(np.float32)

    zt = cfg.zero_thresh
    u_valid = u_amt > zt
    v_valid = v_amt > zt
    w_valid = w_amt > zt

    # Edges: wall-normal faces are zero and valid (Simulation3D.cpp:577-599).
    set_edge_velocities_to_zero(u, v, w)
    u_valid[0, :, :] = True
    u_valid[nx, :, :] = True
    v_valid[:, 0, :] = True
    v_valid[:, ny, :] = True
    w_valid[:, :, 0] = True
    w_valid[:, :, nz] = True

    extrapolate_values(u, u_valid)
    extrapolate_values(v, v_valid)
    extrapolate_values(w, w_valid)
    return u, v, w, u_valid, v_valid, w_valid


def extrapolate_values(src, valid):
    """Full-grid Manhattan-distance-bucket extrapolation, in place
    (Simulation3D.cpp:614-778).  Level-parallel processing is exact because
    every read neighbor has strictly smaller distance."""
    inf = np.int64(10**9)
    cd = np.where(valid, 0, inf)
    # 6 directional scans (x- x+ y- y+ z- z+)
    for ax, rev in [(0, False), (0, True), (1, False), (1, True), (2, False), (2, True)]:
        n = cd.shape[ax]
        rng = range(1, n) if not rev else range(n - 2, -1, -1)
        step = -1 if not rev else 1
        sl = [slice(None)] * 3
        sl2 = [slice(None)] * 3
        for i in rng:
            sl[ax] = i
            sl2[ax] = i + step
            cd[tuple(sl)] = np.minimum(cd[tuple(sl)], cd[tuple(sl2)] + 1)

    maxd = int(cd.max())
    for d in range(1, maxd + 1):
        mask = cd == d
        if not mask.any():
            continue
        num = np.zeros(src.shape, np.float32)
        tot = np.zeros(src.shape, np.float32)
        for ax in range(3):
            for s in (-1, 1):
                nb_cd = _shift(cd, ax, s, fill=inf)
                nb_v = _shift(src, ax, s, fill=0.0)
                use = nb_cd < d
                num += use
                tot += np.where(use, nb_v, 0.0)
        upd = mask & (num > 0)
        src[upd] = (tot[upd] / num[upd]).astype(src.dtype)
    return src


def _shift(a, ax, s, fill):
    """Shift array a by s along ax: result[i] = a[i + s], out-of-range = fill."""
    out = np.full_like(a, fill)
    src = [slice(None)] * a.ndim
    dst = [slice(None)] * a.ndim
    if s == 1:
        dst[ax] = slice(0, a.shape[ax] - 1)
        src[ax] = slice(1, None)
    else:
        dst[ax] = slice(1, None)
        src[ax] = slice(0, a.shape[ax] - 1)
    out[tuple(dst)] = a[tuple(src)]
    return out


def set_edge_velocities_to_zero(u, v, w):
    """Simulation3D.cpp:1140-1162."""
    u[0, :, :] = 0.0
    u[-1, :, :] = 0.0
    v[:, 0, :] = 0.0
    v[:, -1, :] = 0.0
    w[:, :, 0] = 0.0
    w[:, :, -1] = 0.0


def add_body_forces(cfg: SimConfig, v, dt):
    """v += g*dt on the whole V grid (Simulation3D.cpp:780-788: the CPU
    solver applies gravity to *all* V faces; edges are re-zeroed inside
    Project)."""
    v += np.float32(cfg.gravity_y * dt)
    return v


def project(cfg: SimConfig, u, v, w, phi, dt):
    """Pressure projection with ghost fluids + checkerboard SOR in float64
    (Simulation3D.cpp:790-1093).  Modifies u, v, w in place; returns p."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    maxr = cfg.max_ls_ratio
    dx = 1.0 / cfg.cells_per_meter
    scale = -dx * cfg.rho / dt

    phid = phi.astype(np.float64)
    fluid = phid < 0.0

    # RHS: b = scale * div(u), solid (edge) velocities treated as 0.
    b = scale * (
        u[1:, :, :].astype(np.float64) - u[:-1, :, :]
        + v[:, 1:, :] - v[:, :-1, :]
        + w[:, :, 1:] - w[:, :, :-1]
    )
    # Reference reads edge faces as solidVel=0 (Simulation3D.cpp:840-845);
    # our u/v/w edge faces are already zeroed by SetEdgeVelocitiesToZero,
    # which the reference guarantees too — identical.

    # Diagonal coefficients.
    diag = np.zeros((nx, ny, nz), np.float64)

    def ghost(axis, s):
        nb = _shift(phid, axis, s, fill=np.inf)  # fill value unused off-edge
        has_nb = np.ones_like(phid, bool)
        sl = [slice(None)] * 3
        sl[axis] = 0 if s == -1 else -1
        has_nb[tuple(sl)] = False
        term = np.where(has_nb, 1.0, 0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.clip(-nb / np.where(phid != 0.0, phid, 1e-300), 0.0, maxr)
        g = np.where(has_nb & (nb > 0.0), ratio, 0.0)
        return term + g

    for axis in range(3):
        for s in (-1, 1):
            diag += ghost(axis, s)
    diag = np.where(fluid, diag, 0.0)

    # Checkerboard SOR, float64 (Simulation3D.cpp:944-1001).
    omega = cfg.omega
    p = np.zeros((nx, ny, nz), np.float64)
    xg, yg, zg = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    parity = (xg + yg + zg) % 2

    def neighbor_minus_sum(p):
        s = np.zeros_like(p)
        for axis in range(3):
            for sh in (-1, 1):
                nb_fluid = _shift(fluid, axis, sh, fill=False)
                nb_p = _shift(p, axis, sh, fill=0.0)
                s -= np.where(nb_fluid, nb_p, 0.0)
        return s

    safe_diag = np.where(fluid, diag, 1.0)
    for _ in range(cfg.sor_iterations):
        for stage in (0, 1):
            nms = neighbor_minus_sum(p)
            upd = (1 - omega) * p + omega * (b - nms) / safe_diag
            mask = fluid & (parity == stage)
            p = np.where(mask, upd, p)

    # Pressure gradient -> velocity (4-case ghost fluid), float64 math cast
    # back to float32 (Simulation3D.cpp:1014-1084).
    set_edge_velocities_to_zero(u, v, w)
    scale2 = dt / (cfg.rho * dx)

    def apply(comp, grid, axis):
        phiL = phid
        phiR = _shift(phid, axis, 1, fill=0.0)  # unused at far edge
        pL = p
        pR = _shift(p, axis, 1, fill=0.0)
        # interior faces: grid index i+1 along axis, i in [0, n-2]
        both = (phiL < 0) & (phiR < 0)
        lonly = (phiL < 0) & (phiR >= 0)
        ronly = (phiL >= 0) & (phiR < 0)
        newv = np.zeros(phid.shape, np.float64)
        sl_face = [slice(None)] * 3
        sl_face[axis] = slice(1, grid.shape[axis] - 1)
        cur = grid[tuple(sl_face)].astype(np.float64)
        sl_cell = [slice(None)] * 3
        sl_cell[axis] = slice(0, phid.shape[axis] - 1)
        c = tuple(sl_cell)
        val = np.where(
            both[c],
            cur - scale2 * (pR[c] - pL[c]),
            np.where(
                lonly[c],
                cur + scale2 * (1 + np.clip(-phiR[c] / np.where(phiL[c] != 0, phiL[c], 1e-300), 0.0, maxr)) * pL[c],
                np.where(
                    ronly[c],
                    cur - scale2 * (1 + np.clip(-phiL[c] / np.where(phiR[c] != 0, phiR[c], 1e-300), 0.0, maxr)) * pR[c],
                    0.0,
                ),
            ),
        )
        grid[tuple(sl_face)] = val.astype(np.float32)

    apply(0, u, 0)
    apply(1, v, 1)
    apply(2, w, 2)
    return p


def divergence_stats(cfg: SimConfig, u, v, w, phi):
    """PrintDivergence (Simulation3D.cpp:1095-1138): (L2 norm, max, argmax)."""
    fluid = phi < 0.0
    div = (
        u[1:, :, :] - u[:-1, :, :]
        + v[:, 1:, :] - v[:, :-1, :]
        + w[:, :, 1:] - w[:, :, :-1]
    )
    div = np.where(fluid, div, 0.0)
    l2 = float(np.sqrt((div.astype(np.float64) ** 2).sum()))
    mx = float(div.max())
    arg = np.unravel_index(int(div.argmax()), div.shape)
    return l2, mx, arg


def flip_update(cfg: SimConfig, pos, vel, u, v, w, old_u, old_v, old_w, alpha):
    """Hybrid FLIP/PIC particle-velocity update via the diff-grid trick
    (Simulation3D.cpp:144-185): interpolate newgrid - (1-alpha)*oldgrid."""
    du = u - (1.0 - alpha) * old_u
    dv = v - (1.0 - alpha) * old_v
    dw = w - (1.0 - alpha) * old_w
    m = np.array([cfg.nx, cfg.ny, cfg.nz], np.float32)
    diff = np.stack(
        interp_mac(du, dv, dw, m[0] * pos[:, 0], m[1] * pos[:, 1], m[2] * pos[:, 2]),
        axis=-1,
    )
    return ((1.0 - alpha) * vel + diff).astype(np.float32)


class FluidSim3Ref:
    """Stateful oracle wrapper mirroring FluidSim3::Simulate
    (Simulation3D.cpp:101-188) with a configurable init."""

    def __init__(self, cfg: SimConfig, gpu_style_init: bool = True):
        self.cfg = cfg
        if gpu_style_init:
            # GPU path: zero grids, zero particle velocities (Simulation.cpp:66-68).
            self.pos, self.vel = dam_break_particles(cfg)
            self.u = np.zeros(cfg.u_shape(), np.float32)
            self.v = np.zeros(cfg.v_shape(), np.float32)
            self.w = np.zeros(cfg.w_shape(), np.float32)
        else:
            # CPU path: noise grids, particle velocities sampled from them,
            # all off one chained LCG stream (Simulation3D.cpp:41-98).
            from ..core.seeding import noise_grids

            self.u, self.v, self.w = noise_grids(cfg, seed=cfg.seed)
            n_grid = self.u.size + self.v.size + self.w.size
            # Particle jitter continues from the same chained stream
            # (Simulation3D.cpp:43 creates one generator for grids+particles).
            self.pos, _ = dam_break_particles(cfg, skip=n_grid)
            m = np.array([cfg.nx, cfg.ny, cfg.nz], np.float32)
            self.vel = np.stack(
                interp_mac(
                    self.u, self.v, self.w,
                    m[0] * self.pos[:, 0], m[1] * self.pos[:, 1], m[2] * self.pos[:, 2],
                ),
                axis=-1,
            ).astype(np.float32)
        self.phi = np.full(cfg.grid_shape(), np.inf, np.float32)

    def simulate(self, dt: float):
        cfg = self.cfg
        dt = float(np.clip(dt, 0.0, cfg.max_dt))
        self.pos = advect(cfg, self.u, self.v, self.w, self.pos, dt)
        alpha = float(
            np.clip(6 * dt * cfg.nu * cfg.cells_per_meter**2, 0.0, 1.0)
        )
        self.phi, _ = compute_level_set(cfg, self.pos)
        self.u, self.v, self.w, *_ = transfer_particles_to_grid(
            cfg, self.pos, self.vel
        )
        old_u, old_v, old_w = self.u.copy(), self.v.copy(), self.w.copy()
        add_body_forces(cfg, self.v, dt)
        project(cfg, self.u, self.v, self.w, self.phi, dt)
        self.vel = flip_update(
            cfg, self.pos, self.vel, self.u, self.v, self.w, old_u, old_v, old_w, alpha
        )
