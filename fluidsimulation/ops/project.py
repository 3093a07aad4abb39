"""Pressure projection: RHS, ghost-fluid diagonal, checkerboard SOR, and the
pressure-gradient velocity update.

JAX equivalents of gpProjectComputeRHS.hlsl,
gpProjectComputeDiagCoeffs.hlsl, gpProjectIteration{1,2}.hlsl (x100, under a
single ``lax.fori_loop`` instead of 200 dispatches), and gpProjectToVel.hlsl.
The checkerboard split makes the two masked half-updates exact Gauss-Seidel
(every neighbor of a red cell is black), so the vectorized simultaneous
update reproduces the serial CPU ordering bit-for-bit in exact arithmetic —
the remaining difference vs the CPU oracle is its float64 accumulation
(Simulation3D.cpp:827-829); the reference recorded 2.5e-3 absolute SOR
divergence at iteration 100 for its own f32 GPU path (Simulation.cpp:899-900).

omega = 2 - 3.16343/nx (Simulation.cpp:909); rho and dx as in
gpProjectComputeRHS.hlsl:18-21 (dx = 1/nx — the kernels assume
cells_per_meter == nx, replicated via cfg).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from .common import shift


def compute_rhs(cfg: SimConfig, u, v, w, dt):
    """b = -dx*rho/dt * div(u) per cell (gpProjectComputeRHS.hlsl)."""
    dx = 1.0 / cfg.cells_per_meter
    scale = jnp.float32(-dx * cfg.rho) / dt
    div = (
        u[1:, :, :] - u[:-1, :, :]
        + v[:, 1:, :] - v[:, :-1, :]
        + w[:, :, 1:] - w[:, :, :-1]
    )
    return scale * div


def compute_diag(cfg: SimConfig, phi):
    """Diagonal coefficients with ghost-fluid terms
    (gpProjectComputeDiagCoeffs.hlsl).  Air cells get 1.0 (never read)."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    maxr = jnp.float32(cfg.max_ls_ratio)
    fluid = phi < 0.0

    # Number of non-solid (in-domain) neighbors: 3 + one per non-edge axis.
    def interior(n, axis):
        i = jnp.arange(n)
        e = (i > 0) & (i < n - 1)
        sh = [1, 1, 1]
        sh[axis] = n
        return e.reshape(sh)

    num = (
        3.0
        + interior(nx, 0).astype(jnp.float32)
        + interior(ny, 1).astype(jnp.float32)
        + interior(nz, 2).astype(jnp.float32)
    )
    num = jnp.broadcast_to(num, phi.shape)

    # Ghost-fluid terms; out-of-bounds phi reads are 0 (HLSL OOB semantics)
    # which clamp to 0 contribution.
    recip = 1.0 / jnp.where(fluid, phi, -1.0)  # safe: only used where fluid
    ghost = jnp.zeros_like(phi)
    for axis in range(3):
        for s in (-1, 1):
            nb = shift(phi, axis, s, 0.0)
            ghost = ghost + jnp.clip(-nb * recip, 0.0, maxr)
    return jnp.where(fluid, num + ghost, 1.0)


def sor_pressure(cfg: SimConfig, phi, diag, b, iterations: int | None = None):
    """Checkerboard SOR (gpProjectIteration1/2.hlsl, 100 iterations)."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    omega = jnp.float32(cfg.omega)
    iters = cfg.sor_iterations if iterations is None else iterations
    fluid = phi < 0.0

    xg = jnp.arange(nx)[:, None, None]
    yg = jnp.arange(ny)[None, :, None]
    zg = jnp.arange(nz)[None, None, :]
    parity = (xg + yg + zg) % 2

    nb_fluid = [
        shift(fluid, axis, s, False) for axis in range(3) for s in (-1, 1)
    ]

    def half_update(p, color):
        nms = jnp.zeros_like(p)
        k = 0
        for axis in range(3):
            for s in (-1, 1):
                nb_p = shift(p, axis, s, 0.0)
                nms = nms - jnp.where(nb_fluid[k], nb_p, 0.0)
                k += 1
        upd = (1.0 - omega) * p + omega * (b - nms) / diag
        return jnp.where(fluid & (parity == color), upd, p)

    def body(_, p):
        p = half_update(p, 0)
        p = half_update(p, 1)
        return p

    p0 = jnp.zeros_like(b)
    return jax.lax.fori_loop(0, iters, body, p0)


def apply_pressure(cfg: SimConfig, u, v, w, p, phi, dt):
    """Pressure-gradient velocity update with 4-case ghost-fluid handling
    (gpProjectToVel.hlsl).  Domain-edge faces are untouched (they are already
    zero from the transfer/force stages)."""
    maxr = jnp.float32(cfg.max_ls_ratio)
    dx = 1.0 / cfg.cells_per_meter
    scale = dt / jnp.float32(cfg.rho * dx)

    def update(grid, axis):
        n = phi.shape[axis]
        slA = [slice(None)] * 3
        slA[axis] = slice(0, n - 1)
        slB = [slice(None)] * 3
        slB[axis] = slice(1, n)
        phiL = phi[tuple(slA)]
        phiR = phi[tuple(slB)]
        pL = p[tuple(slA)]
        pR = p[tuple(slB)]
        slF = [slice(None)] * 3
        slF[axis] = slice(1, n)  # interior faces 1..n-1
        cur = grid[tuple(slF)]

        safeL = jnp.where(phiL != 0.0, phiL, -1e-30)
        safeR = jnp.where(phiR != 0.0, phiR, -1e-30)
        both = cur - scale * (pR - pL)
        lonly = cur + scale * pL * (1.0 + jnp.clip(-phiR / safeL, 0.0, maxr))
        ronly = cur - scale * pR * (1.0 + jnp.clip(-phiL / safeR, 0.0, maxr))
        val = jnp.where(
            phiL < 0.0,
            jnp.where(phiR < 0.0, both, lonly),
            jnp.where(phiR < 0.0, ronly, 0.0),
        )
        return grid.at[tuple(slF)].set(val)

    return update(u, 0), update(v, 1), update(w, 2)


def project(cfg: SimConfig, u, v, w, phi, dt, iterations: int | None = None):
    """Full projection stage (GPFluidSim::ProjectGPU, Simulation.cpp:860-943).

    Returns (u, v, w, p).
    """
    b = compute_rhs(cfg, u, v, w, dt)
    diag = compute_diag(cfg, phi)
    p = sor_pressure(cfg, phi, diag, b, iterations)
    u, v, w = apply_pressure(cfg, u, v, w, p, phi, dt)
    return u, v, w, p
