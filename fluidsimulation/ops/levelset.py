"""Level set / closest-particle computation (seeding + 24 fast sweeps).

JAX equivalent of gpComputeClosestParticleNeighbors.hlsl + the 24
gpClosestParticlesSweep{X,Y,Z}{m,p}.hlsl dispatches (Simulation.cpp:718-798).

Design (SURVEY.md §5.7): instead of carrying *particle indices* plus a binned
particle buffer (the GPU's groupshared-cached neighborhood scan), each cell
carries the *position* of its current closest particle candidate — the only
thing the sweep update actually needs.  Seeding then becomes:

  1. scatter-argmin of each particle into its own cell (segment-min of
     distance, min-index tie-break, matching the reference's first-wins
     strict-< update), then
  2. one vectorized 27-neighborhood pass taking the best *per-neighbor-cell
     candidate* — the same per-cell-best granularity the GPU sweeps
     themselves use.  (The GPU seeding pass scans every particle in the
     neighborhood rather than each neighbor's best; both produce upper
     bounds of the true distance that agree near the interface — the region
     the ghost-fluid projection reads.  Documented divergence.)

The 24 directional sweeps (8 octant triples, "Fast Occlusion Sweeping" order,
Simulation.cpp:744-753) become ``lax.scan``s along the swept axis with the
orthogonal plane vectorized — the GPU's plane-of-threads layout
(gpClosestParticlesSweepXm.hlsl:20-42).  On an NVIDIA GPU the step runs
them as Triton kernels instead (ops/pallas_sweep.py, sweep_closest_fast).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.config import SimConfig
from .common import cell_of

# Far-away sentinel for cells with no candidate.  Using a large finite value
# instead of +inf keeps distance arithmetic NaN-free; any real candidate beats
# it.  (The GPU leaves stale closest-particle indices in unseeded cells and
# +inf in phi — also an upper bound; same convergence, see SURVEY.md §2.2.)
FAR = 1.0e9


def seed_closest(cfg: SimConfig, pos):
    """Per-cell closest-particle seeding.

    Returns (phi, cpos): phi (nx,ny,nz) f32 in cell units, cpos (nx,ny,nz,3)
    f32 candidate particle positions in cell units (FAR where none).
    """
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    r = jnp.float32(cfg.particle_radius)
    m = jnp.array([nx, ny, nz], jnp.float32)
    pc = pos * m
    cell = cell_of(pc)
    lin = cell[:, 0] + nx * (cell[:, 1] + ny * cell[:, 2])
    ncells = nx * ny * nz

    d = jnp.sqrt(((pc - cell.astype(jnp.float32)) ** 2).sum(axis=-1)) - r

    # Scatter-min distances, then min-index tie-break to pick the winner.
    best_d = jnp.full(ncells, jnp.inf, jnp.float32).at[lin].min(d)
    n = pos.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    is_winner = d == best_d[lin]
    big = jnp.int32(2**31 - 1)
    win_idx = (
        jnp.full(ncells, big, jnp.int32)
        .at[lin]
        .min(jnp.where(is_winner, idx, big))
    )
    seeded = win_idx != big
    safe_idx = jnp.where(seeded, win_idx, 0)
    cpos0 = jnp.where(seeded[:, None], pc[safe_idx], FAR)

    phi0 = jnp.where(seeded, best_d, jnp.inf).reshape(nz, ny, nx).transpose(2, 1, 0)
    # note: lin is x-fastest; reshape accordingly
    cpos0 = cpos0.reshape(nz, ny, nx, 3).transpose(2, 1, 0, 3)
    return neighborhood_pass(cfg, cpos0)


def neighborhood_pass(cfg: SimConfig, cpos0):
    """27-neighborhood candidate pass
    (gpComputeClosestParticleNeighbors.hlsl:89-109): each cell considers
    every neighbor cell's own-cell best candidate."""
    nx, ny, nz = cfg.nx, cfg.ny, cfg.nz
    r = jnp.float32(cfg.particle_radius)
    xg = jnp.arange(nx, dtype=jnp.float32)[:, None, None]
    yg = jnp.arange(ny, dtype=jnp.float32)[None, :, None]
    zg = jnp.arange(nz, dtype=jnp.float32)[None, None, :]
    center = jnp.stack(jnp.broadcast_arrays(xg, yg, zg), axis=-1)

    cpad = jnp.pad(
        cpos0, ((1, 1), (1, 1), (1, 1), (0, 0)), constant_values=FAR
    )
    phi = jnp.full((nx, ny, nz), jnp.inf, jnp.float32)
    cpos = jnp.full((nx, ny, nz, 3), FAR, jnp.float32)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                cand = cpad[
                    1 + dx : 1 + dx + nx,
                    1 + dy : 1 + dy + ny,
                    1 + dz : 1 + dz + nz,
                ]
                dist = (
                    jnp.sqrt(((cand - center) ** 2).sum(axis=-1)) - r
                )
                better = dist < phi
                phi = jnp.where(better, dist, phi)
                cpos = jnp.where(better[..., None], cand, cpos)
    return phi, cpos


def _sweep_axis(phi, cpos, r, axis: int, reverse: bool):
    """One directional sweep: scan along `axis`, vectorized over the plane.

    Semantics of gpClosestParticlesSweepXm.hlsl:24-42: carry the previous
    cell's candidate down the line; overwrite a cell when the carried
    candidate is strictly closer, otherwise adopt the cell's candidate as the
    new carry.
    """
    n = phi.shape[axis]
    phi_m = jnp.moveaxis(phi, axis, 0)
    cpos_m = jnp.moveaxis(cpos, axis, 0)
    if reverse:
        phi_m = phi_m[::-1]
        cpos_m = cpos_m[::-1]

    a, b = phi_m.shape[1], phi_m.shape[2]
    # Plane coordinates: for the plane at scan position i, the swept-axis
    # coordinate is (i) or (n-1-i) when reversed; the other two coordinates
    # form a static grid.
    axes = [0, 1, 2]
    other = [ax for ax in axes if ax != axis]
    og = jnp.stack(
        jnp.meshgrid(
            jnp.arange(a, dtype=jnp.float32),
            jnp.arange(b, dtype=jnp.float32),
            indexing="ij",
        ),
        axis=-1,
    )  # (a, b, 2) coordinates of the two non-swept axes

    steps = jnp.arange(1, n, dtype=jnp.float32)
    if reverse:
        steps = jnp.float32(n - 1) - steps

    def line_coord(s):
        # Full 3D cell-center coordinates of the plane at swept coord s.
        coords = [None, None, None]
        coords[axis] = jnp.full((a, b), s)
        coords[other[0]] = og[..., 0]
        coords[other[1]] = og[..., 1]
        return jnp.stack(coords, axis=-1)

    def f(carry, inp):
        phi_p, cpos_p, s = inp
        center = line_coord(s)
        d = jnp.sqrt(((carry - center) ** 2).sum(axis=-1)) - r
        better = d < phi_p
        phi2 = jnp.where(better, d, phi_p)
        cpos2 = jnp.where(better[..., None], carry, cpos_p)
        carry2 = jnp.where(better[..., None], carry, cpos_p)
        return carry2, (phi2, cpos2)

    carry0 = cpos_m[0]
    _, (phi_rest, cpos_rest) = jax.lax.scan(
        f, carry0, (phi_m[1:], cpos_m[1:], steps)
    )
    phi_m = jnp.concatenate([phi_m[:1], phi_rest], axis=0)
    cpos_m = jnp.concatenate([cpos_m[:1], cpos_rest], axis=0)
    if reverse:
        phi_m = phi_m[::-1]
        cpos_m = cpos_m[::-1]
    return jnp.moveaxis(phi_m, 0, axis), jnp.moveaxis(cpos_m, 0, axis)


# Sweep direction table (Simulation.cpp:744-753).  Codes: 0=Xm 1=Xp 2=Ym
# 3=Yp 4=Zm 5=Zp; "m" scans forward (looking at -1), "p" scans backward.
SWEEP_ORDER = [
    0, 2, 4,
    1, 2, 4,
    0, 3, 4,
    1, 3, 4,
    0, 2, 5,
    1, 2, 5,
    0, 3, 5,
    1, 3, 5,
]

_CODE = {
    0: (0, False),
    1: (0, True),
    2: (1, False),
    3: (1, True),
    4: (2, False),
    5: (2, True),
}


def sweep_closest(cfg: SimConfig, phi, cpos):
    """Run the 24 directional sweeps in the reference order."""
    r = jnp.float32(cfg.particle_radius)
    for code in SWEEP_ORDER:
        axis, reverse = _CODE[code]
        phi, cpos = _sweep_axis(phi, cpos, r, axis, reverse)
    return phi, cpos


def sweep_closest_fast(cfg: SimConfig, phi, cpos):
    """The 24 sweeps as each platform runs them fastest: the Triton kernels
    of ops/pallas_sweep.py when lowered for an NVIDIA GPU, the scans of
    sweep_closest everywhere else.  The choice is made at lowering time
    from the platform the program is compiled for, so it holds for arrays
    placed on any backend and for any number of visible devices."""
    from .pallas_sweep import sweep_closest_pallas

    return jax.lax.platform_dependent(
        phi, cpos,
        cuda=functools.partial(sweep_closest_pallas, cfg),
        default=functools.partial(sweep_closest, cfg),
    )


def compute_level_set(cfg: SimConfig, pos):
    """Full level-set stage: clear + seed + 24 sweeps.

    Returns (phi, cpos).
    """
    phi, cpos = seed_closest(cfg, pos)
    return sweep_closest(cfg, phi, cpos)
