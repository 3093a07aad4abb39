"""Level-set sweeps as Pallas kernels for the GPU (Triton route).

The XLA formulation (ops/levelset.sweep_closest) runs each of the 24
directional sweeps as a ``lax.scan`` over the swept axis: n-1 dependent
loop trips per sweep, each at least one kernel launch plus loop control
on the GPU.  Here each sweep is ONE kernel in the reference's layout, one
thread per grid line (gpClosestParticlesSweepXm.hlsl:20-42): a program
owns a block of lines, each lane walks its line along the swept axis and
carries its candidate position in registers.  The update rule is
``levelset._sweep_axis``'s (gpClosestParticlesSweepXm.hlsl:24-42).

Layout: phi and the three candidate components are separate flat
row-major (nx, ny, nz) arrays for the whole 24-sweep chain (one split of
the (..., 3) candidate field on entry, one stack on exit), so lanes that
walk x- or y-lines read consecutive z addresses (coalesced).  Lanes of a
z-sweep each walk one contiguous line; their next element is in the cache
line the previous step brought in.  Each sweep updates its four arrays in
place (``input_output_aliases``): every element is read and written by
exactly one lane, and the first plane of each line is never written.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.config import SimConfig
from .levelset import _CODE, SWEEP_ORDER

# Lines per program and warps per program (one lane per line).  A block of
# 32 lines keeps >= 128 programs in flight at 64^3 (4,096 lines/sweep); it
# was the fastest of 32/64/128/256 lines on an H100 at 64^3 and 128^3.
BLOCK_LINES = 32
NUM_WARPS = 1


def _sweep_kernel(phi_in, cx_in, cy_in, cz_in, phi_out, cx_out, cy_out,
                  cz_out, *, dims, axis, reverse, r, block):
    n = dims[axis]
    b, c = (k for k in range(3) if k != axis)
    strides = (dims[1] * dims[2], dims[2], 1)
    n_lines = dims[b] * dims[c]

    line = pl.program_id(0) * block + jnp.arange(block, dtype=jnp.int32)
    mask = line < n_lines
    line = jnp.where(mask, line, 0)
    ib, ic = line // dims[c], line % dims[c]
    base = ib * strides[b] + ic * strides[c]
    fb, fc = ib.astype(jnp.float32), ic.astype(jnp.float32)

    def plane(k):
        return (n - 1 - k) if reverse else k

    def load(ref, off):
        return plgpu.load(ref.at[off], mask=mask, other=0.0)

    def load4(k):
        off = base + plane(k) * strides[axis]
        return tuple(load(ref, off) for ref in (phi_in, cx_in, cy_in, cz_in))

    # The candidate components are named by grid axis (x, y, z); the lane's
    # cell centre is (s, fb, fc) permuted back to (x, y, z).
    def dist2(cand, s):
        centre = [None, None, None]
        centre[axis], centre[b], centre[c] = s, fb, fc
        dx = cand[0] - centre[0]
        dy = cand[1] - centre[1]
        dz = cand[2] - centre[2]
        return dx * dx + dy * dy + dz * dz

    first = load4(0)

    def body(k, carry):
        cand, cur = carry
        # Issue the next plane's loads before this plane's arithmetic so
        # their latency overlaps it (the last trip re-reads its own plane).
        nxt = load4(jnp.minimum(k + 1, n - 1))
        phi_p, ox, oy, oz = cur
        s = plane(k)
        d = jnp.sqrt(dist2(cand, s.astype(jnp.float32))) - r
        better = d < phi_p
        off = base + s * strides[axis]
        new = tuple(jnp.where(better, cc, o)
                    for cc, o in zip(cand, (ox, oy, oz)))
        plgpu.store(phi_out.at[off], jnp.where(better, d, phi_p), mask=mask)
        for ref, val in zip((cx_out, cy_out, cz_out), new):
            plgpu.store(ref.at[off], val, mask=mask)
        return new, nxt

    jax.lax.fori_loop(1, n, body, (first[1:], load4(1)))


def _sweep(fields, dims, axis, reverse, r, *, interpret):
    n_lines = dims[0] * dims[1] * dims[2] // dims[axis]
    kernel = functools.partial(
        _sweep_kernel, dims=dims, axis=axis, reverse=reverse, r=r,
        block=BLOCK_LINES,
    )
    return pl.pallas_call(
        kernel,
        grid=(pl.cdiv(n_lines, BLOCK_LINES),),
        out_shape=tuple(jax.ShapeDtypeStruct(f.shape, f.dtype)
                        for f in fields),
        input_output_aliases={0: 0, 1: 1, 2: 2, 3: 3},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name=f"levelset_sweep_{'xyz'[axis]}{'p' if reverse else 'm'}",
    )(*fields)


def sweep_closest_pallas(cfg: SimConfig, phi, cpos, *,
                         interpret: bool = False):
    """All 24 sweeps in the reference order (Simulation.cpp:744-753);
    equivalent to ops/levelset.sweep_closest.  ``interpret=True`` runs the
    kernels in the Pallas interpreter (tests on the CPU)."""
    dims = tuple(phi.shape)
    if dims != (cfg.nx, cfg.ny, cfg.nz) or cpos.shape != (*dims, 3):
        raise ValueError(f"phi {phi.shape} / cpos {cpos.shape} do not match "
                         f"the grid {(cfg.nx, cfg.ny, cfg.nz)}")
    r = float(cfg.particle_radius)
    fields = (phi.reshape(-1),) + tuple(
        cpos[..., i].reshape(-1) for i in range(3)
    )
    for code in SWEEP_ORDER:
        axis, reverse = _CODE[code]
        fields = _sweep(fields, dims, axis, reverse, r, interpret=interpret)
    phi = fields[0].reshape(dims)
    cpos = jnp.stack([f.reshape(dims) for f in fields[1:]], axis=-1)
    return phi, cpos
