"""Multi-card sharding (SURVEY.md §5.8).

The reference is single-GPU; its "communication backend" is the D3D11 command
queue.  The multi-chip story here is SPMD over a ``jax.sharding.Mesh``:

  * particles are data-parallel (block-sharded over the mesh axis) — the
    analogue of the reference's per-particle dispatch parallelism;
  * grids are spatially sharded over one grid axis (domain decomposition,
    sequence-parallel in spirit over space);
  * the whole step is compiled with ``jax.jit`` + ``NamedSharding``
    annotations and the GSPMD partitioner inserts the collectives
    (all-reduce for P2G scatter contributions crossing shard boundaries,
    halo exchanges for stencils, all-gather where particle interpolation
    reads the full grid).

Each grid is sharded along an axis whose size is a multiple of the mesh
(ny for u/w/phi, nz for v) so the staggered +1 dimensions never force
padding.  A hand-scheduled ``shard_map`` + ``ppermute`` halo-exchange path
for the SOR/sweep stages is the planned optimization once profiles justify
it (SURVEY.md §5.7).
"""

from __future__ import annotations

import functools

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.config import SimConfig
from ..core.state import SimState
from ..solver.step3d import step

AXIS = "grid"


def make_mesh(devices=None) -> Mesh:
    import numpy as np

    devices = devices if devices is not None else jax.devices()
    return Mesh(np.array(devices, dtype=object).reshape(-1), (AXIS,))


def state_shardings(mesh: Mesh) -> SimState:
    ns = lambda spec: NamedSharding(mesh, spec)
    return SimState(
        pos=ns(P(AXIS, None)),
        vel=ns(P(AXIS, None)),
        u=ns(P(None, AXIS, None)),
        v=ns(P(None, None, AXIS)),
        w=ns(P(None, AXIS, None)),
        phi=ns(P(None, AXIS, None)),
    )


def make_sharded_step(cfg: SimConfig, mesh: Mesh, fast: bool = True):
    """Returns a jitted step(state, dt) with sharded inputs/outputs."""
    sh = state_shardings(mesh)
    return jax.jit(
        functools.partial(step, cfg=cfg, fast=fast),
        in_shardings=(sh, None),
        out_shardings=sh,
    )


def shard_state(state: SimState, mesh: Mesh) -> SimState:
    import dataclasses

    # The AdvectCache is a single-chip fast-path construct (its packed-row
    # tables have no natural shard layout); sharded steps run the uncached
    # advect path, which is bit-identical.
    state = dataclasses.replace(state, cache=None)
    sh = state_shardings(mesh)
    return jax.tree.map(jax.device_put, state, sh)


# -- APIC extension family (solver/apic.py) ---------------------------------

def apic_state_shardings(mesh: Mesh):
    """ApicState shardings: SimState layout + data-parallel C rows."""
    from ..solver.apic import ApicState

    ns = lambda spec: NamedSharding(mesh, spec)
    return ApicState(
        pos=ns(P(AXIS, None)),
        vel=ns(P(AXIS, None)),
        C=ns(P(AXIS, None, None)),
        u=ns(P(None, AXIS, None)),
        v=ns(P(None, None, AXIS)),
        w=ns(P(None, AXIS, None)),
        phi=ns(P(None, AXIS, None)),
    )


def make_sharded_apic_step(cfg: SimConfig, mesh: Mesh, fast: bool = True):
    """Jitted APIC step(state, dt) with sharded inputs/outputs (GSPMD
    auto-partitioning, like make_sharded_step for the PIC/FLIP family)."""
    from ..solver.apic import step_apic

    sh = apic_state_shardings(mesh)
    return jax.jit(
        functools.partial(step_apic, cfg=cfg, fast=fast),
        in_shardings=(sh, None),
        out_shardings=sh,
    )


def shard_apic_state(state, mesh: Mesh):
    sh = apic_state_shardings(mesh)
    return jax.tree.map(jax.device_put, state, sh)
