"""fluidsimulation: a JAX (XLA + Pallas/Triton) rebuild of the hybrid
PIC/FLIP free-surface liquid simulator + raytraced renderer from
Nbickford/FluidSimulation.

Layers (mirroring SURVEY.md §1):
  core/       config, state pytrees, MAC interpolation, deterministic seeding
  ops/        the op set (one module per reference kernel group)
  solver/     step() composition (2D/3D) + NumPy CPU oracles in reference/
  render/     Shadertoy-style raytraced water renderer, vectorized over pixels
  parallel/   multi-chip sharding (mesh + shard_map + halo exchange)
  utils/      profiling (23-mark table), checkpointing, metrics
  app/        CLI demo loop
"""

from .core.config import SimConfig, SimConfig2D
from .core.state import SimState, init_state

__version__ = "0.1.0"
__all__ = ["SimConfig", "SimConfig2D", "SimState", "init_state"]
