"""Runtime metrics & stability guards.

Replaces the reference's odprintf anomaly prints and velocity-explosion
asserts (Simulation3D.cpp:166-175, SURVEY.md §4.5, §5.5) with structured
counters (steps/sec, particles/sec — the BASELINE metrics) and a device-side
NaN/explosion check usable inside or outside jit.
"""

from __future__ import annotations

import logging
import time

import jax.numpy as jnp
import numpy as np

log = logging.getLogger("fluidsimulation")


class Meter:
    """FPS/steps-per-second accounting (the reference shows frame stats in
    the window title, d3dApp.cpp:507 CalculateFrameStats)."""

    def __init__(self, num_particles: int):
        self.num_particles = num_particles
        self.t0 = time.perf_counter()
        self.steps = 0

    def tick(self, n: int = 1):
        self.steps += n

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def steps_per_sec(self) -> float:
        return self.steps / max(self.elapsed, 1e-9)

    @property
    def particles_per_sec(self) -> float:
        return self.steps_per_sec * self.num_particles

    def summary(self) -> str:
        return (
            f"{self.steps} steps in {self.elapsed:.2f}s = "
            f"{self.steps_per_sec:.2f} steps/s, "
            f"{self.particles_per_sec:.3e} particles/s"
        )


def velocity_guard(vel, limit: float = 1e5):
    """Device-side explosion flag, mirroring the reference's
    'Velocity was too high!' assert (Simulation3D.cpp:172-175).
    Returns a scalar bool array (True = healthy)."""
    return (jnp.abs(vel) < limit).all() & jnp.isfinite(vel).all()


def check_state(state, limit: float = 1e5) -> bool:
    """Host-side check; logs and returns False on anomaly."""
    ok = True
    for name in ("pos", "vel", "u", "v", "w", "phi"):
        a = np.asarray(getattr(state, name))
        if not np.isfinite(a).all():
            log.error("non-finite values in %s", name)
            ok = False
    if np.abs(np.asarray(state.vel)).max() > limit:
        log.error("velocity explosion (|v| > %g)", limit)
        ok = False
    return ok
