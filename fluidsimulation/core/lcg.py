"""Deterministic minstd LCG, replicated in NumPy.

The reference seeds its dam break with ``std::minstd_rand generator(0)`` +
``std::uniform_real_distribution<float>(-0.25f, 0.25f)`` (Simulation.cpp:40-41)
so that every reset is bit-identical.  STL ``uniform_real_distribution``
output is implementation-defined, so instead of chasing MSVC's exact stream we
re-implement the minstd engine (x <- 48271*x mod 2^31-1; seed 0 maps to 1 per
the linear_congruential_engine spec) with the canonical single-draw mapping
u = (x-1)/(m-1) -> lo + u*(hi-lo).  What matters — and what our tests enforce,
mirroring the reference's CPU<->GPU methodology (README.md:55) — is that the
NumPy oracle and the JAX path consume the *same* deterministic stream.
"""

from __future__ import annotations

import numpy as np

_M = 2147483647  # 2^31 - 1
_A = 48271


class MinstdRand:
    """std::minstd_rand-compatible LCG state machine."""

    def __init__(self, seed: int = 0):
        seed = seed % _M
        self.state = np.uint64(seed if seed != 0 else 1)

    def next_u32(self) -> int:
        self.state = (np.uint64(_A) * self.state) % np.uint64(_M)
        return int(self.state)

    def uniform(self, lo: float, hi: float) -> float:
        u = (self.next_u32() - 1) / (_M - 1)
        return np.float32(lo + u * (hi - lo))

    def uniform_array(self, n: int, lo: float, hi: float) -> np.ndarray:
        """Draw n floats as a vectorized batch (same stream as n calls)."""
        out = np.empty(n, dtype=np.uint64)
        s = self.state
        a = np.uint64(_A)
        m = np.uint64(_M)
        for i in range(n):
            s = (a * s) % m
            out[i] = s
        self.state = s
        u = (out.astype(np.float64) - 1.0) / (_M - 1)
        return (lo + u * (hi - lo)).astype(np.float32)


def _pow_mod(a: int, k: int, m: int) -> int:
    return pow(a, k, m)


def minstd_stream(n: int, seed: int = 0, skip: int = 0) -> np.ndarray:
    """Return n raw minstd states for `seed` after skipping `skip` draws.

    Uses block-stepping with a precomputed jump factor (a^B mod m) so seeding
    a ~1M-particle dam break doesn't take a Python-loop eternity.
    """
    seed = seed % _M
    s0 = seed if seed != 0 else 1
    if skip:
        s0 = (_pow_mod(_A, skip, _M) * s0) % _M
    # states[i] = a^(i+1) * s0 mod m.  Compute a^(i+1) via cumulative products
    # in exact integer arithmetic (object dtype would be slow; use repeated
    # squaring blocks of 2^16).
    out = np.empty(n, dtype=np.int64)
    s = s0
    # Block-fill: precompute a^1..a^B then jump by a^B.
    B = 4096
    apow = np.empty(B, dtype=np.int64)
    acc = 1
    for i in range(B):
        acc = (acc * _A) % _M
        apow[i] = acc
    jump = acc  # a^B mod m
    i = 0
    while i < n:
        k = min(B, n - i)
        out[i : i + k] = (apow[:k] * s) % _M
        s = (jump * s) % _M
        i += k
    return out


def minstd_uniform_stream(
    n: int, lo: float, hi: float, seed: int = 0, skip: int = 0
) -> np.ndarray:
    states = minstd_stream(n, seed, skip)
    u = (states.astype(np.float64) - 1.0) / (_M - 1)
    return (lo + u * (hi - lo)).astype(np.float32)
