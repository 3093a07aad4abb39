"""Compiled-HLO collective counting: regression pins for the engineered
communication budgets.

The halo step's collective counts (docs/PARALLEL.md: 84 permute / 14 AG /
20 a2a / 0 AR at 32³/D=8 vs GSPMD's 447 / 56+ / 347 / 29) were verified by
hand; these helpers let tests assert them so a refactor that silently falls
back to GSPMD all-to-alls fails CI.

Counting convention: every HLO token of a collective family counts — the
async `-start`/`-done` forms count as separate tokens, matching how the
docs/PARALLEL.md table was counted.  Counts are per compiled TEXT, so a permute inside a `while` body
counts once however many iterations execute.
"""

from __future__ import annotations

import collections
import re

FAMILIES = (
    "collective-permute",
    "all-gather",
    "all-reduce",
    "all-to-all",
    "reduce-scatter",
)

_TOKEN = re.compile(
    r"(" + "|".join(FAMILIES) + r")[-.\w]*"
)


def collective_counts(compiled_text: str) -> dict[str, int]:
    """Token counts per collective family in compiled HLO text."""
    c = collections.Counter(
        m.group(1) for m in _TOKEN.finditer(compiled_text)
    )
    return {name: c.get(name, 0) for name in FAMILIES}


def compiled_collectives(fn, *args) -> dict[str, int]:
    """Compile ``fn`` for ``args`` and count its collectives."""
    import jax

    return collective_counts(jax.jit(fn).lower(*args).compile().as_text())


# StableHLO spells the same families with underscores
# (stablehlo.collective_permute, stablehlo.all_gather, ...).  Anchor each
# name so the generic stablehlo.gather / stablehlo.reduce data ops can't
# match a collective family.
_STABLEHLO_TOKEN = re.compile(
    r"stablehlo\.(collective_permute|all_gather|all_reduce|all_to_all|"
    r"reduce_scatter)\b"
)

_US_TO_DASH = {
    "collective_permute": "collective-permute",
    "all_gather": "all-gather",
    "all_reduce": "all-reduce",
    "all_to_all": "all-to-all",
    "reduce_scatter": "reduce-scatter",
}


def lowered_collective_counts(stablehlo_text: str) -> dict[str, int]:
    """Token counts per collective family in LOWERED (pre-compile)
    StableHLO text, keyed with the same dashed names as
    collective_counts."""
    c = collections.Counter(
        m.group(1) for m in _STABLEHLO_TOKEN.finditer(stablehlo_text)
    )
    return {
        dash: c.get(us, 0) for us, dash in _US_TO_DASH.items()
    }


def lowered_collectives(fn, *args) -> dict[str, int]:
    """Trace+lower ``fn`` for ``args`` (NO XLA compile) and count its
    explicit collectives.  ~6x cheaper than compiled_collectives on the
    8-device CPU mesh (7 s vs 42 s for the 32³ halo step) because it skips
    SPMD partitioning and optimization.  The engineered halo steps emit
    their collectives explicitly via shard_map, so they are visible here;
    a refactor that silently falls back to GSPMD auto-partitioning loses
    them from the lowered text (GSPMD inserts collectives only at compile
    time) and an exact pin on these counts fails.  Counts differ slightly
    from the compiled text (e.g. 81 lowered vs 84 compiled permutes for
    the FLIP halo step: compile-time splitting), so pins must be
    re-baselined per layer; the compiled-text pins remain the number of
    record (docs/PARALLEL.md) and live in the slow tier."""
    import jax

    return lowered_collective_counts(jax.jit(fn).lower(*args).as_text())
