"""Profile a few fast steps on the GPU and reduce the trace to stage times.

    python scripts/trace_step.py [--grid 128] [--ppc 1] [--steps 5] \
        [--out chiprun_out/trace]

Warms the step up, traces ``--steps`` steps with ``jax.profiler``, then
reads the ``.xplane.pb`` back and prints one JSON object: the device
window, its busy and idle share (union of kernel intervals on the GPU's
stream lines), the idle gaps, the device time per step stage (the
``jax.named_scope`` names of solver/step3d.step) and the top operations.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import re
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STAGES = ("advect", "bin", "levelset", "p2g", "extrapolate", "project",
          "flip", "blur")


def hlo_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> its op_name metadata (the named-scope path).
    GPU kernel events carry the name of the instruction they run; a fusion
    instruction often has no metadata of its own, so it takes the first
    op_name inside the computation it calls."""
    scopes, comp_scope, calls = {}, {}, {}
    comp = None
    for line in hlo_text.splitlines():
        head = re.match(r"^(?:ENTRY )?%?([\w.\-]+) .*\{$", line)
        if head:
            comp = head.group(1)
            continue
        inst = re.match(r"^\s*(?:ROOT )?%?([\w.\-]+) = ", line)
        if not inst:
            continue
        op = re.search(r'op_name="([^"]*)"', line)
        if op:
            scopes.setdefault(inst.group(1), op.group(1))
            comp_scope.setdefault(comp, op.group(1))
        callee = re.search(r"calls=%?([\w.\-]+)", line)
        if callee:
            calls[inst.group(1)] = callee.group(1)
    for name, callee in calls.items():
        if name not in scopes and callee in comp_scope:
            scopes[name] = comp_scope[callee]
    # Kernel names are the instruction names with '.' and '-' made '_'.
    return {re.sub(r"[.\-]", "_", k): v for k, v in scopes.items()}


def stage_of(name: str, scopes: dict) -> str:
    path = scopes.get(name, "")
    for stage in STAGES:
        if f"/{stage}/" in path or path.endswith(f"/{stage}"):
            return stage
    if name.startswith("levelset_sweep"):
        return "levelset"
    return "other" if path else "unmapped"


def reduce_trace(path: str, n_steps: int, scopes: dict) -> dict:
    from jax.profiler import ProfileData

    data = ProfileData.from_file(path)
    kernels = []
    lines_seen = {}
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            events = list(line.events)
            lines_seen[f"{plane.name}:{line.name}"] = len(events)
            if line.name.startswith("Stream"):
                kernels.extend(events)
    if not kernels:
        return {"error": "no kernel events on GPU stream lines",
                "lines": lines_seen}
    kernels.sort(key=lambda e: e.start_ns)
    start, end = kernels[0].start_ns, max(e.end_ns for e in kernels)
    busy, gaps, cur_s, cur_e = 0.0, [], kernels[0].start_ns, kernels[0].end_ns
    for e in kernels[1:]:
        if e.start_ns > cur_e:
            busy += cur_e - cur_s
            gaps.append(e.start_ns - cur_e)
            cur_s, cur_e = e.start_ns, e.end_ns
        else:
            cur_e = max(cur_e, e.end_ns)
    busy += cur_e - cur_s
    window = end - start
    by_stage = collections.Counter()
    by_name = collections.Counter()
    count = collections.Counter()
    for e in kernels:
        by_stage[stage_of(e.name, scopes)] += e.duration_ns
        by_name[e.name] += e.duration_ns
        count[e.name] += 1
    gaps.sort(reverse=True)
    ms = 1e-6
    return {
        "steps": n_steps,
        "window_ms": window * ms,
        "busy_ms": busy * ms,
        "idle_share": 1.0 - busy / window,
        "gaps_over_20us": sum(1 for g in gaps if g > 20_000),
        "idle_in_gaps_over_20us_ms": sum(g for g in gaps if g > 20_000) * ms,
        "largest_gaps_ms": [g * ms for g in gaps[:5]],
        "device_ms_per_step_by_stage": {
            k: v * ms / n_steps for k, v in by_stage.most_common()},
        "top_ops_ms_per_step": [
            (name, t * ms / n_steps, count[name] // n_steps)
            for name, t in by_name.most_common(25)],
        "kernel_launches_per_step": len(kernels) / n_steps,
        "lines": lines_seen,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--ppc", type=int, default=1)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--out", default="chiprun_out/trace")
    args = ap.parse_args(argv)

    import jax

    from fluidsimulation.core.config import SimConfig
    from fluidsimulation.core.state import init_state
    from fluidsimulation.solver.step3d import clamp_dt, step_jit
    from fluidsimulation.utils.cache import enable_compilation_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU, found {dev.platform}", file=sys.stderr)
        return 1
    enable_compilation_cache()
    g = args.grid
    cfg = SimConfig(nx=g, ny=g, nz=g, cells_per_meter=float(g),
                    particles_per_cell_axis=args.ppc)
    dt = clamp_dt(cfg, 1.0 / 60.0, 0.5)
    state = jax.device_put(init_state(cfg), dev)
    for _ in range(3):
        state = step_jit(state, dt, cfg)
    jax.block_until_ready(state)
    hlo = step_jit.lower(state, dt, cfg).compile().as_text()
    scopes = hlo_scopes(hlo)

    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    with jax.profiler.trace(args.out):
        for i in range(args.steps):
            with jax.profiler.StepTraceAnnotation("step", step_num=i):
                state = step_jit(state, dt, cfg)
        jax.block_until_ready(state)
    host_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    paths = sorted(glob.glob(os.path.join(args.out, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    summary = reduce_trace(paths[-1], args.steps, scopes)
    summary.update(grid=g, particles=cfg.num_particles,
                   traced_host_ms_per_step=host_ms, device=dev.device_kind)
    with open(os.path.join(args.out, "step_hlo.txt"), "w") as f:
        f.write(hlo)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
