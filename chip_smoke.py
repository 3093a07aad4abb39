"""Smoke test of the simulator on one NVIDIA GPU.

    python chip_smoke.py               # phases 1-5 on one card
    python chip_smoke.py --four-cards  # phase 6 only, on four cards
    python chip_smoke.py --rehearse    # the same code paths on the CPU at
                                       # tiny sizes; never prints the ok line
                                       # (add XLA_FLAGS=--xla_force_host_
                                       # platform_device_count=4 with
                                       # --four-cards)

Phases, all in this process except where noted:

1. Device: JAX's first device must be a GPU (no CPU fallback); prints its
   kind and ``nvidia-smi``'s name and power limit (read in a child that
   does not use JAX).
2. Main path: the demo's dam break (64^3, 953,312 particles, dt = 1/60 at
   rate 0.5) for 30 steps with an exact 800x600 frame every 10, through the
   demo's own step and draw functions; then 10 steps of bench.py's
   configuration (128^3, 1,000,188 particles).  Fails on a non-finite or
   exploding state or a frame with fewer than 1,000 colours.
3. Parity: one step and its stages from the same state on the GPU and on
   this process's CPU backend, held to the tolerances of docs/PARITY.md;
   the atomic scatter P2G (fast=False) at 32^3 held to a reduction-reorder
   bound, run against itself and against the CPU.
4. Kernels: the Triton level-set sweep kernel against the XLA scans at
   64^3 and 128^3, alone and as the whole step (interleaved A/B).
5. Card-only tests: ``pytest -m gpu`` in a child that ends before this
   process first touches JAX.
6. ``--four-cards``: the explicit halo step, the GSPMD step and the
   tile-sharded frame on a 1-D mesh of four cards at 128^3 (ppc 1),
   against the single-card step on one of those cards.

The last line of standard output is the JSON result; it is printed only
when every phase passed.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import subprocess
import sys
import time
from unittest import mock

REPO = os.path.dirname(os.path.abspath(__file__))
DEMO_DT, DEMO_RATE = 1.0 / 60.0, 0.5
MIN_COLOURS = 1000  # an exact frame of the dam break has thousands


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def say(*parts) -> None:
    print(*parts, flush=True)


# -- phase 1 (host part) and phase 5: children that stay off JAX ------------

def card_name_and_power() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeFailure(f"nvidia-smi failed: {e}") from e
    check(out.returncode == 0 and out.stdout.strip() != "",
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def run_card_tests() -> None:
    """The GPU-marked tests, in a child that exits before this process
    opens the card (a JAX process reserves most of the card's memory)."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-rs",
         "-p", "no:cacheprovider", "tests/"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=900,
    )
    lines = out.stdout.strip().splitlines() or ["(no output)"]
    say("card tests:", lines[-1])
    check(out.returncode == 0 and "passed" in lines[-1]
          and "skipped" not in lines[-1],
          "GPU-marked tests failed or skipped:\n"
          + "\n".join(lines[-30:]) + out.stderr[-2000:])


# -- helpers -----------------------------------------------------------------

def _block(x):
    import jax

    return jax.block_until_ready(x)


def median_ms(fn, *args, n: int = 20) -> float:
    import numpy as np

    _block(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        _block(fn(*args))
        ts.append(time.perf_counter() - t0)
    return 1e3 * float(np.median(ts))


def n_colours(img) -> int:
    import numpy as np

    arr = (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return len(np.unique(arr.reshape(-1, 3), axis=0))


def dam_break(grid: int, ppc: int):
    from fluidsimulation.core.config import SimConfig

    return SimConfig(nx=grid, ny=grid, nz=grid, cells_per_meter=float(grid),
                     particles_per_cell_axis=ppc)


# -- phase 2: the main path --------------------------------------------------

def main_path(cfg, n_steps: int, frame_every: int, size):
    """Steps the dam break through the demo's step and draw functions as the
    demo loop does (overflow auto-tier every 4 steps); returns
    (final state, cfg, per-config numbers)."""
    import jax
    import numpy as np

    from fluidsimulation.app import demo
    from fluidsimulation.core.state import init_state
    from fluidsimulation.render.camera import OrbitCamera
    from fluidsimulation.solver.step3d import overflow_autotune, overflow_count
    from fluidsimulation.utils.metrics import check_state

    dev = jax.devices()[0]
    state = jax.device_put(init_state(cfg), dev)
    dt = demo.clamp_dt(cfg, DEMO_DT, DEMO_RATE)
    cam = OrbitCamera()

    t0 = time.perf_counter()
    compiled = demo.step_jit.lower(state, dt, cfg).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()

    step_ms, frame_ms, frame_first_s, colours = [], [], None, []
    recompiled = {0}
    for i in range(n_steps):
        t0 = time.perf_counter()
        state = _block(demo.step_jit(state, dt, cfg))
        step_ms.append(1e3 * (time.perf_counter() - t0))
        check(check_state(state), f"{cfg.nx}^3 step {i}: non-finite or "
              "exploding state (utils/metrics.check_state)")
        if i % 4 == 3:
            new = overflow_autotune(cfg, int(overflow_count(state.pos, cfg)))
            if new is not cfg:
                recompiled.add(i + 1)
                cfg = new
        if i % frame_every == 0:
            t0 = time.perf_counter()
            img = _block(demo.draw_frame(state.phi, cam, *size))
            dt_f = time.perf_counter() - t0
            if frame_first_s is None:
                frame_first_s = dt_f
            else:
                frame_ms.append(1e3 * dt_f)
            colours.append(n_colours(img))
            check(img.shape == (size[1], size[0], 3)
                  and bool(np.isfinite(np.asarray(img)).all()),
                  f"{cfg.nx}^3 frame at step {i}: bad shape or non-finite")
            check(colours[-1] >= MIN_COLOURS,
                  f"{cfg.nx}^3 frame at step {i}: {colours[-1]} colours "
                  f"< {MIN_COLOURS}")
    steady = [t for i, t in enumerate(step_ms) if i not in recompiled]
    stats = dev.memory_stats() or {}
    numbers = {
        "grid": cfg.nx, "particles": cfg.num_particles, "steps": n_steps,
        "compile_s": compile_s,
        "median_step_ms": float(np.median(steady)),
        "frame_first_s": frame_first_s,
        "median_frame_ms": float(np.median(frame_ms)) if frame_ms else None,
        "frame_colours": colours,
        "overflow_cap": cfg.overflow_cap,
        "step_memory": {
            "argument_bytes": mem.argument_size_in_bytes,
            "output_bytes": mem.output_size_in_bytes,
            "temp_bytes": mem.temp_size_in_bytes,
            "code_bytes": mem.generated_code_size_in_bytes,
        },
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }
    return state, cfg, numbers


# -- phase 3: parity between the GPU and the CPU backend ---------------------

def _max_abs(a, b):
    import numpy as np

    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def parity(state, cfg, cfg32):
    """GPU vs CPU on identical inputs.  Tolerances (docs/PARITY.md):

    * advect <= 1e-3 cells: the reference's own GPU-vs-CPU interpolation
      gap (hardware lerp, Simulation.cpp:569-576);
    * transfer <= 2.8e-5 relative to the field's largest magnitude: the
      reference's gather-vs-scatter P2G pair (Simulation.cpp:523), i.e. a
      change of summation order;
    * SOR after 100 iterations <= 2 * 1.4e-3 * max|p|: each backend runs
      the f32 solve, and docs/PARITY.md measured an f32 solve 1.4e-3
      (relative to max|p|) from the float64 oracle, so two f32 solves are
      at most twice that apart.  The reference's own 2.5e-3 absolute gap
      (Simulation.cpp:899-900) was taken at |p| ~ 641; it is printed
      beside ours, relative to max|p|, for comparison;
    * the whole step, field by field: pos and phi by the advect bound (phi
      is a distance to particle positions, so it moves no more than they
      do; relative beyond 1 cell); u, v, w and vel by the transfer bound
      plus the SOR bound carried through the pressure gradient
      (2 * dt / (rho * dx) * SOR bound).
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fluidsimulation.ops import advect, levelset, p2g, project
    from fluidsimulation.ops.celltable import build_cell_table, p2g_from_table
    from fluidsimulation.ops.supertable import build_super_table, p2g_from_super
    from fluidsimulation.solver.step3d import clamp_dt, step_jit, use_super_table

    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    host = jax.device_get(state)
    dt = clamp_dt(cfg, DEMO_DT, DEMO_RATE)
    n = cfg.nx
    out = {}

    def both(fn, *args):
        fn = jax.jit(fn)
        return [jax.device_get(fn(*jax.device_put(args, d))) for d in (gpu, cpu)]

    # Stage: advection (uncached RK3, the path every cache-less caller runs).
    a, b = both(lambda s: advect.advect_rk3(cfg, s.u, s.v, s.w, s.pos, dt),
                host)
    out["advect_cells"] = (_max_abs(a, b) * n, 1e-3)

    # Stage: P2G through the dense table the fast step uses.
    def fast_p2g(pos, vel):
        if use_super_table(cfg):
            return p2g_from_super(cfg, build_super_table(cfg, pos, vel), pos, vel)
        return p2g_from_table(cfg, build_cell_table(cfg, pos, vel), pos, vel)

    a, b = both(fast_p2g, host.pos, host.vel)
    worst = 0.0
    for g_a, g_b, v_a, v_b in zip(a[:3], b[:3], a[3:], b[3:]):
        check(bool((np.asarray(v_a) == np.asarray(v_b)).all()),
              "transfer: GPU and CPU disagree on which faces are valid")
        m = np.asarray(v_a)
        scale = max(float(np.abs(np.asarray(g_b)[m]).max()), 1e-30)
        worst = max(worst, _max_abs(np.asarray(g_a)[m], np.asarray(g_b)[m])
                    / scale)
    out["transfer_rel"] = (worst, 2.8e-5)

    # Stage: 100 SOR iterations on identical (phi, diag, b).
    phi = jnp.asarray(host.phi)
    diag = project.compute_diag(cfg, phi)
    rhs = project.compute_rhs(cfg, jnp.asarray(host.u), jnp.asarray(host.v),
                              jnp.asarray(host.w), jnp.float32(dt))
    a, b = both(lambda p, d, r: project.sor_pressure(cfg, p, d, r),
                jax.device_get(phi), jax.device_get(diag), jax.device_get(rhs))
    p_max = float(np.abs(np.asarray(b)).max())
    sor_tol = 2 * 1.4e-3 * p_max
    out["sor_max_abs_p"] = (p_max, None)
    out["sor_abs"] = (_max_abs(a, b), sor_tol)
    out["sor_rel"] = (_max_abs(a, b) / p_max, None)
    out["sor_rel_reference_gpu_vs_cpu"] = (2.5e-3 / 641.0, None)

    # The whole fast step from the same state, field by field.
    a, b = both(lambda s: step_jit(s, dt, cfg), host)
    grad = 2.0 * dt / (cfg.rho / cfg.cells_per_meter) * sor_tol
    out["step_pos_cells"] = (_max_abs(a.pos, b.pos) * n, 1e-3)
    dphi = np.abs(np.asarray(a.phi, np.float64) - np.asarray(b.phi, np.float64))
    out["step_phi_cells"] = (
        float((dphi / np.maximum(1.0, np.abs(np.asarray(b.phi)))).max()), 1e-3)
    for name in ("u", "v", "w", "vel"):
        ref = np.asarray(getattr(b, name))
        tol = 2.8e-5 * float(np.abs(ref).max()) + grad
        out[f"step_{name}"] = (_max_abs(getattr(a, name), ref), tol)

    # fast=False P2G: a scatter-add, atomics on the GPU.  Reordering a sum
    # of k float32 terms moves it by at most 2k*2^-24 * sum|terms| (plus a
    # few ulps for the products), so a face value acc/amt moves by at most
    # gamma * (sum w|v| / amt + |g|), gamma = (2k + 4) * 2^-24, with k the
    # most particles any face can see (a 3x3x3 cell block bounds a face's
    # trilinear support).
    st32 = jax.device_get(_warm_state(cfg32, steps=5))
    p32, v32 = st32.pos, st32.vel
    scatter = jax.jit(functools.partial(p2g.transfer_to_grid, cfg32))
    g1 = jax.device_get(scatter(jax.device_put(p32, gpu), jax.device_put(v32, gpu)))
    g2 = jax.device_get(scatter(jax.device_put(p32, gpu), jax.device_put(v32, gpu)))
    gc = jax.device_get(scatter(jax.device_put(p32, cpu), jax.device_put(v32, cpu)))
    gabs = jax.device_get(scatter(jax.device_put(p32, cpu),
                                  jax.device_put(np.abs(v32), cpu)))
    k = _max_face_support(p32, cfg32)
    gamma = (2 * k + 4) * 2.0 ** -24
    worst_run, worst_cpu = 0.0, 0.0
    for c in range(3):
        valid = np.asarray(gc[3 + c]) & np.asarray(g1[3 + c])
        bound = gamma * (np.abs(np.asarray(gabs[c])) + np.abs(np.asarray(gc[c])))
        bound = np.maximum(bound[valid], 1e-30)
        worst_run = max(worst_run, float((np.abs(np.asarray(g1[c]) - np.asarray(g2[c]))[valid] / bound).max()))
        worst_cpu = max(worst_cpu, float((np.abs(np.asarray(g1[c]) - np.asarray(gc[c]))[valid] / bound).max()))
    out["scatter32_gpu_vs_gpu_over_bound"] = (worst_run, 1.0)
    out["scatter32_gpu_vs_cpu_over_bound"] = (worst_cpu, 1.0)
    out["scatter32_k"] = (k, None)
    return out


def _max_face_support(pos, cfg) -> int:
    import numpy as np

    dims = np.array([cfg.nx, cfg.ny, cfg.nz])
    cell = np.clip(np.floor(np.asarray(pos) * dims).astype(int), 0, dims - 1)
    counts = np.zeros(dims + 2, np.int64)
    np.add.at(counts, tuple((cell + 1).T), 1)
    box = sum(np.roll(counts, (dx, dy, dz), axis=(0, 1, 2))
              for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1))
    return int(box.max())


def _warm_state(cfg, steps: int):
    import jax

    from fluidsimulation.core.state import init_state
    from fluidsimulation.solver.step3d import clamp_dt, step_jit

    state = jax.device_put(init_state(cfg), jax.devices()[0])
    dt = clamp_dt(cfg, DEMO_DT, DEMO_RATE)
    for _ in range(steps):
        state = step_jit(state, dt, cfg)
    return _block(state)


# -- phase 4: the sweep kernel against the XLA scans --------------------------

@contextlib.contextmanager
def xla_sweeps():
    """Trace the step with the level-set sweeps as XLA scans (the plain
    version the kernel must beat); used only to build the A/B's other side."""
    from fluidsimulation.ops import levelset

    with mock.patch.object(levelset, "sweep_closest_fast",
                           levelset.sweep_closest):
        yield


def sweep_ab(cfg, state, n_steps: int, interpret: bool):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from fluidsimulation.ops import levelset
    from fluidsimulation.ops.celltable import (
        build_cell_table, seed_closest_from_table, seed_overflow_correction)
    from fluidsimulation.ops.pallas_sweep import sweep_closest_pallas
    from fluidsimulation.ops.supertable import (
        build_super_table, seed_closest_from_super)
    from fluidsimulation.solver.step3d import clamp_dt, step, use_super_table

    @jax.jit
    def seeded(pos, vel):
        if use_super_table(cfg):
            table = build_super_table(cfg, pos, vel)
            phi0, cpos0 = seed_closest_from_super(cfg, table, levelset.FAR)
        else:
            table = build_cell_table(cfg, pos, vel)
            phi0, cpos0 = seed_closest_from_table(cfg, table, levelset.FAR)
        phi0, cpos0 = seed_overflow_correction(cfg, table, pos, phi0, cpos0)
        return levelset.neighborhood_pass(cfg, cpos0)

    phi, cpos = seeded(state.pos, state.vel)
    plain = jax.jit(functools.partial(levelset.sweep_closest, cfg))
    kern = jax.jit(functools.partial(sweep_closest_pallas, cfg,
                                     interpret=interpret))
    want, got = plain(phi, cpos), kern(phi, cpos)
    dphi = float(jnp.abs(want[0] - got[0]).max())
    same_cpos = bool((want[1] == got[1]).all())
    check(dphi <= 1e-5 and same_cpos,
          f"{cfg.nx}^3 sweep kernel != XLA sweeps (max |dphi| {dphi}, "
          f"candidates equal: {same_cpos})")
    res = {
        "sweep_max_abs_dphi": dphi, "sweep_candidates_equal": same_cpos,
        "sweep_kernel_ms": median_ms(kern, phi, cpos),
        "sweep_xla_ms": median_ms(plain, phi, cpos),
    }

    dt = clamp_dt(cfg, DEMO_DT, DEMO_RATE)
    with_kernel = jax.jit(functools.partial(step, dt=dt, cfg=cfg))
    without = jax.jit(functools.partial(step, dt=dt, cfg=cfg))
    with xla_sweeps():
        _block(without(state))
    _block(with_kernel(state))

    def run(fn, s, ctx):
        ts = []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            with ctx():
                s = _block(fn(s))
            ts.append(time.perf_counter() - t0)
        return s, ts

    k_ts, p_ts = [], []
    s = state
    for side in ("kernel", "plain", "plain", "kernel"):
        if side == "kernel":
            s, ts = run(with_kernel, s, contextlib.nullcontext)
            k_ts += ts
        else:
            s, ts = run(without, s, xla_sweeps)
            p_ts += ts
    res["step_kernel_ms"] = 1e3 * float(np.median(k_ts))
    res["step_xla_sweeps_ms"] = 1e3 * float(np.median(p_ts))
    res["steps_per_side"] = len(k_ts)
    return res


# -- phase 6: four cards -------------------------------------------------------

def four_cards(grid: int, ppc: int, size) -> dict:
    import jax
    import numpy as np

    from fluidsimulation.core.state import init_state
    from fluidsimulation.parallel.halo_step import make_halo_step, shard_state_x
    from fluidsimulation.parallel.sharding import (
        make_mesh, make_sharded_step, shard_state)
    from fluidsimulation.render.camera import OrbitCamera
    from fluidsimulation.render.raytrace import render
    from fluidsimulation.render.sharded import make_sharded_render
    from fluidsimulation.solver.step3d import clamp_dt, step_jit

    devices = jax.devices()
    check(len(devices) >= 4, f"--four-cards needs 4 devices, found {len(devices)}")
    mesh = make_mesh(devices[:4])
    cfg = dam_break(grid, ppc)
    dt = clamp_dt(cfg, DEMO_DT, DEMO_RATE)
    n_steps = 3
    init = init_state(cfg)

    def timed_steps(fn, s):
        ts = []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            s = _block(fn(s))
            ts.append(time.perf_counter() - t0)
        return s, 1e3 * float(np.median(ts[1:]))

    want, single_ms = timed_steps(lambda s: step_jit(s, dt, cfg),
                                  jax.device_put(init, devices[0]))
    want = jax.device_get(want)
    res = {"grid": grid, "particles": cfg.num_particles,
           "single_card_step_ms": single_ms}
    failures = []

    def expect(ok: bool, what: str) -> None:
        if not ok:
            failures.append(what)

    tol = {"pos": 1e-6, "vel": 1e-4, "u": 1e-4, "v": 1e-4, "w": 1e-4,
           "phi": 1e-4}  # as tests/test_parallel.py: reassociation only

    halo = make_halo_step(cfg, mesh, with_diagnostics=True)
    dropped = []

    def halo_fn(s):
        s, d = halo(s, dt)
        dropped.append(d)
        return s

    got, res["halo_step_ms"] = timed_steps(halo_fn, shard_state_x(init, mesh))
    res["halo_dropped"] = int(max(int(d) for d in dropped))
    expect(res["halo_dropped"] == 0,
           f"halo step dropped {res['halo_dropped']} slab particles")
    for name, t in tol.items():
        d = _max_abs(getattr(got, name), getattr(want, name))
        res[f"halo_{name}_max_abs"] = d
        expect(d <= t, f"halo step {name}: max |diff| {d} > {t}")

    gspmd = make_sharded_step(cfg, mesh)
    got, res["gspmd_step_ms"] = timed_steps(lambda s: gspmd(s, dt),
                                            shard_state(init, mesh))
    for name, t in tol.items():
        d = _max_abs(getattr(got, name), getattr(want, name))
        res[f"gspmd_{name}_max_abs"] = d
        expect(d <= t, f"GSPMD step {name}: max |diff| {d} > {t}")

    w, h = size
    co, right, up, fwd = OrbitCamera().frame(w, h)
    phi = jax.device_put(want.phi, devices[0])
    frame = make_sharded_render(mesh, w, h, tile_h=100, tile_w=100)
    res["sharded_frame_ms"] = median_ms(frame, want.phi, co, right, up, fwd,
                                        n=3)
    single = jax.jit(functools.partial(render, width=w, height=h,
                                       band_rows=100, band_cols=100))
    res["single_frame_ms"] = median_ms(single, phi, co, right, up, fwd, n=3)
    d = _max_abs(frame(want.phi, co, right, up, fwd),
                 single(phi, co, right, up, fwd))
    res["sharded_frame_max_abs"] = d
    expect(d <= 1e-6, f"sharded frame != single-card frame: {d}")
    say("four cards:", json.dumps(res))
    check(not failures, "; ".join(failures))
    return res


# -- driver --------------------------------------------------------------------

def run(args) -> dict:
    if not args.rehearse:
        say("card:", card_name_and_power())
        if not args.four_cards:
            run_card_tests()

    import jax

    from fluidsimulation.utils.cache import enable_compilation_cache

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    say("device:", json.dumps(device))
    if not args.rehearse:
        check(dev.platform == "gpu", f"JAX's first device is {dev.platform}, "
              "not a GPU")
    say("compile cache:", enable_compilation_cache())

    small = args.rehearse
    if args.four_cards:
        four_cards(32 if small else 128, 1, (64, 48) if small else (800, 600))
        return device

    size = (80, 60) if small else (800, 600)
    demo_cfg = dam_break(16 if small else 64, 2)
    bench_cfg = dam_break(16 if small else 128, 1)

    state, cfg, nums = main_path(demo_cfg, 30, 10, size)
    say("main path demo:", json.dumps(nums))
    bench_state, bcfg, nums = main_path(bench_cfg, 10, 5, size)
    say("main path bench:", json.dumps(nums))

    par = parity(state, cfg, dam_break(8 if small else 32, 2))
    for name, (val, tol) in par.items():
        say(f"parity {name}: {val}" + ("" if tol is None else f" (tolerance {tol})"))
        check(tol is None or val <= tol, f"parity {name}: {val} > {tol}")

    for label, c, s in (("demo", cfg, state), ("bench", bcfg, bench_state)):
        res = sweep_ab(c, s, 4 if small else 20, interpret=small)
        say(f"sweep kernel {label} {c.nx}^3:", json.dumps(res))
    return device


def result_line(device: dict) -> str:
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": device})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths (phase 6)")
    ap.add_argument("--rehearse", action="store_true",
                    help="run on any backend at tiny sizes; never reports ok")
    args = ap.parse_args(argv)
    try:
        device = run(args)
    except SmokeFailure as e:
        say(f"FAILED: {e}")
        return 1
    if args.rehearse:
        say("rehearsal finished (not a chip run; no result)")
        return 1
    say(result_line(device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
