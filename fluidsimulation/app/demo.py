"""CLI demo: the JAX equivalent of FluidSimDemo (FluidSimDemo.cpp).

Runs the dam-break simulation and renders raytraced frames.  The reference's
interactive controls (FluidSimDemo.cpp:7-13) are exposed both as flags and as
an optional stdin command stream:

  +     double simulation speed  (GPFluidSim::IncreaseSpeed, clamp <= 1)
  -     halve simulation speed   (GPFluidSim::DecreaseSpeed)
  0     reset camera view
  r     reset the simulation
  o X Y orbit the camera by (X, Y) "pixels" (mouse-drag equivalent)
  z DY  zoom (right-drag equivalent)
  q     quit

Frames are written as binary PPM (and the state as .npz on --save-state);
there is no swapchain on an accelerator host.

Usage (JAX_PLATFORMS=cpu runs it on the CPU):
  python -m fluidsimulation.app.demo --grid 64 --steps 120 \
      --render-every 2 --width 800 --height 600 --out out/
"""

from __future__ import annotations

import argparse
import os
import select
import sys
import time

import numpy as np

from ..core.config import SimConfig
from ..core.state import init_state
from ..render.camera import OrbitCamera
from ..render.raytrace import render_frame
from ..solver.step3d import clamp_dt, step_jit
from ..utils.checkpoint import save_state
from ..utils.metrics import Meter, check_state
from ..utils.profiling import profile_step


def write_ppm(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3) float in [0, inf) -> 8-bit binary PPM."""
    arr = (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    h, w, _ = arr.shape
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(arr.tobytes())


def _poll_stdin() -> str | None:
    if not sys.stdin.isatty() and not os.environ.get("FST_DEMO_STDIN"):
        return None
    r, _, _ = select.select([sys.stdin], [], [], 0)
    if r:
        return sys.stdin.readline().strip()
    return None


def _main_2d(args):
    """2D demo loop: the JAX equivalent of the archival 2D driver
    (FluidSimDemoOld.cpp) — dam break with curl-noise initial velocities,
    rendered as particle point splats over a checkerboard
    (DebugPointsQuads.fx / Basic.fx)."""
    from ..core.config import SimConfig2D
    from ..render.debug import splat_particles_2d
    from ..solver.step2d import init_state2d, step2d_jit

    cfg = SimConfig2D(
        nx=args.grid, ny=args.grid, cells_per_meter=float(args.grid)
    )
    os.makedirs(args.out, exist_ok=True)
    print(f"2D grid {cfg.nx}x{cfg.ny}, {cfg.num_particles} particles")
    if getattr(args, "transfer", "flip") == "apic":
        from ..solver.apic2d import init_apic_state2d, step_apic2d_jit

        init_state2d, step2d_jit = init_apic_state2d, step_apic2d_jit
    state = init_state2d(cfg)
    rate = args.rate
    meter = Meter(cfg.num_particles)
    live = None
    if getattr(args, "serve", 0):
        from .liveview import LiveView

        live = LiveView(args.serve)
        print(f"live view: http://127.0.0.1:{live.port}/")
    quit_now = False
    for i in range(args.steps):
        for cmd in live.poll_cmds() if live is not None else ():
            if cmd == "+":
                rate = min(rate * 2.0, 1.0)
            elif cmd == "-":
                rate = max(
                    rate / 2.0,
                    float(np.finfo(np.float32).smallest_subnormal),
                )
            elif cmd == "r":
                state = init_state2d(cfg)
            elif cmd == "q":
                quit_now = True
        if quit_now:
            break
        dt = float(np.clip(args.dt * rate, 0.0, cfg.max_dt))
        t0 = time.perf_counter()
        state = step2d_jit(state, dt, cfg)
        state.pos.block_until_ready()
        meter.tick()
        if args.render_every and (i % args.render_every == 0):
            img = splat_particles_2d(state.pos, args.width, args.height)
            out = np.asarray(img)
            write_ppm(os.path.join(args.out, f"frame2d_{i:05d}.ppm"), out)
            if live is not None:
                live.publish(out)
        if i % 10 == 0:
            print(f"step {i}: {1000*(time.perf_counter()-t0):.1f} ms ({meter.summary()})")
    print(meter.summary())


def draw_frame(phi, cam: OrbitCamera, width: int, height: int, *,
               bounces: int = 2, sphere_trace: bool = True,
               overstep: float = 0.0, t_seed=None, return_t: bool = False):
    """One exact raytraced frame of ``phi`` at the demo's settings (the
    reference's DrawScene, FluidSimDemo.cpp:175-208).  Tiles are 100 rows
    at 128^3 and up, 64 below: a plain parameter (the image does not
    depend on it) until the benchmark re-measures it on the GPU."""
    co, right, up, fwd = cam.frame(width, height)
    band_rows = 100 if max(phi.shape) >= 128 else 64
    return render_frame(phi, co, right, up, fwd, width=width, height=height,
                        band_rows=band_rows, bounces=bounces,
                        sphere_trace=sphere_trace, overstep=overstep,
                        t_seed=t_seed, return_t=return_t)


def main(argv=None):
    from ..utils.cache import enable_compilation_cache

    enable_compilation_cache()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--grid", type=int, default=64, help="cubic grid size (demo: 64)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--dt", type=float, default=1.0 / 60.0, help="frame dt before rate clamp")
    ap.add_argument("--rate", type=float, default=0.5, help="initial simulation rate (Simulation.h:84)")
    ap.add_argument("--render-every", type=int, default=0, help="render every k steps (0 = never)")
    ap.add_argument("--width", type=int, default=800)
    ap.add_argument("--height", type=int, default=600)
    ap.add_argument("--out", type=str, default="out")
    ap.add_argument("--save-state", action="store_true")
    ap.add_argument("--profile", action="store_true", help="per-stage timing table each step")
    ap.add_argument("--ppc", type=int, default=2, help="particles per cell axis")
    ap.add_argument(
        "--render-scale", type=int, default=1,
        help="fast-preview mode: raytrace at 1/k resolution and upscale "
        "(k=2 -> 4x fewer rays; exact reference image at k=1)",
    )
    ap.add_argument(
        "--renderer", choices=("wavefront", "tiled"), default="tiled",
        help="exact-path renderer: the scan-tiled formulation (default) or "
        "the global-ray-pool wavefront one; same image up to fp-contraction "
        "drift (docs/PARITY.md)",
    )
    ap.add_argument(
        "--bounces", type=int, default=2, choices=(0, 1, 2),
        help="water-bounce recursion depth: 2 = the reference PS main "
        "(traceWater2, exact default); 1/0 = the reference's own lower "
        "tiers (traceWater1/0, Render.fx:442-515), fewer rays per pixel",
    )
    ap.add_argument(
        "--overflow-cap", type=int, default=0,
        help="exact-fallback budget for particles past the dense table's "
        "slots (ops/celltable.py).  0 (default) = auto-tier: monitor the "
        "measured n_overflow every 4 steps and raise the cap with 2x "
        "headroom so the fast path never silently subsamples (the "
        "reference's per-cell lists are unbounded).  Each tier is its own "
        "compiled program (persistent-cached).  3D flip transfer only",
    )
    ap.add_argument(
        "--sphere-trace", action=argparse.BooleanOptionalAction, default=True,
        help="sphere-trace skip on the inside water march (deepened march "
        "texture, render/interior.py::deepen_phi): jumps |phi| cells per "
        "probe using the row already fetched — bit-identical on the demo "
        "scenes at the certified margin (docs/PARITY.md).  "
        "--no-sphere-trace restores the plain 1-cell march",
    )
    ap.add_argument(
        "--overstep", type=float, default=0.0,
        help="enhanced sphere tracing on the OUTSIDE water march: step "
        "omega*dt per probe with certified backtracking "
        "(raytrace.intersect_water); omega ~1.4-1.6 takes fewer probes "
        "with a small pixel-diff bound (docs/PARITY.md).  "
        "0 (default) / 1.0 = the exact reference march",
    )
    ap.add_argument(
        "--temporal", action=argparse.BooleanOptionalAction, default=False,
        help="temporal frame coherence (opt-in like --overstep): "
        "seed each frame's water marches from the previous frame's "
        "per-pixel hit ts when the camera is unchanged (raytrace.render "
        "t_seed).  The reference re-pays a 64-step cold march per pixel "
        "per frame (Render.fx:369); seeding skips the already-traversed "
        "prefix at a small pixel drift (docs/PARITY.md).  Cleared "
        "automatically on camera moves and resets",
    )
    ap.add_argument(
        "--serve", type=int, default=0, metavar="PORT",
        help="live interactive display: serve the latest frame as an "
        "MJPEG stream at http://127.0.0.1:PORT/ with browser mouse orbit/"
        "zoom and the + - 0 r q keys (app/liveview.py — the reference "
        "window's OnMouseMove equivalent, FluidSimDemo.cpp:251-293).  "
        "Commands use the same text protocol as the stdin stream",
    )
    ap.add_argument(
        "--transfer", choices=("flip", "apic"), default="flip",
        help="transfer model: the reference's hybrid PIC/FLIP (default) "
        "or the APIC extension (affine particle-in-cell, quadratic "
        "B-splines — angular-momentum-preserving, dissipation-free; "
        "solver/apic.py; not in the reference)",
    )
    ap.add_argument(
        "--two-d", action="store_true",
        help="run the 2D solver (FluidSim / FluidSimDemoOld equivalent), "
        "rendering particle splats over a checkerboard",
    )
    args = ap.parse_args(argv)

    if args.two_d:
        return _main_2d(args)

    cfg = SimConfig(
        nx=args.grid, ny=args.grid, nz=args.grid,
        cells_per_meter=float(args.grid),
        particles_per_cell_axis=args.ppc,
        **({"overflow_cap": args.overflow_cap} if args.overflow_cap else {}),
    )
    autotune_overflow = args.overflow_cap == 0 and args.transfer == "flip"
    os.makedirs(args.out, exist_ok=True)
    print(f"grid {cfg.nx}^3, {cfg.num_particles} particles")

    if args.transfer == "apic":
        from ..solver.apic import init_apic_state, step_apic_jit
        from ..utils.profiling import profile_step_apic

        _init, _step, _profile = init_apic_state, step_apic_jit, profile_step_apic
    else:
        _init, _step, _profile = init_state, step_jit, profile_step
    state = _init(cfg)
    cam = OrbitCamera()
    rate = args.rate
    meter = Meter(cfg.num_particles)

    live = None
    if args.serve:
        from .liveview import LiveView

        live = LiveView(args.serve)
        print(f"live view: http://127.0.0.1:{live.port}/")

    # Temporal seed: previous frame's per-pixel march t + the camera/state
    # signature it is valid for (cleared on camera move or sim reset).
    seed = {"t": None, "sig": None}

    quit_now = False
    for i in range(args.steps):
        cmds = [c for c in [_poll_stdin()] if c]
        if live is not None:
            cmds.extend(live.poll_cmds())
        for cmd in cmds:
          try:
            if cmd == "+":
                rate = min(rate * 2.0, 1.0)
            elif cmd == "-":
                # Clamp at the smallest denormal like DecreaseSpeed
                # (Simulation.cpp:304-312).
                rate = max(rate / 2.0, float(np.finfo(np.float32).smallest_subnormal))
            elif cmd == "0":
                cam.reset()
            elif cmd == "r":
                state = _init(cfg)
                seed["t"] = None  # water jumps discontinuously
            elif cmd == "q":
                quit_now = True
            elif cmd.startswith("o "):
                _, dx, dy = cmd.split()
                cam.orbit(float(dx), float(dy))
            elif cmd.startswith("z "):
                cam.zoom(float(cmd.split()[1]), args.height)
          except (ValueError, IndexError):
            # Malformed command (stdin typo; liveview validates upstream):
            # ignore rather than kill a long run.
            print(f"ignoring malformed command: {cmd!r}")
        if quit_now:
            break

        dt = clamp_dt(cfg, args.dt, rate)
        t0 = time.perf_counter()
        do_render = args.render_every and (i % args.render_every == 0)
        img_holder = []

        def draw(s):
            """DRAW stage (FluidSimDemo::DrawScene, timed like the
            reference's DRAW profiler mark).  --render-scale k>1 traces at
            reduced resolution and nearest-upscales: a documented preview
            divergence (docs/PARITY.md), ~k^2 faster."""
            k = max(1, args.render_scale)
            # Round the traced resolution UP so the upscaled image covers
            # the requested size even when width/height % k != 0.
            w, h = -(-args.width // k), -(-args.height // k)
            if args.renderer == "wavefront":
                from ..experiments.wavefront import render_wavefront

                co, right, up, fwd = cam.frame(w, h)
                img = render_wavefront(s.phi, co, right, up, fwd, w, h)
            else:
                temporal = args.temporal and args.bounces >= 1
                sig = (cam.cam_phi, cam.cam_theta, cam.fov, cam.radius,
                       w, h, args.bounces)
                t_in = seed["t"] if (temporal and seed["sig"] == sig) else None
                out = draw_frame(s.phi, cam, w, h, bounces=args.bounces,
                                 sphere_trace=args.sphere_trace,
                                 overstep=args.overstep,
                                 t_seed=t_in, return_t=temporal)
                if temporal:
                    img, seed["t"] = out
                    seed["sig"] = sig
                else:
                    img = out
            out = np.asarray(img)
            if k > 1:
                out = np.repeat(np.repeat(out, k, axis=0), k, axis=1)
                out = out[: args.height, : args.width]
            img_holder.append(out)
            return img

        if args.profile:
            state, prof = _profile(
                state, dt, cfg, render_fn=draw if do_render else None
            )
            print(prof.table())
        else:
            state = _step(state, dt, cfg)
            state.pos.block_until_ready()
            if do_render:
                draw(state)
        meter.tick()
        step_ms = 1000 * (time.perf_counter() - t0)

        if autotune_overflow and i % 4 == 3:
            from ..solver.step3d import overflow_autotune, overflow_count

            n_over = int(overflow_count(state.pos, cfg))
            new_cfg = overflow_autotune(cfg, n_over)
            if new_cfg is not cfg:
                print(
                    f"overflow autotune: n_overflow={n_over} -> "
                    f"cap {new_cfg.overflow_cap} (was {cfg.overflow_cap})"
                )
                cfg = new_cfg

        if img_holder:
            write_ppm(
                os.path.join(args.out, f"frame_{i:05d}.ppm"), img_holder[0]
            )
            if live is not None:
                live.publish(img_holder[0])

        if i % 10 == 0:
            print(f"step {i}: {step_ms:.1f} ms  ({meter.summary()})")
            if not check_state(state):
                # The reference asserts on a velocity explosion
                # (Simulation3D.cpp:172-175); 'r' resets only on request.
                raise SystemExit(
                    f"step {i}: non-finite or exploding state; stopping"
                )

    if args.save_state:
        if args.transfer == "apic":
            from ..utils.checkpoint import save_apic_state

            save_apic_state(
                os.path.join(args.out, "final_state.npz"), state, cfg
            )
        else:
            save_state(os.path.join(args.out, "final_state.npz"), state, cfg)
    print(meter.summary())


if __name__ == "__main__":
    main()
