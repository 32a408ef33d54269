"""Command-line drivers — the analog of the reference's application
shell (Source.cpp / Application.cpp).

The reference's two modes map as:
  RENDER_OFFLINE 1  -> `render` (N-frame progressive render -> BMP/PNG,
                       warmup+timed, Application.cpp:400-458)
  windowed          -> `watch` (headless progressive render that rewrites
                       the output image every N frames — the message pump
                       minus the Win32 window; screenshots are just the
                       current file, cf. the 's' key at :603-623)
plus the new capabilities:
  `bench`    the five BASELINE.json configs by name
  `inverse`  inverse-rendering demo (config 4)

Example (the reference default workload under the procedural sky):
  python -m cpuperformanceraytracer_tpu.app.cli render \
      --scene glass_spheres --width 1280 --height 720 --frames 600 \
      --env procedural --backend pallas -o out.bmp

A long offline render survives preemption with --checkpoint PATH
--checkpoint-every N: rerunning the same command resumes from PATH.
"""

from __future__ import annotations

import argparse
import sys

from cpuperformanceraytracer_tpu.config import BENCH_CONFIGS, RenderConfig


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--scene", default="glass_spheres")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--spp", type=int, default=1)
    p.add_argument("--bounces", type=int, default=8)
    p.add_argument("--frames", type=int, default=600)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--env", default=None, help=".hdr env map path, "
                   "'procedural', or omit for constant ambient")
    p.add_argument("--cubemap", nargs=6, default=None,
                   help="six .hdr faces: px nx py ny pz nz")
    p.add_argument("--env-sampling", default="stochastic",
                   choices=["stochastic", "bilinear", "nearest"])
    p.add_argument("--rng", default="wang", choices=["wang", "counter"])
    p.add_argument("--roulette", default="v4_quirk",
                   choices=["off", "terminate", "v4_quirk"])
    p.add_argument("--backend", default="xla", choices=["xla", "pallas"])
    p.add_argument("--exposure", type=float, default=1.0)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("-o", "--output", default="output_image.bmp")
    p.add_argument("--silent", action="store_true")


def _cfg_from_args(a) -> RenderConfig:
    env_mode = "none"
    if a.cubemap:
        env_mode = "cubemap"
    elif a.env:
        env_mode = "equirect"
    return RenderConfig(
        width=a.width, height=a.height, spp=a.spp, bounces=a.bounces,
        num_frames=a.frames, warmup_frames=a.warmup, scene=a.scene,
        env_mode=env_mode, env_sampling=a.env_sampling, rng=a.rng,
        roulette=a.roulette, backend=a.backend, exposure=a.exposure,
    ).validate()


def _texture_from_args(a):
    from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu.texture.texture import (
        load_cubemap_texture,
        load_texture,
        texture_from_array,
    )

    if a.cubemap:
        return load_cubemap_texture(a.cubemap)
    if a.env == "procedural":
        return texture_from_array(gradient_sky(512, 256))
    if a.env:
        return load_texture(a.env)
    return None


def cmd_render(a) -> int:
    from cpuperformanceraytracer_tpu.render.driver import OfflineRenderer

    cfg = _cfg_from_args(a)
    r = OfflineRenderer(cfg, texture=_texture_from_args(a), silent=a.silent)
    if a.checkpoint:
        r.resume(a.checkpoint)
    timer = r.run(checkpoint_path=a.checkpoint,
                  checkpoint_every=a.checkpoint_every)
    r.write_image(a.output)
    rays = cfg.width * cfg.height * cfg.spp
    print(f"{timer.mean_ms:.3f} ms/frame; "
          f"{timer.rays_per_second(rays) / 1e6:.1f} Mrays/s; "
          f"wrote {a.output}")
    return 0


def _poll_keys() -> str:
    """Non-blocking read of any pending stdin characters (returns ''
    when stdin is not a tty or nothing is pending)."""
    import os
    import select
    import sys

    if not sys.stdin.isatty():
        return ""
    keys = ""
    while select.select([sys.stdin], [], [], 0)[0]:
        ch = os.read(sys.stdin.fileno(), 1).decode(errors="ignore")
        if not ch:
            break
        keys += ch
    return keys


def cmd_watch(a) -> int:
    """Progressive render with a live view: rewrite the output file every
    --interval frames and (with --live) draw the current accumulation in
    the terminal with a per-frame stats line — the analog of
    the reference's interactive window + title-bar frame times
    (Application.cpp:196-379, 308-335). Keys during the loop (tty only):
    's' dumps a timestamped screenshot (the reference's 's' key,
    Application.cpp:603-623); 'q' stops the watch."""
    import collections
    import contextlib
    import time

    import jax

    from cpuperformanceraytracer_tpu.render.driver import OfflineRenderer, RenderState
    from cpuperformanceraytracer_tpu.render.frame import zero_accum

    cfg = _cfg_from_args(a)
    r = OfflineRenderer(cfg, texture=_texture_from_args(a), silent=a.silent)
    rays = cfg.width * cfg.height * cfg.spp

    # warm up UNTIMED: compile both dispatch widths the loop will use
    # (the main interval and the tail remainder) into a scratch state so
    # no compile lands inside a timed span
    tail = cfg.num_frames % a.interval
    keep = r.state
    r.state = RenderState(accum=zero_accum(cfg), frame=0)
    r.step_k(min(a.interval, cfg.num_frames))
    if tail and tail != a.interval:
        r.step_k(tail)
    jax.block_until_ready(r.state.accum)
    r.state = keep

    # put the tty in cbreak so single keypresses arrive without Enter
    # (restored on exit); no-op when stdin is not a tty
    import sys

    @contextlib.contextmanager
    def _cbreak():
        if not sys.stdin.isatty():
            yield
            return
        import termios
        import tty

        old = termios.tcgetattr(sys.stdin.fileno())
        try:
            tty.setcbreak(sys.stdin.fileno())
            yield
        finally:
            termios.tcsetattr(sys.stdin.fileno(), termios.TCSADRAIN, old)

    # true 30-frame rolling window, as the reference's title bar
    # (Application.cpp:308-335: mean over the last 30 frames)
    window = collections.deque(maxlen=30)
    first = True
    with _cbreak():
        for i in range(0, cfg.num_frames, a.interval):
            note = ""  # per-interval: a screenshot is announced once
            todo = min(a.interval, cfg.num_frames - i)
            t0 = time.perf_counter()
            r.step_k(todo)
            jax.block_until_ready(r.state.accum)
            per_frame = (time.perf_counter() - t0) / todo * 1e3
            window.extend([per_frame] * todo)
            roll_ms = sum(window) / len(window)
            done = i + todo
            r.write_image(a.output)
            keys = _poll_keys()
            if "s" in keys:
                note = f" | screenshot: {r.screenshot()}"
            stats = (f"frame {done}/{cfg.num_frames} | "
                     f"{roll_ms:7.2f} ms/frame | {1e3 / roll_ms:6.1f} fps | "
                     f"{rays / roll_ms / 1e3:7.1f} Mrays/s | "
                     f"{a.output}{note}")
            if a.live:
                from cpuperformanceraytracer_tpu.utils.term_view import (
                    live_view,
                )

                print(live_view(r.image_u8(), stats, first=first),
                      flush=True)
                first = False
            elif not a.silent:
                print(stats, flush=True)
            if "q" in keys:
                break
    return 0


def cmd_bench(a) -> int:
    import json

    from cpuperformanceraytracer_tpu.render.driver import OfflineRenderer
    from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu.texture.texture import texture_from_array

    names = a.configs or [k for k in BENCH_CONFIGS
                          if k not in ("inverse_render", "offline_4k")]
    for name in names:
        cfg = BENCH_CONFIGS[name].replace(num_frames=a.frames)
        if a.backend:
            cfg = cfg.replace(backend=a.backend)
        # the env map is the seeded procedural 512x256 sky (the
        # reference asset's texel count)
        tex = (texture_from_array(gradient_sky(512, 256))
               if cfg.env_mode != "none" else None)
        r = OfflineRenderer(cfg, texture=tex, silent=True)
        t = r.run()
        rays = cfg.width * cfg.height * cfg.spp
        print(json.dumps({
            "config": name, "backend": cfg.backend,
            "ms_per_frame": round(t.mean_ms, 3),
            "Mrays_per_s": round(t.rays_per_second(rays) / 1e6, 2),
        }))
    return 0


def cmd_bench_grad(a) -> int:
    """Timed fwd+bwd (value_and_grad of the L2 pixel loss) at a stated
    workload — the backward-pass throughput metric bench.py reports.

    Gradients flow to the full differentiable surface (sphere centers,
    albedos, env texels) through jax.grad of the integrator (the
    adjoint of the bounce loop, demofox_path_tracing_optimization_v4.cpp
    :722-910); --remat replays each bounce segment in the backward
    sweep instead of storing its state. The measurement protocol (warmup
    + mean over fixed spans, K steps fused per dispatch) lives in
    diff/benchgrad.py.
    """
    import json

    from cpuperformanceraytracer_tpu.diff.benchgrad import fwd_bwd_benchmark
    from cpuperformanceraytracer_tpu.scene.presets import scene_by_name

    cfg = _cfg_from_args(a).replace(rng="counter", remat_bounces=a.remat)
    scene, cam = scene_by_name(cfg.scene)
    result = fwd_bwd_benchmark(cfg, scene, cam, _texture_from_args(a),
                               steps=a.steps,
                               steps_per_dispatch=a.steps_per_dispatch)
    out = {
        "metric": "fwd_bwd_ms_per_step",
        "config": f"{cfg.width}x{cfg.height} spp{cfg.spp} "
                  f"b{cfg.bounces} env={cfg.env_mode} "
                  f"remat={cfg.remat_bounces}",
    }
    out.update({k: (round(v, 3) if isinstance(v, float) else v)
                for k, v in result.items()})
    print(json.dumps(out))
    return 0


def cmd_inverse(a) -> int:
    import jax.numpy as jnp
    import numpy as np

    from cpuperformanceraytracer_tpu.diff.grad import render_for_params
    from cpuperformanceraytracer_tpu.diff.inverse import (
        InverseProblem,
        adam_inverse_render,
    )
    from cpuperformanceraytracer_tpu.scene.presets import scene_by_name
    from cpuperformanceraytracer_tpu.utils.log import get_logger

    cfg = _cfg_from_args(a).replace(rng="counter")
    scene, cam = scene_by_name(cfg.scene)
    tex = _texture_from_args(a)
    target = render_for_params({}, scene, cam, tex, cfg, 0)

    albedo = jnp.stack([scene.materials.albedo.x, scene.materials.albedo.y,
                        scene.materials.albedo.z], -1)
    centers = jnp.stack([scene.spheres.center.x, scene.spheres.center.y,
                         scene.spheres.center.z], -1)
    init = {"albedo": jnp.clip(albedo + 0.2, 0, 1),
            "sphere_centers": centers + 0.3}

    log = get_logger(silent=a.silent)
    prob = InverseProblem(scene, cam, tex, cfg, target)
    params, losses = adam_inverse_render(prob, init, steps=a.steps,
                                         learning_rate=a.lr, eps=a.eps,
                                         log_every=10, logger=log)
    print(f"inverse render: loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"albedo err {float(np.abs(params['albedo'] - albedo).max()):.4f}; "
          f"center err {float(np.abs(params['sphere_centers'] - centers).max()):.4f}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cprt")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="offline progressive render")
    _add_common(p)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("watch", help="progressive render with live file updates")
    _add_common(p)
    p.add_argument("--interval", type=int, default=10)
    p.add_argument("--live", action="store_true",
                   help="draw the frame in the terminal (ANSI truecolor)")
    p.set_defaults(fn=cmd_watch)

    p = sub.add_parser("bench", help="run named benchmark configs")
    p.add_argument("configs", nargs="*", default=None)
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--backend", default=None, choices=["xla", "pallas"],
                   help="override the configs' backend")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser("inverse", help="inverse-rendering demo")
    _add_common(p)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--eps", type=float, default=1e-8,
                   help="Adam epsilon; ~1e-2 acts as a gradient noise "
                        "floor for geometry recovery (see "
                        "diff.inverse.adam_inverse_render)")
    p.set_defaults(fn=cmd_inverse)

    p = sub.add_parser("bench-grad",
                       help="timed fwd+bwd (value_and_grad) throughput")
    _add_common(p)
    p.add_argument("--steps", type=int, default=16, help="timed steps")
    p.add_argument("--steps-per-dispatch", type=int, default=4,
                   help="K value_and_grad steps fused per device "
                        "dispatch (diff/benchgrad.make_grad_step_k)")
    p.add_argument("--remat", action="store_true",
                   help="replay bounce segments in the backward sweep")
    p.set_defaults(fn=cmd_bench_grad)

    a = ap.parse_args(argv)
    try:
        return a.fn(a)
    except (ValueError, NotImplementedError, FileNotFoundError) as e:
        # config errors (bad --scene, invalid knob combos, missing env
        # file) read as one line, not a traceback — the CLI analog of
        # CheckValidSettings' message box (Application.cpp:36-94)
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    from cpuperformanceraytracer_tpu.utils.compile_cache import (
        setup_compile_cache,
    )

    setup_compile_cache()
    sys.exit(main())
