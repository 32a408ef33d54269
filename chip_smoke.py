"""Smoke test of the path tracer on an NVIDIA GPU.

Drives the main path once through the entry points a user calls, at the
reference default workload (1280x720, 8 bounces, 1 spp, glass_spheres,
equirect env from the seeded procedural 512x256 sky, stochastic
sampling):

  card      the card's name and power limit (nvidia-smi, a child process)
  cache     the persistent compile-cache directory
  forward   progressive frames through OfflineRenderer for each backend
            (the Pallas kernel and XLA), headline and simd_tiled_720
  parity    the compiled kernel against the plain XLA reference on the
            card at 1280x720, and XLA on the card against the CPU oracle
  train     fwd+bwd steps at 720p through the XLA adjoint, with and
            without remat, then a few Adam steps whose loss must fall

Every phase prints one line with its seconds; every time or rate is
printed beside the card's name and power limit. The last line of
standard output is one JSON object, {"ok": true, "device": {...}}, and
is printed only when every phase passed. Without a GPU, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.

  python chip_smoke.py          # one card
  python chip_smoke.py --four   # only the sharded path, on four cards
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


class Smoke:
    def __init__(self, card: str):
        self.card = card

    def phase(self, name, fn):
        t0 = time.perf_counter()
        fn()
        print(f"[{name}] done in {time.perf_counter() - t0:.1f} s",
              flush=True)

    def say(self, msg: str, timed: bool = False):
        print(f"  {msg}" + (f"  [{self.card}]" if timed else ""), flush=True)


def _check(cond: bool, msg: str):
    if not cond:
        raise AssertionError(msg)


def _headline(**kw):
    from cpuperformanceraytracer_tpu.config import BENCH_CONFIGS

    return BENCH_CONFIGS["reference_default"].replace(**kw)


def _sky():
    from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu.texture.texture import texture_from_array

    return texture_from_array(gradient_sky(512, 256))


def _planes(v):
    import numpy as np

    return np.stack([np.asarray(c) for c in v])


def forward(s: Smoke, tex):
    import numpy as np

    from cpuperformanceraytracer_tpu.config import BENCH_CONFIGS
    from cpuperformanceraytracer_tpu.render.driver import OfflineRenderer

    for name, frames in (("reference_default", 48), ("simd_tiled_720", 16)):
        means = {}
        for backend in ("pallas", "xla"):
            cfg = BENCH_CONFIGS[name].replace(backend=backend,
                                              num_frames=frames,
                                              warmup_frames=1)
            r = OfflineRenderer(cfg, silent=True,
                                texture=tex if cfg.env_mode != "none"
                                else None)
            t = r.run()
            img = r.image_u8()
            acc = _planes(r.state.accum)
            rays = cfg.width * cfg.height * cfg.spp
            s.say(f"{name} {backend}: {t.mean_ms:.4f} ms/frame, "
                  f"{t.rays_per_second(rays) / 1e6:.1f} Mrays/s over "
                  f"{t.timed_frames} frames", timed=True)
            nonzero = float(np.mean(img.max(axis=-1) > 0))
            s.say(f"  image {img.shape}: finite {np.isfinite(acc).all()}, "
                  f"mean pixel {img.mean():.2f}, non-zero pixels "
                  f"{nonzero:.4f}")
            _check(np.isfinite(acc).all(), f"{name} {backend}: non-finite")
            _check(img.shape == (cfg.height, cfg.width, 3), "image shape")
            _check(nonzero > 0.5 and img.mean() > 5,
                   f"{name} {backend}: implausible image")
            means[backend] = float(acc.mean())
        # same frames, same RNG streams: the two backends' images agree
        _check(abs(means["pallas"] - means["xla"]) < 0.01 * means["xla"],
               f"{name}: pallas mean {means['pallas']} vs xla "
               f"{means['xla']}")


def _diff_stats(got, want):
    import numpy as np

    d = np.abs(got - want)
    return dict(
        max=float(d.max()), mean=float(d.mean()),
        rel_mean=float(abs(got.mean() - want.mean())
                       / max(abs(want.mean()), 1e-9)),
        frac_1e3=float(np.mean(d > 1e-3)),
        out_of_allclose=int(np.sum(d > 1e-5 + 1e-4 * np.abs(want))),
    )


def parity(s: Smoke, tex):
    import jax
    import numpy as np

    from cpuperformanceraytracer_tpu.kernels.megakernel import (
        render_frame_pallas,
    )
    from cpuperformanceraytracer_tpu.render.frame import render_frame
    from cpuperformanceraytracer_tpu.scene.presets import scene_by_name

    def both(cfg, texture, frame):
        # the reference runs un-jitted, as the tests run it: under one
        # jit XLA would also fuse the scene's precomputed quad planes
        # (cross products) with FMAs, which the kernel's tables, baked
        # op by op, do not have, and a 1-ulp edge moves a pixel
        scene, cam = scene_by_name(cfg.scene)
        ker = jax.jit(lambda t: render_frame_pallas(scene, cam, t, cfg,
                                                    frame))
        return (_planes(ker(texture)),
                _planes(render_frame(scene, cam, texture, cfg, frame)))

    # decision-stable: diffuse cornell box, roulette off
    strict = _headline(scene="cornell_box", env_mode="none",
                       ambient=(0.1, 0.1, 0.1), env_flip_xz=False,
                       jitter=False, roulette="off")
    got, want = both(strict, None, 2)
    st = _diff_stats(got, want)
    s.say(f"cornell_box 1280x720 kernel vs XLA: {st}")
    _check(np.isfinite(got).all(), "kernel cornell non-finite")
    _check(st["out_of_allclose"] == 0,
           "cornell kernel vs XLA outside allclose(rtol=1e-4, atol=1e-5)")

    # glass + env: a 1-ulp difference can flip a Fresnel lottery roll
    got, want = both(_headline(), tex, 1)
    st = _diff_stats(got, want)
    s.say(f"glass_spheres+env 1280x720 kernel vs XLA: {st}")
    _check(np.isfinite(got).all(), "kernel glass non-finite")
    _check(st["rel_mean"] < 5e-3 and st["frac_1e3"] < 0.01,
           "glass kernel vs XLA outside the robust statistics")

    # XLA on the card against the CPU oracle, same process
    small = _headline(width=256, height=64)
    scene, cam = scene_by_name(small.scene)
    gpu = _planes(render_frame(scene, cam, tex, small, 1))
    cpu_dev = jax.devices("cpu")[0]
    with jax.default_device(cpu_dev):
        scene, cam, tex_cpu = jax.device_put((scene, cam, tex), cpu_dev)
        cpu = _planes(render_frame(scene, cam, tex_cpu, small, 1))
    st = _diff_stats(gpu, cpu)
    s.say(f"glass_spheres+env 256x64 XLA GPU vs CPU oracle: {st}")
    _check(st["rel_mean"] < 5e-3 and st["frac_1e3"] < 0.01,
           "GPU vs CPU outside the robust statistics")


def train(s: Smoke, tex):
    import jax.numpy as jnp
    import numpy as np

    from cpuperformanceraytracer_tpu.diff.benchgrad import (
        default_bench_params,
        fwd_bwd_benchmark,
    )
    from cpuperformanceraytracer_tpu.diff.grad import render_for_params
    from cpuperformanceraytracer_tpu.diff.inverse import (
        InverseProblem,
        adam_inverse_render,
    )
    from cpuperformanceraytracer_tpu.scene.presets import scene_by_name

    cfg = _headline(rng="counter")
    scene, cam = scene_by_name(cfg.scene)
    # remat first: the peak-bytes counter only ever grows
    for remat in (True, False):
        r = fwd_bwd_benchmark(cfg.replace(remat_bounces=remat), scene, cam,
                              tex, steps=8, steps_per_dispatch=4)
        s.say(f"fwd+bwd 1280x720 remat={remat}: {r['ms_per_step']:.3f} "
              f"ms/step, {r['Mrays_per_s']:.1f} Mrays/s, spans "
              f"{r['span_ms']}", timed=True)
        s.say(f"  compile {r['compile_s']:.1f} s; memory_analysis temp "
              f"{r['temp_bytes']} B, arguments {r['argument_bytes']} B; "
              f"peak_bytes_in_use {r['peak_bytes_in_use']} B; grads "
              f"finite {r['grads_finite']}")
        _check(r["grads_finite"], f"non-finite grads (remat={remat})")

    # Adam on the full surface (albedo, sphere centres, every env
    # texel) from a perturbed start, one fixed sample set
    target = render_for_params({}, scene, cam, tex, cfg, 0)
    init = default_bench_params(scene, tex)
    init["albedo"] = jnp.clip(init["albedo"] + 0.1, 0.0, 1.0)
    prob = InverseProblem(scene, cam, tex, cfg, target)
    t0 = time.perf_counter()
    params, losses = adam_inverse_render(prob, init, steps=8,
                                         learning_rate=0.002,
                                         steps_per_dispatch=4)
    s.say(f"Adam 8 steps 1280x720: loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f} ({time.perf_counter() - t0:.1f} s incl. "
          f"compile)", timed=True)
    _check(all(np.isfinite(losses)), "non-finite loss")
    _check(losses[-1] < losses[0], "loss did not decrease")
    _check(all(bool(jnp.isfinite(v).all()) for v in params.values()),
           "non-finite params")


def four(s: Smoke, tex):
    """The sharded path and what it is compared with, nothing else."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cpuperformanceraytracer_tpu.config import BENCH_CONFIGS
    from cpuperformanceraytracer_tpu.diff.benchgrad import (
        default_bench_params,
    )
    from cpuperformanceraytracer_tpu.diff.grad import (
        apply_params,
        image_loss,
        render_for_params,
    )
    from cpuperformanceraytracer_tpu.parallel.shard import (
        sharded_render_frame,
    )
    from cpuperformanceraytracer_tpu.render.driver import OfflineRenderer
    from cpuperformanceraytracer_tpu.scene.presets import scene_by_name

    cfg = BENCH_CONFIGS["offline_4k"].replace(num_frames=8,
                                              warmup_frames=1)
    mesh = jax.make_mesh((4,), ("px",))
    r4 = OfflineRenderer(cfg, texture=tex, silent=True, mesh=mesh)
    t4 = r4.run()
    r1 = OfflineRenderer(cfg, texture=tex, silent=True)
    t1 = r1.run()
    rays = cfg.width * cfg.height
    s.say(f"offline_4k 3840x2160 x{cfg.num_frames} frames: 4 cards "
          f"{t4.mean_ms:.3f} ms/frame ({t4.rays_per_second(rays) / 1e6:.1f}"
          f" Mrays/s), 1 card {t1.mean_ms:.3f} ms/frame", timed=True)
    a4, a1 = _planes(r4.state.accum), _planes(r1.state.accum)
    st = _diff_stats(a4, a1)
    s.say(f"  4-card vs 1-card image: {st}")
    _check(np.isfinite(a4).all(), "sharded 4K image non-finite")
    # counter RNG and the same baked kernel per pixel: the images agree
    np.testing.assert_allclose(a4, a1, rtol=1e-5, atol=1e-6)

    # one sharded fwd+bwd step on a (2, 2) ("px", "spp") mesh
    # training differentiates the XLA integrator (backend "xla")
    gcfg = BENCH_CONFIGS["reference_default"].replace(
        backend="xla", rng="counter", spp=2)
    scene, cam = scene_by_name(gcfg.scene)
    mesh = jax.make_mesh((2, 2), ("px", "spp"))
    target = render_for_params({}, scene, cam, tex, gcfg, 0)
    params = default_bench_params(scene, tex)

    def sharded_loss(p):
        sc, t = apply_params(scene, tex, p)
        return image_loss(sharded_render_frame(sc, cam, t, gcfg, 1, mesh),
                          target)

    def loss(p):
        return image_loss(render_for_params(p, scene, cam, tex, gcfg, 1),
                          target)

    t0 = time.perf_counter()
    ls, gs = jax.block_until_ready(
        jax.jit(jax.value_and_grad(sharded_loss))(params))
    s.say(f"(2,2) sharded fwd+bwd step 1280x720 spp2: loss {float(ls):.6f}"
          f" ({time.perf_counter() - t0:.1f} s incl. compile)", timed=True)
    lu, gu = jax.jit(jax.value_and_grad(loss))(params)
    _check(abs(float(ls) - float(lu)) <= 1e-5 * max(abs(float(lu)), 1.0),
           f"sharded loss {float(ls)} vs unsharded {float(lu)}")
    for key in sorted(params):
        a, b = np.asarray(gu[key]), np.asarray(gs[key])
        scale = max(float(np.abs(a).max()), 1e-6)
        err = float(np.abs(a - b).max()) / scale
        s.say(f"  grad {key}: max |sharded - unsharded| / max|g| = "
              f"{err:.3e}")
        _check(np.isfinite(b).all(), f"sharded grad {key} non-finite")
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5 * scale,
                                   err_msg=key)
    _check(all(bool(jnp.isfinite(v).all()) for v in gs.values()),
           "non-finite sharded grads")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded path")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    import cpuperformanceraytracer_tpu as pkg

    if os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))) != HERE:
        print(f"error: the package beside {HERE} is missing",
              file=sys.stderr)
        return 2
    from cpuperformanceraytracer_tpu.utils.device import card_info, gpu_devices

    try:
        devices = gpu_devices(4 if args.four else 1)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    s = Smoke(card_info())
    s.phase("card", lambda: s.say(f"card: {s.card}"))

    def cache():
        from cpuperformanceraytracer_tpu.utils.compile_cache import (
            setup_compile_cache,
        )

        s.say(f"compile cache: {setup_compile_cache()}")

    s.phase("cache", cache)
    tex = _sky()
    if args.four:
        s.phase("four", lambda: four(s, tex))
    else:
        s.phase("forward", lambda: forward(s, tex))
        s.phase("parity", lambda: parity(s, tex))
        s.phase("train", lambda: train(s, tex))

    print(f"card: {s.card}")
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
