"""Benchmark entry: prints ONE JSON line.

Two headline numbers at the reference default workload — 1280x720,
8 bounces, 1 spp/frame, glass_spheres, equirect env from the seeded
procedural 512x256 sky, stochastic sampling
(global_preprocessor_flags.h:30-40):

1. ``value``: forward path-trace throughput in primary Mrays/s through
   the Pallas kernel, with the reference's offline protocol (warmup,
   then mean wall-clock ms/frame, Application.cpp:420-452).
2. ``fwd_bwd_ms_per_step`` / ``fwd_bwd_Mrays_per_s``: value_and_grad of
   the L2 pixel loss through the full bounce loop (XLA's adjoint),
   gradients to sphere centers + albedos + every env texel; K steps
   fused per dispatch, mean over 2 independently timed spans
   (diff/benchgrad.py).

Every result names the device it ran on. A run that finds no GPU fails;
it does not fall back to the CPU.

  BENCH_FRAMES=128 BENCH_GRAD_STEPS=16 python bench.py
"""

import json
import os
import sys


def main() -> int:
    from cpuperformanceraytracer_tpu.utils.device import card_info, gpu_devices

    try:
        devices = gpu_devices()
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    dev = devices[0]

    from cpuperformanceraytracer_tpu.config import BENCH_CONFIGS
    from cpuperformanceraytracer_tpu.diff.benchgrad import fwd_bwd_benchmark
    from cpuperformanceraytracer_tpu.render.driver import OfflineRenderer
    from cpuperformanceraytracer_tpu.scene.presets import scene_by_name
    from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu.texture.texture import texture_from_array
    from cpuperformanceraytracer_tpu.utils.compile_cache import (
        setup_compile_cache,
    )

    setup_compile_cache()
    frames = int(os.environ.get("BENCH_FRAMES", "128"))
    grad_steps = int(os.environ.get("BENCH_GRAD_STEPS", "16"))
    texture = texture_from_array(gradient_sky(512, 256))
    cfg = BENCH_CONFIGS["reference_default"].replace(num_frames=frames)

    timer = OfflineRenderer(cfg, texture=texture, silent=True).run()
    rays = cfg.width * cfg.height * cfg.spp
    out = {
        "metric": "fwd_primary_Mrays_per_s_1280x720_8bounce",
        "value": round(timer.rays_per_second(rays) / 1e6, 2),
        "unit": "Mrays/s",
        "ms_per_frame": round(timer.mean_ms, 4),
    }

    gcfg = cfg.replace(rng="counter", num_frames=1)
    scene, cam = scene_by_name(gcfg.scene)
    g = fwd_bwd_benchmark(gcfg, scene, cam, texture, steps=grad_steps,
                          steps_per_dispatch=4)
    out.update({
        "fwd_bwd_ms_per_step": round(g["ms_per_step"], 3),
        "fwd_bwd_Mrays_per_s": round(g["Mrays_per_s"], 2),
        "fwd_bwd_spread": round(g["spread"], 4),
        "fwd_bwd_span_ms": g["span_ms"],
        "fwd_bwd_grads_finite": g["grads_finite"],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(devices), "card": card_info()},
    })
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
