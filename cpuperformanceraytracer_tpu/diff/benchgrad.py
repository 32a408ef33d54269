"""fwd+bwd benchmark: value_and_grad of the L2 pixel loss through the
full bounce loop (BASELINE.json: "Mrays/s/chip fwd+bwd at 1280x720
8-bounce").

K steps are fused into ONE dispatch via lax.scan, the executable is
compiled and run once before timing, and the mean is taken over >= 2
independently timed spans whose spread is reported. Protocol anchor:
the reference's offline benchmark — warmup then mean wall-clock over a
fixed span (Application.cpp:420-452) — applied to the training step.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp

from cpuperformanceraytracer_tpu.config import RenderConfig
from cpuperformanceraytracer_tpu.diff.grad import (
    image_loss,
    render_for_params,
)


def make_grad_step_k(loss_fn: Callable, k: int) -> Callable:
    """jit((params, frame0) -> (grad_sum, losses(k,))): K value_and_grad
    evaluations fused into ONE device dispatch via lax.scan.

    Each step uses a fresh frame index (fresh counter-RNG sample set, so
    no step is trivially cached); gradients are summed into the carry so
    every step's backward work is live (nothing DCEs).
    """

    @jax.jit
    def step_k(params, frame0):
        def body(carry, i):
            loss, grads = jax.value_and_grad(loss_fn)(params, frame0 + i)
            return jax.tree.map(jnp.add, carry, grads), loss

        init = jax.tree.map(jnp.zeros_like, params)
        return jax.lax.scan(body, init,
                            jnp.arange(k, dtype=jnp.uint32))

    return step_k


def default_bench_params(scene, texture) -> Dict:
    """The full differentiable surface the BASELINE.md row advertises:
    sphere centers + material albedos (+ every env texel when an env
    texture is present), perturbed off the truth so gradients are
    non-trivial."""
    albedo = jnp.stack([scene.materials.albedo.x, scene.materials.albedo.y,
                        scene.materials.albedo.z], -1)
    centers = jnp.stack([scene.spheres.center.x, scene.spheres.center.y,
                         scene.spheres.center.z], -1)
    params = {"albedo": albedo + 0.05, "sphere_centers": centers + 0.1}
    if texture is not None:
        params["env_rgb"] = jnp.stack(
            [texture.r, texture.g, texture.b], -1)
    return params


def fwd_bwd_benchmark(cfg: RenderConfig, scene, camera, texture,
                      params: Optional[Dict] = None, steps: int = 64,
                      steps_per_dispatch: int = 16, spans: int = 2) -> Dict:
    """Measure value_and_grad(L2 pixel loss) throughput; returns a dict
    with ms_per_step, Mrays_per_s, per-span times, and relative spread.

    ``steps``: total timed optimizer-step equivalents (rounded up to a
    multiple of ``steps_per_dispatch``), split over ``spans``
    independently-timed spans so run-to-run stability is part of the
    result, not an assumption.
    """
    cfg = cfg.validate()
    if params is None:
        params = default_bench_params(scene, texture)
    target = render_for_params({}, scene, camera, texture, cfg, 0)
    target = jax.tree.map(jax.lax.stop_gradient, target)

    def loss_fn(p, frame):
        img = render_for_params(p, scene, camera, texture, cfg, frame)
        return image_loss(img, target)

    k = max(1, min(steps_per_dispatch, steps))
    step_k = make_grad_step_k(loss_fn, k)

    calls_per_span = max(1, steps // (k * spans))
    # warm-up: one compile + one call
    t0 = time.perf_counter()
    compiled = step_k.lower(params, jnp.uint32(0)).compile()
    compile_s = time.perf_counter() - t0
    grads, losses = jax.block_until_ready(compiled(params, jnp.uint32(0)))

    span_ms = []
    frame0 = 1
    for _ in range(spans):
        t0 = time.perf_counter()
        for _ in range(calls_per_span):
            grads, losses = compiled(params, jnp.uint32(frame0))
            frame0 += k
        jax.block_until_ready((grads, losses))
        span_ms.append((time.perf_counter() - t0)
                       / (calls_per_span * k) * 1e3)

    ms = sum(span_ms) / len(span_ms)
    rays = cfg.width * cfg.height * cfg.spp
    finite = bool(all(bool(jnp.isfinite(g).all())
                      for g in jax.tree.leaves(grads)))
    mem = compiled.memory_analysis()
    stats = jax.devices()[0].memory_stats() or {}
    return {
        "ms_per_step": ms,
        "Mrays_per_s": rays / ms / 1e3,
        "span_ms": [round(s, 3) for s in span_ms],
        "spread": (max(span_ms) - min(span_ms)) / ms if len(span_ms) > 1
        else 0.0,
        "steps_per_dispatch": k,
        "steps_timed": calls_per_span * k * len(span_ms),
        "loss": float(losses[-1]),
        "grads_finite": finite,
        "param_leaves": sorted(params),
        "compile_s": compile_s,
        # XLA's static buffer plan for one K-step dispatch
        "temp_bytes": getattr(mem, "temp_size_in_bytes", None),
        "argument_bytes": getattr(mem, "argument_size_in_bytes", None),
        # the device allocator's high-water mark (None where the
        # platform reports no memory stats, e.g. the CPU)
        "peak_bytes_in_use": stats.get("peak_bytes_in_use"),
    }
