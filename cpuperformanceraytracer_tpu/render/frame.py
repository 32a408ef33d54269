"""Frame-level orchestration: fragCoord grids, vmap over pixels,
progressive accumulation, postprocess.

Replaces the reference's L4 orchestrator (DemofoxRenderOptV4 + RenderTile,
demofox_path_tracing_optimization_v4.cpp:1696-1721, 1179-1258): the
150-work-item tile fan-out becomes one vmap over all pixels that XLA
tiles onto the device itself; the tile-contiguous buffer layout trick is
dropped entirely (XLA picks layouts). Accumulation keeps the reference's
progressive running mean c += (new - c) / (n+1) (:1199-1241).

Image convention: arrays are (H, W), row 0 = top. fragCoord.y is
flipped (fragCoord.y = H-1-row) exactly like the reference's top-down
buffer walk (DemofoxRenderScalar, demofox_path_tracing_scalar.cpp:803).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from cpuperformanceraytracer_tpu.config import RenderConfig
from cpuperformanceraytracer_tpu.core.color import postprocess_color, to_u8
from cpuperformanceraytracer_tpu.core.vecmath import Vec3
from cpuperformanceraytracer_tpu.render.integrator import render_pixel


def _frag_coords(cfg: RenderConfig):
    """Flat (P,) f32 fragCoord arrays, row-major from the top-left pixel."""
    cols = jnp.arange(cfg.width, dtype=jnp.float32)
    rows = jnp.arange(cfg.height, dtype=jnp.float32)
    frag_y = (cfg.height - 1) - rows  # flip: fragCoord y is bottom-up
    fy, fx = jnp.meshgrid(frag_y, cols, indexing="ij")
    return fx.reshape(-1), fy.reshape(-1)


def render_frame(scene, camera, texture, cfg: RenderConfig, frame) -> Vec3:
    """One frame of cfg.spp samples for every pixel -> Vec3 of (H, W)."""
    fx, fy = _frag_coords(cfg)
    pixel_fn = lambda x, y: render_pixel(scene, camera, texture, cfg, x, y, frame)
    color = jax.vmap(pixel_fn)(fx, fy)
    return Vec3(
        color.x.reshape(cfg.height, cfg.width),
        color.y.reshape(cfg.height, cfg.width),
        color.z.reshape(cfg.height, cfg.width),
    )


def accumulate_frame(accum: Vec3, frame_color: Vec3, frame) -> Vec3:
    """Progressive running mean over frames: accum_n = accum + (x-accum)/(n+1)
    with frame 0-based (RenderTile blend, v4 :1199-1241 — the reference's
    1-based iFrame halves its very first frame into a zero buffer; here
    frame 0 stores the first frame exactly)."""
    blend = 1.0 / (jnp.float32(frame) + 1.0)
    return Vec3(
        accum.x + (frame_color.x - accum.x) * blend,
        accum.y + (frame_color.y - accum.y) * blend,
        accum.z + (frame_color.z - accum.z) * blend,
    )


def postprocess_image(accum: Vec3, exposure: float = 1.0) -> jnp.ndarray:
    """f32 accumulation -> display u8 (H, W, 3): exposure, ACES, sRGB,
    round (OutputToScreen/OutputToFile, v4 :1260-1331, without the
    BGRA/RGBA packing games — callers pick channel order at IO time)."""
    return to_u8(postprocess_color(accum, exposure))


def _make_render(cfg: RenderConfig, static_scene, static_camera):
    """(scene, camera, texture, frame) -> color for cfg.backend. With
    backend "pallas", cfg.bake_scene and a concrete scene/camera pair,
    the returned fn IGNORES its scene/camera arguments and uses the
    baked ones (compile-time constants inside the Pallas kernel)."""
    if cfg.backend == "pallas":
        from cpuperformanceraytracer_tpu.kernels.megakernel import (
            render_frame_pallas,
        )

        if cfg.bake_scene and static_scene is not None:
            return lambda s, c, t, f: render_frame_pallas(
                static_scene, static_camera, t, cfg, f)
        return lambda s, c, t, f: render_frame_pallas(s, c, t, cfg, f)
    return lambda s, c, t, f: render_frame(s, c, t, cfg, f)


def make_frame_fn(cfg: RenderConfig, backend: Optional[str] = None,
                  scene=None, camera=None):
    """Build the jitted progressive-frame step:
    (scene, camera, texture, frame, accum) -> accum'.

    The accumulation buffer is donated — the device updates it in place,
    the analog of the reference rendering straight into its persistent
    f32 render target. Pass a concrete ``scene``/``camera`` to let
    cfg.bake_scene specialize the Pallas kernel on them (the jitted fn
    then ignores its scene/camera arguments).
    """
    if backend:
        cfg = cfg.replace(backend=backend)
    render = _make_render(cfg.validate(), scene, camera)

    def step(scene, camera, texture, frame, accum):
        color = render(scene, camera, texture, frame)
        return accumulate_frame(accum, color, frame)

    return jax.jit(step, donate_argnums=(4,))


def make_multi_frame_fn(cfg: RenderConfig, frames_per_dispatch: int,
                        scene=None, camera=None):
    """Build a jitted K-frame progressive step:
    (scene, camera, texture, frame0, accum) -> accum after K frames.

    K frames ride ONE dispatch through a lax.fori_loop (the render is
    traced once; the frame index is loop-carried), so host dispatch
    overhead is paid once per K frames. The reference's analog is its
    600-frame offline loop with no per-frame host round-trips
    (Application.cpp:426-438). ``scene``/``camera``: as make_frame_fn."""
    render = _make_render(cfg.validate(), scene, camera)

    def step_k(scene, camera, texture, frame0, accum):
        def body(i, acc):
            frame = frame0 + i
            color = render(scene, camera, texture, frame)
            return accumulate_frame(acc, color, frame)

        return jax.lax.fori_loop(0, frames_per_dispatch, body, accum)

    return jax.jit(step_k, donate_argnums=(4,))


def zero_accum(cfg: RenderConfig) -> Vec3:
    """Fresh accumulation buffer: three (H, W) planes."""
    # three distinct buffers: the planes are donated to the frame step,
    # and donating one shared buffer three times is an error
    return Vec3(*(jnp.zeros((cfg.height, cfg.width), jnp.float32)
                  for _ in range(3)))
