"""shard_map'd frame rendering: static pixel-row + sample sharding.

The replacement for the reference's dynamic work queue
(demofox_path_tracing_optimization_v4.cpp:1567-1694): pixel rows shard
over the mesh "px" axis (every shard renders its block — the cost is
uniform by construction, so no load balancing is needed), and the spp
axis shards over "spp" with counter-RNG sample offsets, reduced with a
``psum`` — the collective that replaces the interlocked completion
counter + semaphore join (work_queue.cpp:17-66).

The same function is the sharded training path: under ``jax.grad``
(backend "xla"), replicated scene/texture parameters transpose to a
psum of their cotangents, so gradients all-reduce with no
hand-written communication.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from cpuperformanceraytracer_tpu.config import RenderConfig
from cpuperformanceraytracer_tpu.core.vecmath import Vec3
from cpuperformanceraytracer_tpu.render.frame import accumulate_frame
from cpuperformanceraytracer_tpu.render.integrator import render_pixel


def _replicated_like(tree):
    return jax.tree.map(lambda _: P(), tree)


def sharded_render_frame(scene, camera, texture, cfg: RenderConfig, frame,
                         mesh: Mesh, baked=None) -> Vec3:
    """One frame, sharded: rows over "px", samples over "spp".

    Requires cfg.height % mesh.shape["px"] == 0 (static sharding — the
    analog of CheckValidSettings' tile divisibility rule) and
    cfg.rng == "counter" whenever spp is sharded (wang streams are
    sequential per pixel and cannot split mid-stream).
    
    ``baked``: optional concrete (scene, camera) for backend "pallas":
    each shard's kernel then has the scene as compile-time constants, as
    the single-device frame step does (render.frame.make_frame_fn).
    """
    n_px = mesh.shape.get("px", 1)
    n_spp = mesh.shape.get("spp", 1)
    if cfg.height % n_px:
        raise ValueError(f"height {cfg.height} not divisible by px shards {n_px}")
    if cfg.spp % n_spp:
        raise ValueError(f"spp {cfg.spp} not divisible by spp shards {n_spp}")
    if n_spp > 1 and cfg.rng != "counter":
        raise ValueError('spp sharding requires rng="counter"')
    spp_local = cfg.spp // n_spp

    scene_spec = _replicated_like(scene)
    camera_spec = _replicated_like(camera)
    texture_spec = _replicated_like(texture) if texture is not None else None

    h_local = cfg.height // n_px
    w = cfg.width

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(scene_spec, camera_spec, texture_spec, P()),
        out_specs=P(None, "px", None),  # (3, H, W), rows sharded
        # constants created inside the body (loop-carry zeros) are
        # device-invariant while loop outputs vary per shard; the vma
        # check rejects that mix, so it is disabled here (the psum above
        # is the only cross-shard communication and is explicit)
        check_vma=False,
    )
    def shard_fn(scene, camera, texture, frame):
        spp_idx = lax.axis_index("spp") if n_spp > 1 else 0
        # each shard derives its own global pixel-row window from its
        # mesh coordinate — no host-built fragCoord arrays cross the
        # host/device boundary, which also makes this callable under
        # multi-process jax.distributed where host-local arrays cannot
        # feed a global shard_map directly
        row0 = (lax.axis_index("px") * h_local) if n_px > 1 else 0

        if cfg.backend == "pallas":
            # the fast path under SPMD: each shard runs the kernel on
            # its global pixel-row window; spp shards offset the
            # counter-RNG sample window (one partial sum each, psum'd)
            from cpuperformanceraytracer_tpu.kernels.megakernel import (
                render_frame_pallas,
            )

            if baked is not None:
                scene, camera = baked
            color = render_frame_pallas(
                scene, camera, texture, cfg.replace(spp=spp_local), frame,
                spp_offset=spp_idx * spp_local, row0=row0,
                local_height=h_local,
            )
            planes = jnp.stack([color.x, color.y, color.z])
        else:
            cols = jnp.arange(w, dtype=jnp.float32)
            rows = row0 + jnp.arange(h_local)
            frag_y = jnp.float32(cfg.height - 1) - rows.astype(jnp.float32)
            fy_blk, fx_blk = jnp.meshgrid(frag_y, cols, indexing="ij")

            def px(x, y):
                return render_pixel(
                    scene, camera, texture, cfg, x, y, frame,
                    spp_offset=spp_idx * spp_local, spp_count=spp_local,
                )

            color = jax.vmap(px)(fx_blk.reshape(-1), fy_blk.reshape(-1))
            planes = jnp.stack(
                [c.reshape(h_local, w) for c in (color.x, color.y, color.z)]
            )
        if n_spp > 1:
            planes = lax.psum(planes, "spp") / n_spp
        return planes

    planes = shard_fn(scene, camera, texture, jnp.asarray(frame, jnp.uint32))
    return Vec3(planes[0], planes[1], planes[2])


def _bake(cfg: RenderConfig, scene, camera):
    if cfg.backend == "pallas" and cfg.bake_scene and scene is not None:
        return scene, camera
    return None


def make_sharded_frame_fn(cfg: RenderConfig, mesh: Mesh, scene=None,
                          camera=None):
    """Jitted sharded progressive step:
    (scene, camera, texture, frame, accum) -> accum'. A concrete
    ``scene``/``camera`` is baked into the Pallas kernel, as in
    render.frame.make_frame_fn."""
    cfg = cfg.validate()
    baked = _bake(cfg, scene, camera)

    @partial(jax.jit, donate_argnums=(4,), static_argnames=())
    def step(scene, camera, texture, frame, accum):
        color = sharded_render_frame(scene, camera, texture, cfg, frame, mesh,
                                     baked)
        return accumulate_frame(accum, color, frame)

    return step


def make_sharded_multi_frame_fn(cfg: RenderConfig, mesh: Mesh,
                                frames_per_dispatch: int, scene=None,
                                camera=None):
    """Jitted K-frame sharded step — the mesh analog of
    render.frame.make_multi_frame_fn: K progressive frames ride one
    dispatch via lax.fori_loop (the shard_map is traced once inside the
    loop body), so the multi-card offline path pays per-dispatch overhead
    once per K frames instead of per frame. ``scene``/``camera``: as
    make_sharded_frame_fn."""
    cfg = cfg.validate()
    baked = _bake(cfg, scene, camera)

    @partial(jax.jit, donate_argnums=(4,), static_argnames=())
    def step_k(scene, camera, texture, frame0, accum):
        def body(i, acc):
            frame = frame0 + i
            color = sharded_render_frame(scene, camera, texture, cfg,
                                         frame, mesh, baked)
            return accumulate_frame(acc, color, frame)

        return jax.lax.fori_loop(0, frames_per_dispatch, body, accum)

    return step_k
