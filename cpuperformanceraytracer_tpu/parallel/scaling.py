"""Scaling harness: rays/s at 1 device vs N devices on a mesh.

Measures rays/s at 1 device and at N devices of one mesh. On the
virtual CPU mesh it validates the sharding logic only (a speedup there
reflects host cores, not the cards).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import jax

from cpuperformanceraytracer_tpu.config import RenderConfig
from cpuperformanceraytracer_tpu.parallel.mesh import make_mesh
from cpuperformanceraytracer_tpu.parallel.shard import make_sharded_frame_fn
from cpuperformanceraytracer_tpu.render.frame import make_frame_fn, zero_accum


@dataclasses.dataclass
class ScalePoint:
    devices: int
    ms_per_frame: float
    mrays_per_s: float
    efficiency: float  # vs linear scaling from the 1-device point


def _time_frames(frame_fn, scene, camera, texture, cfg, frames: int) -> float:
    """Protocol-consistent timing: warmup frames, then MEAN wall-clock
    ms/frame over a timed span — the reference's offline benchmark
    protocol (Application.cpp:420-452), matching every other number in
    the repo (min-of-frames is not comparable to them)."""
    accum = zero_accum(cfg)
    warm = max(1, cfg.warmup_frames)
    for f in range(warm):
        accum = frame_fn(scene, camera, texture, f, accum)
    jax.block_until_ready(accum)
    t0 = time.perf_counter()
    for f in range(warm, warm + frames):
        accum = frame_fn(scene, camera, texture, f, accum)
    jax.block_until_ready(accum)
    return (time.perf_counter() - t0) / frames * 1e3


def measure_scaling(
    scene, camera, texture, cfg: RenderConfig,
    device_counts: Optional[List[int]] = None,
    frames: int = 5,
    spp_shards: int = 1,
) -> List[ScalePoint]:
    """Time the frame step at several mesh widths; devices beyond index 0
    are idle for narrower meshes, so the comparison is honest."""
    all_devices = jax.devices()
    if device_counts is None:
        device_counts = sorted({1, 2, len(all_devices)})
    rays = cfg.width * cfg.height * cfg.spp

    points: List[ScalePoint] = []
    base_ms = None
    for n in device_counts:
        if n > len(all_devices):
            continue
        if n == 1:
            fn = make_frame_fn(cfg)
        else:
            mesh = make_mesh((n // spp_shards, spp_shards), ("px", "spp"),
                             devices=all_devices[:n])
            fn = make_sharded_frame_fn(cfg, mesh)
        ms = _time_frames(fn, scene, camera, texture, cfg, frames)
        if base_ms is None:
            base_ms = ms
        eff = (base_ms / ms) / n
        points.append(ScalePoint(
            devices=n, ms_per_frame=ms,
            mrays_per_s=rays / (ms / 1e3) / 1e6, efficiency=eff,
        ))
    return points
