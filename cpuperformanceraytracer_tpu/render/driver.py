"""Offline render driver: warmup + timed frame loop, progress, output,
checkpoint/resume, screenshot.

The mirror of ApplicationState::RenderOffline
(Application.cpp:400-458): N warmup frames, a timed loop of num_frames
progressive frames, ms/frame + rays/s reporting, and a final
postprocess-and-write. Adds what the reference lacks: periodic
checkpointing and resumable accumulation state.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import jax
import numpy as np

from cpuperformanceraytracer_tpu.config import RenderConfig
from cpuperformanceraytracer_tpu.core.vecmath import Vec3
from cpuperformanceraytracer_tpu.io.checkpoint import resume_or_fresh, save_checkpoint
from cpuperformanceraytracer_tpu.io.image import write_bmp, write_png
from cpuperformanceraytracer_tpu.render.frame import (
    make_frame_fn,
    postprocess_image,
    zero_accum,
)
from cpuperformanceraytracer_tpu.scene.presets import scene_by_name
from cpuperformanceraytracer_tpu.utils.log import get_logger, progress
from cpuperformanceraytracer_tpu.utils.timing import FrameTimer


@dataclasses.dataclass
class RenderState:
    accum: Vec3
    frame: int


class OfflineRenderer:
    """Progressive offline renderer over a scene preset.

    rays/s accounting: primary rays per frame = W*H*spp; the ms/frame
    protocol matches the reference's offline benchmark
    (Application.cpp:420-452).
    """

    def __init__(self, cfg: RenderConfig, texture=None, scene=None, camera=None,
                 silent: bool = False, mesh=None):
        """``mesh``: optional jax.sharding.Mesh — frames then render via
        shard_map over (px rows, spp samples), the multi-card path for the
        4K/1024spp offline config (BASELINE.json config 5)."""
        self.cfg = cfg.validate()
        if scene is None or camera is None:
            scene, camera = scene_by_name(cfg.scene)
        self.scene = scene
        self.camera = camera
        self.texture = texture
        self.log = get_logger(silent=silent)
        if mesh is not None:
            from cpuperformanceraytracer_tpu.parallel.shard import (
                make_sharded_frame_fn,
            )

            self.frame_fn = make_sharded_frame_fn(self.cfg, mesh, scene,
                                                  camera)
        else:
            self.frame_fn = make_frame_fn(self.cfg, scene=self.scene,
                                          camera=self.camera)
        self._multi_fn = None  # built lazily per dispatch width
        self._multi_k = 0
        self.mesh = mesh
        self.state = RenderState(accum=self._place(zero_accum(self.cfg)),
                                 frame=0)

    def _place(self, accum: Vec3) -> Vec3:
        """Under a mesh, lay the accumulation planes out as the sharded
        frame step returns them (rows over "px"), so every call sees one
        input sharding and the step compiles once."""
        if self.mesh is None:
            return accum
        from jax.sharding import NamedSharding, PartitionSpec

        return jax.device_put(
            accum, NamedSharding(self.mesh, PartitionSpec("px", None)))

    def resume(self, checkpoint_path: Optional[str]) -> None:
        accum, frame = resume_or_fresh(checkpoint_path, self.cfg)
        self.state = RenderState(accum=self._place(accum), frame=frame)

    def step(self) -> None:
        """One progressive frame."""
        self.state.accum = self.frame_fn(
            self.scene, self.camera, self.texture, self.state.frame,
            self.state.accum,
        )
        self.state.frame += 1

    def step_k(self, k: int) -> None:
        """``k`` progressive frames in ONE device dispatch (fused via
        lax.fori_loop; see make_multi_frame_fn and, under a mesh,
        make_sharded_multi_frame_fn). Falls back to per-frame steps only
        for k == 1."""
        if k == 1:
            for _ in range(k):
                self.step()
            return
        if self._multi_fn is None or self._multi_k != k:
            if self.mesh is not None:
                from cpuperformanceraytracer_tpu.parallel.shard import (
                    make_sharded_multi_frame_fn,
                )

                self._multi_fn = make_sharded_multi_frame_fn(
                    self.cfg, self.mesh, k, self.scene, self.camera)
            else:
                from cpuperformanceraytracer_tpu.render.frame import (
                    make_multi_frame_fn,
                )

                self._multi_fn = make_multi_frame_fn(
                    self.cfg, k, scene=self.scene, camera=self.camera)
            self._multi_k = k
        self.state.accum = self._multi_fn(
            self.scene, self.camera, self.texture, self.state.frame,
            self.state.accum,
        )
        self.state.frame += k

    def run(self, checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 0) -> FrameTimer:
        """Warmup + timed loop (the offline benchmark protocol).

        Frames are enqueued back-to-back — each depends on the previous
        accumulation buffer, so one block_until_ready at the end of a
        span joins the whole chain (the reference also times the whole
        600-frame loop, not individual frames: Application.cpp:423-452).
        Per-frame joins would serialize host dispatch with device
        compute. A join (+ optional checkpoint/progress) happens every
        ``sync_every`` frames so the dispatch queue stays bounded.
        """
        cfg = self.cfg
        # warmup happens out-of-band below (scratch buffers), so the timer
        # itself skips nothing: every accumulated frame is timed
        timer = FrameTimer(warmup_frames=0)

        # dispatch width: K frames fused per device dispatch. Checkpoint
        # boundaries must land on dispatch boundaries, so K divides the
        # checkpoint cadence.
        k = cfg.frames_per_dispatch
        if not k:
            # size-aware auto K: ~15M pixel-samples per dispatch (16
            # frames at the 720p/1spp reference workload), so small
            # frames amortize the fixed per-dispatch host cost like
            # large ones; capped at 64
            work = cfg.width * cfg.height * cfg.spp
            k = max(1, min(64, round(15_000_000 / work)))
            # prefer the largest divisor of num_frames <= k: a non-divisor
            # K leaves a num_frames % K tail of slow per-frame dispatches
            divs = [d for d in range(1, min(k, cfg.num_frames) + 1)
                    if cfg.num_frames % d == 0]
            if divs and divs[-1] >= max(1, k // 4):
                k = divs[-1]
        if checkpoint_every:
            k = math.gcd(k, checkpoint_every)
        k = max(1, min(k, cfg.num_frames))

        # sync points: a multiple of K, aligned to the checkpoint cadence
        # (checkpoint_every=10 with sync_every=16 would silently coarsen
        # the cadence to lcm=80). Keep ~16-64 frames in flight per join.
        if checkpoint_every:
            sync_every = checkpoint_every * max(
                1, round(16 / checkpoint_every))
        else:
            sync_every = -(-64 // k) * k

        if cfg.warmup_frames > 0:
            # warm up on a scratch buffer so the image stays exactly equal
            # to an unwarmed run (Application.cpp:421 renders its warmup
            # frames into the target): one compile + one call of every
            # executable the timed loop uses
            keep = self.state
            self.state = RenderState(accum=self._place(zero_accum(cfg)),
                                     frame=0)
            self.step_k(k)
            if cfg.num_frames % k:
                self.step()
            jax.block_until_ready(self.state.accum)
            self.state = keep

        t0 = time.perf_counter()
        done = counted = 0
        next_sync = sync_every
        while done < cfg.num_frames:
            todo = min(k, cfg.num_frames - done)
            if todo < k:
                for _ in range(todo):
                    self.step()
            else:
                self.step_k(k)
            done += todo
            if done >= next_sync or done == cfg.num_frames:
                jax.block_until_ready(self.state.accum)
                now = time.perf_counter()
                timer.add_span(now - t0, done - counted)
                t0, counted = now, done
                next_sync = done + sync_every
                progress(self.log, done - 1, cfg.num_frames)
                if checkpoint_path and checkpoint_every and (
                    done % checkpoint_every == 0
                ):
                    save_checkpoint(checkpoint_path, self.state.accum,
                                    self.state.frame, cfg)

        rays = cfg.width * cfg.height * cfg.spp
        self.log.info(
            "mean %.3f ms/frame, %.1f Mrays/s (primary)",
            timer.mean_ms, timer.rays_per_second(rays) / 1e6,
        )
        return timer

    def image_u8(self) -> np.ndarray:
        return np.asarray(
            postprocess_image(self.state.accum, self.cfg.exposure)
        )

    def write_image(self, path: str) -> None:
        img = self.image_u8()
        if path.endswith(".png"):
            write_png(path, img)
        else:
            write_bmp(path, img)

    def screenshot(self, directory: str = ".",
                   prefix: str = "screenshot") -> str:
        """Timestamped image dump of the current accumulation — the
        's'-key screenshot path (Application.cpp:603-623, which writes
        'screenshot_<date>.bmp'). Returns the written path."""
        import os

        stamp = time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(
            directory, f"{prefix}_{stamp}_frame{self.state.frame}.bmp")
        self.write_image(path)
        return path
