"""Checkpoint / resume for long progressive renders.

The reference has none (SURVEY.md section 5): its restartable state is
implicitly the f32 accumulation target + iFrame. Here that state is
serialized explicitly — accumulation planes, frame index, and config
fingerprint — so a multi-hour 4K/1024spp offline render survives
preemption. Plain npz; the state is tiny next to render time.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np

from cpuperformanceraytracer_tpu.config import RenderConfig
from cpuperformanceraytracer_tpu.core.vecmath import Vec3

_FORMAT_VERSION = 1

# Config fields that determine the accumulated image. Resuming under a
# config that differs in ANY of these would silently average two
# different renders together; resume_or_fresh starts fresh instead.
# Excluded on purpose: backend/tile/bake/early_exit/frames_per_dispatch
# (parity-tested execution strategy, not image content),
# num_frames/warmup_frames (loop length), exposure (applied at
# postprocess time, not baked into the accumulation).
_IMAGE_FIELDS = (
    "width", "height", "spp", "bounces", "scene", "env_mode",
    "env_sampling", "ambient", "env_flip_xz", "unit_vector_sampler",
    "jitter", "rng", "roulette", "accumulate",
)


def image_fingerprint(cfg: RenderConfig) -> tuple:
    """The image-content identity of a config: two configs with equal
    fingerprints accumulate bit-identical progressive frames."""
    return tuple(
        (f, tuple(v) if isinstance(v, (list, tuple)) else v)
        for f, v in ((f, getattr(cfg, f)) for f in _IMAGE_FIELDS)
    )


def save_checkpoint(path: str, v: Vec3, frame: int, cfg: RenderConfig) -> None:
    """Write the accumulation planes, frame index and config."""
    np.savez_compressed(
        path,
        version=_FORMAT_VERSION,
        frame=int(frame),
        r=np.asarray(v.x),
        g=np.asarray(v.y),
        b=np.asarray(v.z),
        config=json.dumps(dataclasses.asdict(cfg)),
    )


def load_checkpoint(path: str) -> Tuple[Vec3, int, RenderConfig]:
    with np.load(path, allow_pickle=False) as z:
        if int(z["version"]) != _FORMAT_VERSION:
            raise ValueError(f"unsupported checkpoint version {z['version']}")
        cfg = RenderConfig(**json.loads(str(z["config"])))
        accum = Vec3(z["r"], z["g"], z["b"])
        return accum, int(z["frame"]), cfg


def resume_or_fresh(path: Optional[str], cfg: RenderConfig):
    """(accum, start_frame) — from checkpoint if compatible, else zeros.

    Compatible = the saved config's image fingerprint (every field that
    shapes the accumulated image — resolution, spp, scene, rng, env,
    roulette, ...) matches ``cfg``'s; a mismatch in any of them starts
    fresh rather than corrupting the running mean."""
    import jax.numpy as jnp

    if path:
        try:
            accum, frame, saved_cfg = load_checkpoint(path)
            if image_fingerprint(saved_cfg) == image_fingerprint(cfg):
                return (
                    Vec3(jnp.asarray(accum.x), jnp.asarray(accum.y),
                         jnp.asarray(accum.z)),
                    frame,
                )
        except FileNotFoundError:
            pass
    from cpuperformanceraytracer_tpu.render.frame import zero_accum

    return zero_accum(cfg), 0
