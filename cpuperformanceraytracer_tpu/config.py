"""Render configuration: every knob of global_preprocessor_flags.h as a
validated dataclass instead of compile-time macros.

Knob mapping (reference -> here):
  RENDER_BUFFER_PIXEL_WIDTH/HEIGHT (:39-40)  -> width/height
  NUM_SAMPLES_PER_FRAME (:30)                -> spp
  NUM_FRAMES_TO_RENDER (:31)                 -> num_frames
  c_numBounces (v4 :23)                      -> bounces
  USE_ENV_MAP / USE_ENV_CUBEMAP (:56-57)     -> env_mode
  USE_RANDOM_JITTER_TEXTURE_SAMPLING (:67)   -> env_sampling
  USE_UNIT_VECTOR_REJECTION_SAMPLING (:66)   -> unit_vector_sampler
  ACCUMULATE_FRAMES (:60)                    -> accumulate
  NUM_TILES_X/Y (:85-86)                     -> tile_width/tile_height (Pallas grid)
  NUM_THREADS (:69)                          -> (gone: XLA SPMD; see parallel/)
  fast-math toggles (:62-65)                 -> (gone: exact ops; parity policy)

Validation mirrors CheckValidSettings (Application.cpp:36-94). Unlike
the reference's tile rule, any resolution works: the Pallas kernel pads
the frame to whole power-of-two blocks and crops the result.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class RenderConfig:
    width: int = 1280
    height: int = 720
    spp: int = 1
    bounces: int = 8            # c_numBounces: loop runs bounces+1 segments
    num_frames: int = 600
    warmup_frames: int = 2      # offline benchmark protocol, Application.cpp:420-423

    scene: str = "glass_spheres"

    # environment lighting: "none" (constant ambient), "equirect", "cubemap"
    env_mode: str = "equirect"
    # env texel lookup: "bilinear", "nearest", "stochastic" (jittered 1-tap,
    # the reference default — TexelSampleRandom, texture.cpp:78-86)
    env_sampling: str = "stochastic"
    # miss radiance when env_mode == "none" (v4 uses (.11,.1,.15) :905;
    # the scalar scene uses (.1,.1,.1), demofox_path_tracing_scalar.cpp:307)
    ambient: tuple = (0.11, 0.10, 0.15)
    # v4 flips x/z before equirect lookup (:758-759)
    env_flip_xz: bool = True

    # "normalized3" (default build) or "zangle" (exact uniform)
    unit_vector_sampler: str = "normalized3"
    # sub-pixel jitter (v4 mainImage :1109; scalar renderer has none)
    jitter: bool = True
    # "wang" sequential-state parity RNG or "counter" (threefry) for
    # sharded spp / path replay
    rng: str = "wang"

    # Russian roulette: "off", "terminate" (correct, scalar v3 semantics),
    # or "v4_quirk" (survivor boost without termination — the reference
    # v4's exact behavior, demofox_path_tracing_optimization_v4.cpp:890-900)
    roulette: str = "v4_quirk"

    accumulate: bool = True
    exposure: float = 1.0

    # kernel backend: "xla" (fused jnp/vmap path) or "pallas" (the fused
    # Pallas kernel, compiled through Triton)
    backend: str = "xla"
    # unroll the bounce loop in the traced graph (larger compile, lets
    # XLA specialize per bounce); default rolled via lax.fori_loop
    unroll_bounces: bool = False
    # rematerialize each bounce in reverse-mode AD (path-replay backward:
    # O(1) stored state per segment, segments recomputed during the
    # backward sweep; pair with rng="counter" for guaranteed replay)
    remat_bounces: bool = False
    # Pallas pixel-block shape (powers of two; the frame is padded to
    # whole blocks and cropped). (8, 32) was the fastest of a 15-point
    # sweep on an H100 in both the headline and simd_tiled_720 (PERF.md)
    tile_height: int = 8
    tile_width: int = 32
    # end a Pallas block's bounce loop once every pixel in it is dead —
    # the block-level analog of the reference's all_set(shouldBreak)
    # early-out (v4 :731,781). Identical output.
    early_exit: bool = True
    # progressive frames rolled into ONE device dispatch (0 = auto, see
    # render/driver.py): the offline driver fuses K frames per dispatch
    # via lax.fori_loop
    frames_per_dispatch: int = 0
    # bake the (static) scene and camera into the Pallas kernel as
    # compile-time constants: material fetch collapses to distinct-value
    # select chains and unused shading paths (refraction, Beer
    # absorption, ...) drop out entirely — the analog of the reference's
    # compile-time scene (InitializeScene data is static in the binary).
    bake_scene: bool = True

    def validate(self) -> "RenderConfig":
        """Raise ValueError on invalid combinations (CheckValidSettings
        analog — but errors, not __debugbreak())."""
        errs = []
        if self.width <= 0 or self.height <= 0:
            errs.append(f"resolution {self.width}x{self.height} must be positive")
        for name in ("tile_height", "tile_width"):
            t = getattr(self, name)
            if t < 1 or t & (t - 1):
                errs.append(f"{name} {t} must be a power of two")
        if self.spp < 1:
            errs.append("spp must be >= 1")
        if self.bounces < 0:
            errs.append("bounces must be >= 0")
        if self.env_mode not in ("none", "equirect", "cubemap"):
            errs.append(f"env_mode {self.env_mode!r} invalid")
        if self.env_sampling not in ("bilinear", "nearest", "stochastic"):
            errs.append(f"env_sampling {self.env_sampling!r} invalid")
        if self.unit_vector_sampler not in ("normalized3", "zangle"):
            errs.append(f"unit_vector_sampler {self.unit_vector_sampler!r} invalid")
        if self.rng not in ("wang", "counter"):
            errs.append(f"rng {self.rng!r} invalid")
        if self.roulette not in ("off", "terminate", "v4_quirk"):
            errs.append(f"roulette {self.roulette!r} invalid")
        if self.backend not in ("xla", "pallas"):
            errs.append(f"backend {self.backend!r} invalid")
        if errs:
            raise ValueError("invalid RenderConfig: " + "; ".join(errs))
        return self

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# The five BASELINE.json benchmark configs as named presets. The
# rendering ones run the Pallas kernel backend at its default blocks.
BENCH_CONFIGS = {
    # 1. demofox scalar scene: 320x240, 1 spp, 2 bounces, no env map
    "scalar_320": RenderConfig(
        width=320, height=240, spp=1, bounces=2, scene="cornell_box",
        env_mode="none", ambient=(0.1, 0.1, 0.1), env_flip_xz=False,
        jitter=True, roulette="off", num_frames=512,
        backend="pallas",
    ),
    # 2. simd_tiled scene: 1280x720, 8 bounces, 4 spp
    "simd_tiled_720": RenderConfig(
        width=1280, height=720, spp=4, bounces=8, scene="glass_spheres",
        env_mode="none", num_frames=64, backend="pallas",
    ),
    # 3. simt_textured scene: 1920x1080 + env map, 16 spp (counter RNG:
    # one kernel + one miss-gather per sample in one jitted frame step;
    # see render_frame_pallas)
    "textured_1080": RenderConfig(
        width=1920, height=1080, spp=16, bounces=8, scene="glass_spheres",
        env_mode="equirect", num_frames=16, backend="pallas", rng="counter",
    ),
    # 4. differentiable inverse render (driver in diff/inverse.py)
    "inverse_render": RenderConfig(
        width=160, height=120, spp=4, bounces=3, scene="glass_spheres",
        env_mode="none", rng="counter", num_frames=1,
    ),
    # 5. offline high-spp: 3840x2160, 1024 samples/pixel accumulated
    # PROGRESSIVELY (1 spp per frame over 1024 frames — the reference's
    # progressive protocol, Application.cpp:420-452 + ACCUMULATE_FRAMES,
    # which also gives checkpoint/resume boundaries every K frames);
    # sharded over the mesh when one is supplied
    "offline_4k": RenderConfig(
        width=3840, height=2160, spp=1, bounces=8, scene="glass_spheres",
        env_mode="equirect", rng="counter", num_frames=1024,
        backend="pallas",
    ),
    # reference default workload (global_preprocessor_flags.h:30-40)
    "reference_default": RenderConfig(backend="pallas"),
}
