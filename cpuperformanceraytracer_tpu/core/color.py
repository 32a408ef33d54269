"""Color transforms: ACES filmic tonemap, sRGB encode/decode, display pack.

Capability mirror of the reference's postprocess stage
(demofox_path_tracing_optimization_v4.cpp:144-193 and the
OutputToScreen/OutputToFile encode at :1260-1331), using exact math:
the reference's ``fast_pow_gamma`` (sqrt + Newton cube-root) and
``rcp``-based ACES are x86 throughput tricks; XLA fuses the
exact ops into the same elementwise pipeline, so the oracle and kernels
share one exact definition (numerical-parity policy, SURVEY.md
section 7(e)).
"""

from __future__ import annotations

import jax.numpy as jnp

from cpuperformanceraytracer_tpu.core.vecmath import Vec3, saturate, saturate3


def aces_film(v: Vec3) -> Vec3:
    """ACES filmic tonemap approximation (Narkowicz), saturated.

    Constants a=2.51 b=0.03 c=2.43 d=0.59 e=0.14 as in ACESFilm
    (demofox_path_tracing_optimization_v4.cpp:166-176).
    """
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14

    def f(x):
        return saturate((x * (a * x + b)) / (x * (c * x + d) + e))

    return Vec3(f(v.x), f(v.y), f(v.z))


def linear_to_srgb(v: Vec3) -> Vec3:
    """Linear -> sRGB with the standard 0.0031308 piecewise split.

    Matches LinearToSRGB (demofox_path_tracing_optimization_v4.cpp:178-187),
    exact pow instead of the fast-gamma Newton iteration.
    """
    v = saturate3(v)

    def f(x):
        lo = x * 12.92
        hi = 1.055 * jnp.power(jnp.maximum(x, 1e-10), 1.0 / 2.4) - 0.055
        return jnp.where(x < 0.0031308, lo, hi)

    return Vec3(f(v.x), f(v.y), f(v.z))


def srgb_to_linear(v: Vec3) -> Vec3:
    """sRGB -> linear (demofox_path_tracing_optimization_v4.cpp:189-193)."""
    v = saturate3(v)

    def f(x):
        lo = x / 12.92
        hi = jnp.power((x + 0.055) / 1.055, 2.4)
        return jnp.where(x < 0.04045, lo, hi)

    return Vec3(f(v.x), f(v.y), f(v.z))


def postprocess_color(v: Vec3, exposure: float = 1.0) -> Vec3:
    """exposure -> ACES -> sRGB, the display transform of OutputToScreen
    (demofox_path_tracing_optimization_v4.cpp:1279-1280)."""
    return linear_to_srgb(aces_film(v * exposure))


def to_u8(v: Vec3) -> jnp.ndarray:
    """Saturate, scale by 255, round-to-nearest, stacked as (..., 3) u8.

    The reference converts with _mm256_cvtps_epi32 (round-to-nearest-even)
    after saturating (demofox_path_tracing_optimization_v4.cpp:1282-1288).
    """
    s = saturate3(v) * 255.0
    rgb = jnp.stack([s.x, s.y, s.z], axis=-1)
    return jnp.round(rgb).astype(jnp.uint8)
