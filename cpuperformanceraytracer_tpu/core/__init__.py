"""Core math layer: vector types, RNG, color transforms, samplers.

The replacement for the reference's SIMD math core
(mathlib.h / mathutils.h / intrinsic_utils.h): instead of 8-wide
``__m256`` packets, code is written per-ray over a ``Vec3`` of scalars
and vectorized with ``jax.vmap`` — XLA then lays every component out as
a full SoA array over pixels, the analog of the reference's
hand-packed ``m256x3``.
"""

from cpuperformanceraytracer_tpu.core.vecmath import (  # noqa: F401
    Vec2,
    Vec3,
    vec2,
    vec3,
    dot2,
    dot3,
    cross,
    length,
    normalize,
    reflect,
    refract,
    lerp,
    lerp3,
    saturate,
    saturate3,
    fresnel_reflect_amount,
)
from cpuperformanceraytracer_tpu.core.rng import (  # noqa: F401
    wang_hash,
    rand01,
    signed_rand01,
    pixel_seed,
    counter_rand01,
    CounterRng,
    WangRng,
)
from cpuperformanceraytracer_tpu.core.color import (  # noqa: F401
    aces_film,
    linear_to_srgb,
    srgb_to_linear,
    postprocess_color,
)
from cpuperformanceraytracer_tpu.core.sampling import (  # noqa: F401
    random_unit_vector_zangle,
    random_unit_vector_normalized3,
)
