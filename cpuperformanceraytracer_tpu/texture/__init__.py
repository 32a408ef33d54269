"""Texture layer: HDR (Radiance RGBE) IO + equirect/cubemap samplers.

Replaces the reference's stb_image-based asset loading
(asset_loading.cpp, stb_image.h) with an own RGBE codec (pure numpy with
an optional C++ fast path, native/rgbe.cpp) and its gather-based SIMD
samplers (texture.cpp) with jnp gather lookups.
"""

from cpuperformanceraytracer_tpu.texture.hdr import (  # noqa: F401
    read_hdr,
    write_hdr,
)
from cpuperformanceraytracer_tpu.texture.texture import (  # noqa: F401
    Texture,
    texture_from_array,
    load_texture,
    load_cubemap_texture,
    texel_fetch,
    sample_bilinear,
    sample_nearest,
    sample_stochastic,
    equirect_uv,
    sample_equirect,
    cubemap_uv,
    sample_cubemap,
    sample_environment,
)
from cpuperformanceraytracer_tpu.texture.procedural import (  # noqa: F401
    gradient_sky,
)
