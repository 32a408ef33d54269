"""Unit-vector samplers for cosine-weighted bounce direction generation.

The reference ships two samplers behind USE_UNIT_VECTOR_REJECTION_SAMPLING
(global_preprocessor_flags.h:66); both are reproduced here with identical
draw counts so RNG streams stay aligned between oracle and kernels:

- ``random_unit_vector_zangle``: z = 2u-1, angle a = 2*pi*v,
  r = sqrt(1-z^2), (r cos a, r sin a, z). Two draws.
  (mathutils.h:33-47 RandomUnitVector_ps.)
- ``random_unit_vector_normalized3``: three uniforms in [-1,1)^3
  normalized by 1/sqrt — the reference's "modified method 12" which,
  despite its name, never rejects; it is a cheap non-uniform sphere
  approximation the default build uses. Three draws.
  (demofox_path_tracing_optimization_v4.cpp:96-129
  RandomUnitVectorRejectionSample_ps.)

Both take and return a functional rng (anything with ``next01``).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from cpuperformanceraytracer_tpu.core.vecmath import Vec3

_TWO_PI = 6.28318530718  # 2 * c_pi, mathutils.h:5-6


def random_unit_vector_zangle(rng):
    """Exact uniform sphere point via z/angle; 2 draws."""
    wide_z, rng = rng.next01()
    wide_a, rng = rng.next01()
    z = wide_z * 2.0 - 1.0
    a = wide_a * _TWO_PI
    r = jnp.sqrt(jnp.maximum(1.0 - z * z, 0.0))
    return Vec3(r * jnp.cos(a), r * jnp.sin(a), z), rng


def random_unit_vector_normalized3(rng):
    """Normalized-3-uniform sphere approximation; 3 draws.

    Matches the default fast path: u,v,w ~ U[-1,1), result =
    (u,v,w)/|(u,v,w)| (demofox_path_tracing_optimization_v4.cpp:109-129).
    ``lax.rsqrt`` is used (the reference's ``rsroot`` is an x86
    approximation; rsqrt is what XLA makes of 1/sqrt on every backend).
    """
    u, rng = rng.next01()
    v, rng = rng.next01()
    w, rng = rng.next01()
    u = 2.0 * u - 1.0
    v = 2.0 * v - 1.0
    w = 2.0 * w - 1.0
    d2 = u * u + v * v + w * w
    inv = lax.rsqrt(jnp.maximum(d2, 1e-20))
    return Vec3(u * inv, v * inv, w * inv), rng
