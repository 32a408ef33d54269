"""Scalar-per-ray vector math, written to vectorize via ``jax.vmap``.

Design: a ``Vec3`` is a NamedTuple of three scalars. Integrator code is
written against single rays; ``jax.vmap`` over pixels turns every
component into one flat SoA array (contiguous per component),
structurally equivalent to the
reference's ``m256x3`` struct-of-``__m256`` design (mathlib.h:85-90)
without any hand-packing.

Capability parity notes (reference file:line):
  - ``reflect``/``refract`` follow GLSL semantics; ``refract`` returns the
    zero vector on total internal reflection (mathlib.h:781-789 ``rfrct``).
  - ``fresnel_reflect_amount`` is the Schlick approximation with the
    n1>n2 total-internal-reflection branch
    (demofox_path_tracing_optimization_v4.cpp:429-453).
  - All select-style control flow is ``jnp.where`` — the analog of the
    reference's ``blend_ps`` universal masking primitive (mathlib.h:526-558).
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax.numpy as jnp

Scalar = jnp.ndarray  # a traced f32 scalar (or any broadcastable array)
ScalarLike = Union[jnp.ndarray, float, int]


class Vec2(NamedTuple):
    x: Scalar
    y: Scalar

    def __add__(self, o):
        if isinstance(o, Vec2):
            return Vec2(self.x + o.x, self.y + o.y)
        return Vec2(self.x + o, self.y + o)

    def __sub__(self, o):
        if isinstance(o, Vec2):
            return Vec2(self.x - o.x, self.y - o.y)
        return Vec2(self.x - o, self.y - o)

    def __mul__(self, o):
        if isinstance(o, Vec2):
            return Vec2(self.x * o.x, self.y * o.y)
        return Vec2(self.x * o, self.y * o)

    __radd__ = __add__
    __rmul__ = __mul__


class Vec3(NamedTuple):
    x: Scalar
    y: Scalar
    z: Scalar

    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    __radd__ = __add__
    __rmul__ = __mul__

    def max_component(self) -> Scalar:
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def to_array(self) -> jnp.ndarray:
        """Stack into a (..., 3) array (host-side/debug use)."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)


def vec2(x: ScalarLike, y: ScalarLike) -> Vec2:
    f = jnp.float32
    return Vec2(jnp.asarray(x, f), jnp.asarray(y, f))


def vec3(x: ScalarLike, y: ScalarLike = None, z: ScalarLike = None) -> Vec3:
    f = jnp.float32
    if y is None:
        y = z = x
    return Vec3(jnp.asarray(x, f), jnp.asarray(y, f), jnp.asarray(z, f))


def from_array(a: jnp.ndarray) -> Vec3:
    """Unstack a (..., 3) array into a Vec3 SoA triple."""
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def dot2(u: Vec2, v: Vec2) -> Scalar:
    return u.x * v.x + u.y * v.y


def dot3(u: Vec3, v: Vec3) -> Scalar:
    return u.x * v.x + u.y * v.y + u.z * v.z


def cross(u: Vec3, v: Vec3) -> Vec3:
    return Vec3(
        u.y * v.z - u.z * v.y,
        u.z * v.x - u.x * v.z,
        u.x * v.y - u.y * v.x,
    )


def length(v: Vec3) -> Scalar:
    return jnp.sqrt(dot3(v, v))


def normalize(v: Vec3) -> Vec3:
    """Exact-division normalize.

    The reference deliberately uses full-precision divide rather than
    rsqrt for normals (mathlib.h:747-752: "rsroot ... is not accurate
    enough to avoid artifacts"); we match that policy.
    """
    return v * (1.0 / jnp.sqrt(dot3(v, v)))


def lerp(u: ScalarLike, v: ScalarLike, t: ScalarLike) -> Scalar:
    return u + t * (v - u)


def lerp3(u: Vec3, v: Vec3, t: ScalarLike) -> Vec3:
    return u + (v - u) * t


def saturate(x: ScalarLike) -> Scalar:
    return jnp.clip(x, 0.0, 1.0)


def saturate3(v: Vec3) -> Vec3:
    return Vec3(saturate(v.x), saturate(v.y), saturate(v.z))


def reflect(v: Vec3, n: Vec3) -> Vec3:
    """GLSL reflect: v - 2*dot(v,n)*n (for incident v, unit normal n)."""
    return v - n * (2.0 * dot3(v, n))


def refract(v: Vec3, n: Vec3, eta: Scalar) -> Vec3:
    """GLSL refract; returns the zero vector on total internal reflection.

    Mirrors the semantics of the reference's ``rfrct`` (mathlib.h:781-789):
      k = 1 - eta^2 (1 - dot(v,n)^2)
      out = eta*v - (eta*dot(v,n) + sqrt(k)) * n,   or 0 if k < 0.
    The sqrt argument is clamped so the inactive branch under ``where``
    never produces a NaN that would poison reverse-mode gradients.
    """
    vdotn = dot3(v, n)
    k = 1.0 - eta * eta * (1.0 - vdotn * vdotn)
    # double-where sqrt guard: sqrt'(0) = inf would turn the TIR branch's
    # zero cotangent into 0 * inf = NaN in reverse mode, so the inactive
    # branch gets a safe operand (1.0), not just a clamped one
    k_safe = jnp.where(k > 0.0, k, 1.0)
    sqrt_k = jnp.where(k > 0.0, jnp.sqrt(k_safe), 0.0)
    out = v * eta - n * (eta * vdotn + sqrt_k)
    zero = jnp.zeros_like(k)
    return Vec3(
        jnp.where(k < 0.0, zero, out.x),
        jnp.where(k < 0.0, zero, out.y),
        jnp.where(k < 0.0, zero, out.z),
    )


def fresnel_reflect_amount(
    n1: Scalar, n2: Scalar, normal: Vec3, incident: Vec3, f0: Scalar, f90: Scalar
) -> Scalar:
    """Schlick Fresnel with the dense-to-rare TIR branch.

    Re-derivation of FresnelReflectAmount
    (demofox_path_tracing_optimization_v4.cpp:429-453): when n1 > n2 the
    cosine is replaced by the transmitted-angle cosine, and total internal
    reflection returns 1. Uses exact division (the reference's ``rcp``
    fast paths are x86 approximations we deliberately do not replicate —
    the oracle defines truth with exact ops; see SURVEY.md section 7(e)).
    """
    r0 = (n1 - n2) / (n1 + n2)
    r0 = r0 * r0
    cos_x = -dot3(normal, incident)
    n1_gt_n2 = n1 > n2

    n = n1 / n2
    sin_t2_compl = 1.0 - (n * n) * (1.0 - cos_x * cos_x)
    # double-where sqrt guard (see refract): keep the TIR branch's
    # gradient path exactly zero instead of 0 * inf = NaN. The boundary
    # value sin_t2_compl == 0 (exact grazing incidence) must land on the
    # TIR side (<=, not <): both branches agree there in value (Fresnel
    # = 1) but sqrt'(0) = inf, so routing it through sqrt reintroduces
    # the inf gradient this guard exists to remove.
    tir = sin_t2_compl <= 0.0
    sin_safe = jnp.where(tir, 1.0, sin_t2_compl)
    new_cos_x = jnp.where(tir, 0.0, jnp.sqrt(sin_safe))
    cos_x = jnp.where(n1_gt_n2 & ~tir, new_cos_x, cos_x)

    x = 1.0 - cos_x
    ret = r0 + (1.0 - r0) * x * x * x * x * x
    ret = jnp.where(n1_gt_n2 & tir, 1.0, ret)
    return f0 + (f90 - f0) * ret
