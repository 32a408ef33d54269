"""Scene pytrees: quads, spheres, SoA materials.

Differentiability-first design: the scene stores *primal* parameters
(quad vertices, sphere centers/radii, material fields); the quad
precompute (normals + dual-edge barycentric vectors, the re-derivation of
PrecomputeQuadData, demofox_path_tracing_optimization_v4.cpp:269-319) is
a pure jax function evaluated inside the traced render, so gradients flow
from pixels back to vertices. At <=12 objects the precompute is noise
next to the bounce loop.

Everything is stacked: a field of N objects is one (N,) array per scalar
component (Vec3 of (N,) arrays for points). Per-ray code broadcasts a
scalar ray against the (N,) object axis and min-reduces — the
replacement for the reference's unrolled per-object loop with masked
blends (TestSceneTrace, :699-718).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax.numpy as jnp

from cpuperformanceraytracer_tpu.core.vecmath import Vec3, cross, dot3, normalize


@dataclass(frozen=True)
class Material:
    """Host-side material description (mirror of SceneMaterial,
    demofox_path_tracing_optimization_v4.cpp:351-362)."""

    albedo: tuple = (0.0, 0.0, 0.0)
    emissive: tuple = (0.0, 0.0, 0.0)
    specular_chance: float = 0.0
    specular_roughness: float = 0.0
    specular_color: tuple = (0.0, 0.0, 0.0)
    ior: float = 1.0
    refraction_chance: float = 0.0
    refraction_roughness: float = 0.0
    refraction_color: tuple = (0.0, 0.0, 0.0)


class Materials(NamedTuple):
    """SoA material table: 17 (NM,) arrays, one per scalar field.

    Mirror of SceneMaterialSOA (:330-349). The per-ray fetch is a one-hot
    contraction over this table rather than a gather — for NM <= 12 a
    broadcast-compare-select fuses into the surrounding elementwise code
    (SURVEY.md section 7 step 4).
    """

    albedo: Vec3
    emissive: Vec3
    specular_chance: jnp.ndarray
    specular_roughness: jnp.ndarray
    specular_color: Vec3
    ior: jnp.ndarray
    refraction_chance: jnp.ndarray
    refraction_roughness: jnp.ndarray
    refraction_color: Vec3

    @property
    def count(self) -> int:
        return self.ior.shape[-1]


class Quads(NamedTuple):
    """Quad geometry: four Vec3-of-(NQ,) vertex arrays + material ids.

    Vertex convention (PrecomputeQuadData comment, :269-285):

            e32
        3---------2
        |       / |
        |  T  /   |
        |   /  B  |
        | /       |
        0---------1
            e01
    """

    v0: Vec3
    v1: Vec3
    v2: Vec3
    v3: Vec3
    material: jnp.ndarray  # (NQ,) int32

    @property
    def count(self) -> int:
        return self.material.shape[-1]


class QuadsDerived(NamedTuple):
    """Precomputed per-quad data: unit normal + six scaled dual edges."""

    normal: Vec3
    nxv01: Vec3
    nxv12: Vec3
    nxv20: Vec3
    nxv02: Vec3
    nxv23: Vec3
    nxv30: Vec3


class Spheres(NamedTuple):
    """Sphere geometry: center Vec3-of-(NS,), radius (NS,), material ids."""

    center: Vec3
    radius: jnp.ndarray
    material: jnp.ndarray  # (NS,) int32

    @property
    def count(self) -> int:
        return self.radius.shape[-1]


class Scene(NamedTuple):
    """Full scene pytree (mirror of Scene, :364-377).

    Unlike the reference's fixed MAX_OBJECTS arrays with live counts,
    arrays are sized exactly; static shapes make XLA unroll the object
    loops fully.
    """

    quads: Quads
    spheres: Spheres
    materials: Materials


def precompute_quads(q: Quads) -> QuadsDerived:
    """Normals and determinant-scaled dual-edge vectors for both triangles.

    Re-derivation of PrecomputeQuadData (:269-319): for each triangle of
    the quad, barycentric coordinates of a point P (relative to v0) are
    dots with cross(N, edge)/det vectors; the ray-plane hit point is then
    classified with six dots and no division beyond the plane hit.
    """
    v01 = q.v1 - q.v0
    v02 = q.v2 - q.v0
    v30 = q.v0 - q.v3
    v20 = -v02
    v23 = q.v3 - q.v2
    v12 = q.v2 - q.v1

    v01xv02 = cross(v01, v02)
    v30xv01 = cross(v30, v01)
    n = normalize(v01xv02)

    det_top = dot3(v30xv01, n)
    det_bot = dot3(v01xv02, n)

    inv_bot = 1.0 / det_bot
    inv_top = 1.0 / det_top

    return QuadsDerived(
        normal=n,
        nxv01=cross(n, v01) * inv_bot,
        nxv12=cross(n, v12) * inv_bot,
        nxv20=cross(n, v20) * inv_bot,
        nxv02=cross(n, v02) * inv_top,
        nxv23=cross(n, v23) * inv_top,
        nxv30=cross(n, v30) * inv_top,
    )
