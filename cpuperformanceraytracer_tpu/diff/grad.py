"""Differentiable render wrappers: apply a parameter pytree to a scene,
render, and take pixel-loss gradients.

Gradient policy (SURVEY.md section 7 hard-part (d)):
  - material fields, emissive, env texels: gradients are exact
    chosen-branch path derivatives (the lottery selection is replayed
    identically because the RNG is deterministic in the parameters);
  - lottery probabilities and Russian-roulette weights are detached in
    the integrator (estimator weights, not physics);
  - geometry (sphere centers/radii, quad vertices): gradients flow
    through hit distances and normals — correct away from silhouette
    edges (visibility discontinuities are measure-zero and ignored, the
    standard differentiable-path-tracing compromise).
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from cpuperformanceraytracer_tpu.config import RenderConfig
from cpuperformanceraytracer_tpu.core.vecmath import Vec3
from cpuperformanceraytracer_tpu.render.frame import render_frame
from cpuperformanceraytracer_tpu.scene.types import Scene
from cpuperformanceraytracer_tpu.texture.texture import Texture


def apply_params(scene: Scene, texture: Optional[Texture], params: Dict):
    """Overlay a params pytree onto (scene, texture).

    Recognized keys (all optional):
      sphere_centers: (NS, 3)   sphere_radii: (NS,)
      quad_v0/v1/v2/v3: (NQ, 3)
      albedo / emissive / specular_color / refraction_color: (NM, 3)
      specular_chance/roughness, ior, refraction_chance/roughness: (NM,)
      env_rgb: (H*W, 3) flattened env-map texel planes
    """
    spheres = scene.spheres
    if "sphere_centers" in params:
        c = params["sphere_centers"]
        spheres = spheres._replace(center=Vec3(c[:, 0], c[:, 1], c[:, 2]))
    if "sphere_radii" in params:
        spheres = spheres._replace(radius=params["sphere_radii"])

    quads = scene.quads
    for key in ("v0", "v1", "v2", "v3"):
        pk = f"quad_{key}"
        if pk in params:
            v = params[pk]
            quads = quads._replace(**{key: Vec3(v[:, 0], v[:, 1], v[:, 2])})

    mats = scene.materials
    for name in ("albedo", "emissive", "specular_color", "refraction_color"):
        if name in params:
            v = params[name]
            mats = mats._replace(**{name: Vec3(v[:, 0], v[:, 1], v[:, 2])})
    for name in ("specular_chance", "specular_roughness", "ior",
                 "refraction_chance", "refraction_roughness"):
        if name in params:
            mats = mats._replace(**{name: params[name]})

    scene = scene._replace(spheres=spheres, quads=quads, materials=mats)

    if "env_rgb" in params and texture is not None:
        e = params["env_rgb"]
        texture = texture._replace(r=e[:, 0], g=e[:, 1], b=e[:, 2])
    return scene, texture


def render_for_params(params: Dict, scene: Scene, camera, texture,
                      cfg: RenderConfig, frame=0) -> Vec3:
    """Differentiable render: always the XLA integrator (cfg.backend
    picks only the forward renderer). Its adjoint is plain jax.grad;
    the env-texel gradient is the transpose of the env gather, a
    scatter-add."""
    scene, texture = apply_params(scene, texture, params)
    return render_frame(scene, camera, texture, cfg, frame)


def image_loss(a: Vec3, b: Vec3) -> jnp.ndarray:
    """Mean squared error over all pixels/channels."""
    return (
        jnp.mean((a.x - b.x) ** 2)
        + jnp.mean((a.y - b.y) ** 2)
        + jnp.mean((a.z - b.z) ** 2)
    ) / 3.0


def loss_and_grad(params: Dict, target: Vec3, scene: Scene, camera, texture,
                  cfg: RenderConfig, frame=0):
    """(loss, grads) for the L2 pixel loss at the given params."""

    def f(p):
        img = render_for_params(p, scene, camera, texture, cfg, frame)
        return image_loss(img, target)

    return jax.value_and_grad(f)(params)
