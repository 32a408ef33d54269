"""Scene layer: geometry + material pytrees, builder API, scene presets.

The mirror of the reference's L1 scene representation
(demofox_path_tracing_optimization_v4.cpp:195-417, 1368-1496): quads are
stored with precomputed normals and dual-edge ("bivector") barycentric
vectors, materials in SoA arrays, everything as stacked jnp arrays so
the whole scene is one differentiable pytree that can be donated to jit
and sharded.
"""

from cpuperformanceraytracer_tpu.scene.types import (  # noqa: F401
    Material,
    Quads,
    Spheres,
    Materials,
    Scene,
    precompute_quads,
)
from cpuperformanceraytracer_tpu.scene.builder import SceneBuilder  # noqa: F401
from cpuperformanceraytracer_tpu.scene.camera import Camera, make_camera  # noqa: F401
from cpuperformanceraytracer_tpu.scene.presets import (  # noqa: F401
    cornell_box_scene,
    glass_spheres_scene,
    scene_by_name,
)
