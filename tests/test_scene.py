"""Scene construction tests: presets, builder semantics, quad precompute."""

import numpy as np
import jax.numpy as jnp

from cpuperformanceraytracer_tpu.core.vecmath import dot3
from cpuperformanceraytracer_tpu.scene.builder import SceneBuilder
from cpuperformanceraytracer_tpu.scene.presets import (
    cornell_box_scene,
    glass_spheres_scene,
    scene_by_name,
)
from cpuperformanceraytracer_tpu.scene.types import Material, precompute_quads


def test_cornell_box_counts():
    scene, camera = cornell_box_scene()
    assert scene.quads.count == 6
    assert scene.spheres.count == 3
    assert scene.materials.count == 7
    assert float(camera.forward_z) == 1.0
    assert float(camera.position.z) == 0.0
    # light material emissive = 20*(1,.9,.7)
    em = scene.materials.emissive
    idx = int(np.argmax(np.asarray(em.x)))
    assert np.allclose(
        [float(em.x[idx]), float(em.y[idx]), float(em.z[idx])], [20.0, 18.0, 14.0]
    )


def test_glass_spheres_counts_and_ramp():
    scene, camera = glass_spheres_scene()
    assert scene.quads.count == 4
    assert scene.spheres.count == 7
    assert float(camera.forward_z) == -1.0
    assert float(camera.position.z) == 40.0
    # roughness ramp 0..0.5 on the sphere materials
    rough = np.asarray(scene.materials.specular_roughness)[4:]
    assert np.allclose(rough, np.linspace(0, 0.5, 7), atol=1e-6)
    # spheres translated by (0,0,10): centers z == 10
    assert np.allclose(np.asarray(scene.spheres.center.z), 10.0)
    assert np.allclose(np.asarray(scene.spheres.center.x),
                       -18.0 + 6.0 * np.arange(7))
    # striped background is NOT translated (reference quirk :1430-1436)
    assert np.isclose(float(scene.quads.v0.z[1]), 5.0)


def test_grey_albedo_bug_flag():
    fixed, _ = glass_spheres_scene(grey_albedo_bug=False)
    bug, _ = glass_spheres_scene(grey_albedo_bug=True)
    a_f = fixed.materials.albedo
    a_b = bug.materials.albedo
    # sphere albedo (0.9, 0.25, 0.25): bug copies R into G and B
    assert np.isclose(float(a_f.y[4]), 0.25)
    assert np.isclose(float(a_b.y[4]), 0.9)
    assert np.isclose(float(a_b.z[4]), 0.9)


def test_scene_by_name():
    s, c = scene_by_name("cornell_box")
    assert s.quads.count == 6
    try:
        scene_by_name("nope")
        assert False
    except ValueError:
        pass


def test_quad_precompute_barycentric_identity():
    """Dual-edge vectors must reproduce barycentric coords: for the quad
    corners, (A0,A1,A2)/(B0,B1,B2) hit 0/1 values."""
    b = SceneBuilder()
    m = b.add_material(Material(albedo=(1, 1, 1)))
    b.add_quad((0, 0, 0), (2, 0, 0), (2, 3, 0), (0, 3, 0), m)
    scene = b.build()
    d = precompute_quads(scene.quads)

    # unit normal along +/- z
    n = np.array([float(d.normal.x[0]), float(d.normal.y[0]), float(d.normal.z[0])])
    assert np.isclose(abs(n[2]), 1.0, atol=1e-6)

    # bottom tri (v0,v1,v2) barycentrics: at v1 -> (0,1,0); at v2 -> (1,0,0)
    rel_v1 = scene.quads.v1 - scene.quads.v0
    a0 = float(dot3(rel_v1, d.nxv01)[0])
    a1 = float(dot3(rel_v1, d.nxv20)[0])
    assert np.isclose(a0, 0.0, atol=1e-5) and np.isclose(a1, 1.0, atol=1e-5)
    rel_v2 = scene.quads.v2 - scene.quads.v0
    a0 = float(dot3(rel_v2, d.nxv01)[0])
    a1 = float(dot3(rel_v2, d.nxv20)[0])
    assert np.isclose(a0, 1.0, atol=1e-5) and np.isclose(a1, 0.0, atol=1e-5)

    # top tri (v0,v2,v3): at v3 -> b1 = 1; at v1 the top tri excludes it
    rel_v3 = scene.quads.v3 - scene.quads.v0
    b0 = float(dot3(rel_v3, d.nxv30)[0])
    b1 = float(dot3(rel_v3, d.nxv02)[0])
    assert np.isclose(b0, 0.0, atol=1e-5) and np.isclose(b1, 1.0, atol=1e-5)
    b0 = float(dot3(rel_v1, d.nxv30)[0])
    b1 = float(dot3(rel_v1, d.nxv02)[0])
    assert min(b0, b1, 1 - b0 - b1) < -1e-6


def test_builder_empty_scene_padding():
    s = SceneBuilder().build()
    assert s.quads.count == 1 and s.spheres.count == 1 and s.materials.count == 1


def test_with_auto_tiles():
    """Any resolution is valid with any power-of-two block: the kernel
    pads the frame to whole blocks (no per-resolution tile search)."""
    from cpuperformanceraytracer_tpu.config import RenderConfig
    from cpuperformanceraytracer_tpu.kernels.megakernel import padded_extent

    for w, h in ((640, 360), (320, 240), (100, 77)):
        c = RenderConfig(width=w, height=h, backend="pallas").validate()
        hp, wp = padded_extent(h, w, c.tile_height, c.tile_width)
        assert hp % c.tile_height == 0 and wp % c.tile_width == 0
        assert 0 <= hp - h < c.tile_height and 0 <= wp - w < c.tile_width
