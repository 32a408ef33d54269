"""Gradient-path tests: jax.grad through the XLA integrator.

Training always renders with the integrator (cfg.backend picks only the
forward renderer), so these check the adjoint itself: finite
differences on parameters that enter the estimator smoothly, path
replay (remat) against stored residuals for the geometry and camera
families, the env-texel scatter-add against numpy, and the sharded
training step against the unsharded one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cpuperformanceraytracer_tpu.config import RenderConfig
from cpuperformanceraytracer_tpu.diff.grad import image_loss, render_for_params
from cpuperformanceraytracer_tpu.scene.builder import SceneBuilder
from cpuperformanceraytracer_tpu.scene.camera import make_camera
from cpuperformanceraytracer_tpu.scene.presets import glass_spheres_scene
from cpuperformanceraytracer_tpu.scene.types import Material
from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu.texture.texture import texture_from_array


def _cfg(**kw):
    base = dict(width=128, height=16, spp=1, bounces=2,
                scene="diffuse_sky", env_mode="equirect",
                env_sampling="stochastic", env_flip_xz=True,
                jitter=True, roulette="off", rng="counter")
    base.update(kw)
    return RenderConfig(**base)


def _diffuse_sky_scene():
    """Open diffuse scene: floor + two matte spheres under the sky —
    most paths escape to the env map, so env-texel gradients are dense
    and every decision (no lottery, no roulette) is stable."""
    b = SceneBuilder(translation=(0.0, 0.0, 10.0))
    grey = b.add_material(Material(albedo=(0.6, 0.55, 0.5)))
    rust = b.add_material(Material(albedo=(0.7, 0.3, 0.2)))
    blue = b.add_material(Material(albedo=(0.2, 0.3, 0.7)))
    b.add_quad((-25.0, -12.45, 15.0), (25.0, -12.45, 15.0),
               (25.0, -12.45, -15.0), (-25.0, -12.45, -15.0), grey)
    b.add_sphere((-6.0, -9.5, 0.0), 3.0, rust)
    b.add_sphere((6.0, -9.5, 0.0), 3.0, blue)
    cam = make_camera(position=(0.0, 0.0, 40.0), fov_degrees=90.0,
                      forward_z=-1.0)
    return b.build(), cam


def _params(scene, tex=None):
    albedo = jnp.stack([scene.materials.albedo.x, scene.materials.albedo.y,
                        scene.materials.albedo.z], -1)
    centers = jnp.stack([scene.spheres.center.x, scene.spheres.center.y,
                         scene.spheres.center.z], -1)
    p = {"albedo": albedo, "sphere_centers": centers}
    if tex is not None:
        p["env_rgb"] = jnp.stack([tex.r, tex.g, tex.b], -1)
    return p


def _grads(cfg, scene, cam, tex, params, target):
    def loss(p):
        img = render_for_params(p, scene, cam, tex, cfg, frame=1)
        return image_loss(img, target)

    return jax.value_and_grad(loss)(params)


class TestSegmentSum:
    """The env-texel gradient is the transpose of the env gather: a
    scatter-add of the pixel cotangents into the texel planes (atomics
    on the GPU, so summation order varies: tolerance 1e-5 relative)."""

    @pytest.mark.parametrize("n_idx,n_tex", [(4096, 50), (7, 4)])
    def test_gather_transpose_matches_add_at(self, n_idx, n_tex):
        from cpuperformanceraytracer_tpu.texture.texture import (
            Texture,
            _gather,
        )

        rng = np.random.RandomState(n_idx)
        # duplicate indices on purpose (n_idx > n_tex)
        idx = rng.randint(0, n_tex, size=n_idx).astype(np.int32)
        cot = rng.randn(3, n_idx).astype(np.float32)
        planes = [jnp.asarray(rng.rand(n_tex), jnp.float32)
                  for _ in range(3)]

        def f(r, g, b):
            out = _gather(Texture(r, g, b, n_tex, 1), jnp.asarray(idx))
            return (out.x * cot[0]).sum() + (out.y * cot[1]).sum() + (
                out.z * cot[2]).sum()

        grads = jax.grad(f, argnums=(0, 1, 2))(*planes)
        for c in range(3):
            want = np.zeros(n_tex, np.float64)
            np.add.at(want, idx, cot[c].astype(np.float64))
            np.testing.assert_allclose(np.asarray(grads[c]), want,
                                       rtol=1e-5, atol=1e-5)

    def test_env_texel_grad_through_render(self):
        """Through the whole render: every texel's gradient equals the
        scatter-add (np.add.at) of d loss / d env over the pixels whose
        deferred miss lookup landed on it."""
        from cpuperformanceraytracer_tpu.diff.grad import apply_params

        scene, cam = _diffuse_sky_scene()
        tex = texture_from_array(gradient_sky(8, 4))  # many hits per texel
        cfg = _cfg(width=32, height=8)
        env = jnp.stack([tex.r, tex.g, tex.b], -1)
        target = render_for_params({}, scene, cam, tex, cfg, 0)

        def loss(e):
            return image_loss(render_for_params({"env_rgb": e}, scene, cam,
                                                tex, cfg, 1), target)

        g = np.asarray(jax.grad(loss)(env * 1.1))
        assert np.isfinite(g).all()
        assert (np.abs(g).sum(axis=1) > 0).sum() > 1  # several texels hit
        # linear in env: loss(e) = |A e - t|^2 / n, so grad at 1.1*e0
        # equals the FD along any direction exactly up to rounding
        d = np.random.RandomState(0).randn(*env.shape).astype(np.float32)
        eps = 1e-2
        fd = (float(loss(env * 1.1 + eps * d))
              - float(loss(env * 1.1 - eps * d))) / (2 * eps)
        assert abs(fd - float((g * d).sum())) <= 1e-3 * max(abs(fd), 1e-3)


class TestPallasGradParity:
    def test_finite_difference_albedo_and_env(self):
        """Absolute correctness spot-check: central finite differences on
        a material albedo channel and one env texel (both enter the
        estimator smoothly — no decision boundaries)."""
        scene, cam = _diffuse_sky_scene()
        tex = texture_from_array(gradient_sky(32, 16))
        cfg = _cfg()
        params = _params(scene, tex)
        target = render_for_params(
            {}, scene, cam, tex, cfg, 0)

        def loss(p):
            img = render_for_params(p, scene, cam, tex, cfg, frame=1)
            return image_loss(img, target)

        _, grads = jax.value_and_grad(loss)(params)

        eps = 1e-2
        for key, index in (("albedo", (1, 0)), ("env_rgb", (100, 1))):
            up = {**params, key: params[key].at[index].add(eps)}
            dn = {**params, key: params[key].at[index].add(-eps)}
            fd = (float(loss(up)) - float(loss(dn))) / (2 * eps)
            an = float(grads[key][index])
            assert abs(fd - an) < 2e-3 + 0.05 * abs(fd), (key, fd, an)

    def test_sharded_diff_grads_match_unsharded(self, devices8):
        """The multi-card training path: px-row + spp sharded forward
        under jax.grad; parameter grads all-reduce through the shard_map
        transpose and must equal the unsharded gradients."""
        from jax.sharding import Mesh

        from cpuperformanceraytracer_tpu.parallel.shard import (
            sharded_render_frame,
        )

        scene, cam = _diffuse_sky_scene()
        tex = texture_from_array(gradient_sky(32, 16))
        cfg = _cfg(height=64, spp=2)
        mesh = Mesh(np.asarray(devices8).reshape(4, 2), ("px", "spp"))
        params = _params(scene, tex)
        target = render_for_params(
            {}, scene, cam, tex, cfg, 0)

        from cpuperformanceraytracer_tpu.diff.grad import apply_params

        def loss_sharded(p):
            s, t = apply_params(scene, tex, p)
            img = sharded_render_frame(s, cam, t, cfg, 1, mesh)
            return image_loss(img, target)

        lu, gu = _grads(cfg, scene, cam, tex, params, target)  # unsharded
        ls, gs = jax.value_and_grad(loss_sharded)(params)

        np.testing.assert_allclose(float(ls), float(lu), rtol=1e-5)
        for key in params:
            a, b = np.asarray(gu[key]), np.asarray(gs[key])
            scale = max(np.abs(a).max(), 1e-6)
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=key)

    def test_quad_and_radius_grads_match_oracle(self):
        """The less-common trained families (quad vertices, sphere
        radii): the path-replay backward (remat_bounces, segments
        recomputed in the backward sweep) must reproduce the
        stored-residual gradients, finite. Glass scene:
        radii and vertices enter smoothly through hit distances, Beer
        absorption, and Fresnel."""
        scene, cam = glass_spheres_scene()
        tex = texture_from_array(gradient_sky(32, 16))
        cfg = _cfg(scene="glass_spheres", bounces=4, roulette="v4_quirk")
        v0 = jnp.stack([scene.quads.v0.x, scene.quads.v0.y,
                        scene.quads.v0.z], -1)
        params = {"quad_v0": v0, "sphere_radii": scene.spheres.radius}
        target = render_for_params(
            {}, scene, cam, tex, cfg, 0)

        lx, gx = _grads(cfg, scene, cam, tex, params, target)
        lp, gp = _grads(cfg.replace(remat_bounces=True), scene, cam, tex,
                        params, target)

        np.testing.assert_allclose(float(lp), float(lx), rtol=1e-5)
        # radii reach the loss through Beer absorption on refracted
        # paths, which need ~4 bounces to reach the sky
        assert np.abs(np.asarray(gx["sphere_radii"])).sum() > 0
        for key in params:
            a, b = np.asarray(gx[key]), np.asarray(gp[key])
            assert np.isfinite(b).all(), key
            scale = max(np.abs(a).max(), 1e-6)
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-5 * scale,
                                       err_msg=key)

    def test_camera_grads_match_oracle(self):
        """Camera gradients (position, distance) through the path-replay
        backward equal the stored-residual ones. Glass scene at
        FULL bounce depth: the only smooth camera dependence under the
        estimator's detachment policy (stochastic env taps and lottery
        weights are detached) is Beer absorption's path-length term, and
        refracted paths only reach the sky — and hence contribute — from
        ~4 bounces up (at bounces=2 the camera gradient is genuinely
        zero a.e., verified while writing this test)."""
        from cpuperformanceraytracer_tpu.core.vecmath import Vec3

        scene, cam = glass_spheres_scene()
        tex = texture_from_array(gradient_sky(32, 16))
        cfg = _cfg(scene="glass_spheres", bounces=8, roulette="v4_quirk")
        target = render_for_params(
            {}, scene, cam, tex, cfg, 0)

        def loss_for(cvec, c):
            cam2 = cam._replace(
                position=Vec3(cvec[0], cvec[1], cvec[2]),
                distance=cvec[3])
            img = render_for_params({}, scene, cam2, tex, c, 1)
            return image_loss(img, target)

        c0 = jnp.array([cam.position.x, cam.position.y, cam.position.z,
                        cam.distance], jnp.float32)
        gx = jax.grad(loss_for)(c0, cfg)
        gp = jax.grad(loss_for)(c0, cfg.replace(remat_bounces=True))
        a, b = np.asarray(gx), np.asarray(gp)
        assert np.isfinite(b).all()
        assert np.abs(a).sum() > 1e-6  # the scene makes them nonzero
        np.testing.assert_allclose(b, a, rtol=1e-4,
                                   atol=1e-5 * np.abs(a).max())


class TestBenchGradProtocol:
    def test_fwd_bwd_benchmark_tiny(self):
        """The driver-metric protocol (diff/benchgrad.py, used by
        bench.py and `cli bench-grad`) runs end-to-end at toy scale:
        finite grads over the full param surface, sane timing fields."""
        from cpuperformanceraytracer_tpu.diff.benchgrad import (
            fwd_bwd_benchmark,
        )

        scene, cam = _diffuse_sky_scene()
        tex = texture_from_array(gradient_sky(16, 8))
        cfg = _cfg(bounces=1)
        r = fwd_bwd_benchmark(cfg, scene, cam, tex, steps=2,
                              steps_per_dispatch=2, spans=1)
        assert r["grads_finite"]
        assert r["ms_per_step"] > 0 and r["Mrays_per_s"] > 0
        assert r["steps_per_dispatch"] == 2
        assert r["param_leaves"] == ["albedo", "env_rgb",
                                     "sphere_centers"]
        assert len(r["span_ms"]) == 1 and r["spread"] == 0.0
        assert r["temp_bytes"] > 0 and r["compile_s"] > 0
