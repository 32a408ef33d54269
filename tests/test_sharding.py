"""Sharding tests on the 8-virtual-device CPU mesh: sharded == unsharded,
spp psum correctness, validation errors, graft-entry dry run."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cpuperformanceraytracer_tpu.config import RenderConfig
from cpuperformanceraytracer_tpu.parallel.mesh import default_mesh, make_mesh
from cpuperformanceraytracer_tpu.parallel.shard import (
    make_sharded_frame_fn,
    sharded_render_frame,
)
from cpuperformanceraytracer_tpu.render.frame import render_frame, zero_accum
from cpuperformanceraytracer_tpu.scene.presets import cornell_box_scene
from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu.texture.texture import texture_from_array


def _cfg(**kw):
    base = dict(width=32, height=24, spp=4, bounces=2, scene="cornell_box",
                env_mode="none", ambient=(0.1, 0.1, 0.1), env_flip_xz=False,
                jitter=True, roulette="off", rng="counter")
    base.update(kw)
    return RenderConfig(**base)


def test_px_only_sharding_matches(devices8):
    mesh = make_mesh((8, 1), ("px", "spp"))
    scene, cam = cornell_box_scene()
    cfg = _cfg()
    ref = render_frame(scene, cam, None, cfg, 0)
    sh = sharded_render_frame(scene, cam, None, cfg, 0, mesh)
    np.testing.assert_allclose(np.asarray(sh.x), np.asarray(ref.x), atol=1e-5)


def test_px_spp_sharding_matches(devices8):
    mesh = default_mesh(spp_shards=2)
    scene, cam = cornell_box_scene()
    cfg = _cfg()
    ref = render_frame(scene, cam, None, cfg, 0)
    sh = sharded_render_frame(scene, cam, None, cfg, 0, mesh)
    np.testing.assert_allclose(np.asarray(sh.x), np.asarray(ref.x), atol=1e-5)
    np.testing.assert_allclose(np.asarray(sh.y), np.asarray(ref.y), atol=1e-5)
    np.testing.assert_allclose(np.asarray(sh.z), np.asarray(ref.z), atol=1e-5)


def test_spp_sharding_with_texture(devices8):
    mesh = default_mesh(spp_shards=4)
    scene, cam = cornell_box_scene()
    tex = texture_from_array(gradient_sky(32, 16))
    cfg = _cfg(env_mode="equirect", env_sampling="stochastic", spp=8)
    ref = render_frame(scene, cam, tex, cfg, 0)
    sh = sharded_render_frame(scene, cam, tex, cfg, 0, mesh)
    np.testing.assert_allclose(np.asarray(sh.x), np.asarray(ref.x), atol=1e-4)


def test_sharded_frame_fn_accumulates(devices8):
    mesh = default_mesh(spp_shards=2)
    scene, cam = cornell_box_scene()
    cfg = _cfg()
    fn = make_sharded_frame_fn(cfg, mesh)
    acc = zero_accum(cfg)
    for f in range(3):
        acc = fn(scene, cam, None, f, acc)
    ref_acc = zero_accum(cfg)
    from cpuperformanceraytracer_tpu.render.frame import accumulate_frame

    for f in range(3):
        ref_acc = accumulate_frame(ref_acc, render_frame(scene, cam, None, cfg, f), f)
    np.testing.assert_allclose(np.asarray(acc.x), np.asarray(ref_acc.x), atol=1e-5)


def test_sharded_multi_frame_fn_matches_per_frame(devices8):
    """K frames fused in ONE sharded dispatch (lax.fori_loop around the
    shard_map) must equal K per-frame sharded steps — the multi-chip
    offline path no longer falls back to per-frame dispatch."""
    from cpuperformanceraytracer_tpu.parallel.shard import (
        make_sharded_multi_frame_fn,
    )

    mesh = default_mesh(spp_shards=2)
    scene, cam = cornell_box_scene()
    cfg = _cfg()
    per = make_sharded_frame_fn(cfg, mesh)
    acc_a = zero_accum(cfg)
    for f in range(4):
        acc_a = per(scene, cam, None, f, acc_a)
    fused = make_sharded_multi_frame_fn(cfg, mesh, 4)
    acc_b = fused(scene, cam, None, 0, zero_accum(cfg))
    np.testing.assert_allclose(np.asarray(acc_b.x), np.asarray(acc_a.x),
                               atol=1e-6)


def test_validation_errors(devices8):
    mesh = default_mesh(spp_shards=2)
    scene, cam = cornell_box_scene()
    with pytest.raises(ValueError, match="not divisible"):
        sharded_render_frame(scene, cam, None, _cfg(height=25), 0, mesh)
    with pytest.raises(ValueError, match="counter"):
        sharded_render_frame(scene, cam, None, _cfg(rng="wang"), 0, mesh)
    with pytest.raises(ValueError, match="spp"):
        sharded_render_frame(scene, cam, None, _cfg(spp=3), 0, mesh)


def test_graft_entry_single_chip():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    assert np.isfinite(np.asarray(out.x)).all()


def test_graft_entry_multichip(devices8):
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_pallas_backend_px_sharding_matches(devices8):
    """The megakernel under shard_map (global row0 offsets) must equal
    the single-device pallas render."""
    from cpuperformanceraytracer_tpu.kernels.megakernel import (
        render_frame_pallas,
    )

    mesh = make_mesh((4, 1), ("px", "spp"))
    scene, cam = cornell_box_scene()
    cfg = _cfg(width=128, height=32, spp=1, backend="pallas",
               tile_height=8, tile_width=128, rng="wang")
    ref = render_frame_pallas(scene, cam, None, cfg, 1)
    sh = sharded_render_frame(scene, cam, None, cfg, 1, mesh)
    np.testing.assert_allclose(np.asarray(sh.x), np.asarray(ref.x),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(sh.z), np.asarray(ref.z),
                               atol=1e-5)


def test_pallas_backend_px_spp_sharding(devices8):
    """px x spp mesh on the megakernel: counter sample windows psum to
    the unsharded multi-sample frame (env map included)."""
    from cpuperformanceraytracer_tpu.kernels.megakernel import (
        render_frame_pallas,
    )

    mesh = make_mesh((4, 2), ("px", "spp"))
    scene, cam = cornell_box_scene()
    tex = texture_from_array(gradient_sky(32, 16))
    cfg = _cfg(width=128, height=32, spp=2, backend="pallas",
               tile_height=8, tile_width=128, env_mode="equirect")
    ref = render_frame_pallas(scene, cam, tex, cfg, 1)
    sh = sharded_render_frame(scene, cam, tex, cfg, 1, mesh)
    np.testing.assert_allclose(np.asarray(sh.x), np.asarray(ref.x),
                               atol=1e-5)


def test_training_step_collective_bytes(devices8):
    """VERIFY the communication-budget model (parallel/budget.py, the
    BASELINE.md scaling table's inputs) against the all-reduce ops XLA
    actually inserts into the compiled sharded fwd+bwd step: two
    (3, H/n_px, W) image psums over "spp" (forward + transpose), the
    scalar loss reduction, and one gradient all-reduce whose operands
    are exactly the trained parameter leaves."""
    import re

    from cpuperformanceraytracer_tpu.diff.grad import (
        apply_params,
        image_loss,
    )
    from cpuperformanceraytracer_tpu.parallel.budget import (
        training_step_comm_elements,
    )
    from cpuperformanceraytracer_tpu.core.vecmath import Vec3

    scene, cam = cornell_box_scene()
    tex = texture_from_array(gradient_sky(32, 16))
    cfg = _cfg(width=128, height=64, spp=2, bounces=2,
               rng="counter", env_mode="equirect")
    n_px, n_spp = 4, 2
    mesh = make_mesh((n_px, n_spp), ("px", "spp"))
    albedo = jnp.stack([scene.materials.albedo.x, scene.materials.albedo.y,
                        scene.materials.albedo.z], -1)
    params = {"albedo": albedo,
              "env_rgb": jnp.stack([tex.r, tex.g, tex.b], -1)}
    target = Vec3(*(jnp.zeros((cfg.height, cfg.width)) for _ in range(3)))

    def loss(p):
        s, t = apply_params(scene, tex, p)
        return image_loss(
            sharded_render_frame(s, cam, t, cfg, 1, mesh), target)

    hlo = jax.jit(jax.value_and_grad(loss)).lower(params).compile().as_text()

    total = 0
    image_psums = 0
    h_local = cfg.height // n_px
    for ln in hlo.splitlines():
        # def lines only: "<result-shape-or-tuple> all-reduce(...)"
        if " all-reduce(" not in ln and " all-reduce-start(" not in ln:
            continue
        shapes = re.findall(r"f32\[([\d,]*)\]", ln.split(" all-reduce")[0])
        for s in shapes:
            n = 1
            for d in s.split(","):
                if d:
                    n *= int(d)
            total += n
        if f"f32[3,{h_local},{cfg.width}]" in ln.split(" all-reduce")[0]:
            image_psums += 1

    model = training_step_comm_elements(
        cfg.height, cfg.width, n_px, n_spp,
        [int(np.prod(v.shape)) for v in params.values()])
    # forward psum + its transpose
    assert image_psums == 2, image_psums
    # the model must account for the compiled program's collective
    # traffic (exact at this scale; allow a few stray scalars)
    assert abs(total - model) <= 16, (total, model)
