"""Pallas (Triton-route) kernel tests on the CPU.

Parity runs the kernel in interpret mode. Strategy: decision-STABLE
configs (pure diffuse materials, no lottery sensitivity) must match the
oracle integrator to float tolerance everywhere; stochastic glass
configs are checked with robust statistics (means + outlier fraction)
because a 1-ulp transcendental difference can flip a lottery roll and
legitimately diverge a single path.

The CUDA-lowering rehearsals lower the compiled (non-interpret) kernel
for the "cuda" platform on this CPU: a primitive the Triton route cannot
lower, or a block shape it refuses, fails here without a GPU. What only
the GPU's compiler can refuse (registers, PTX) is checked by the
``gpu``-marked tests and chip_smoke.py.
"""

import numpy as np
import jax
import pytest

from cpuperformanceraytracer_tpu.config import RenderConfig
from cpuperformanceraytracer_tpu.kernels.megakernel import (
    num_warps,
    padded_extent,
    render_frame_pallas,
)
from cpuperformanceraytracer_tpu.render.frame import render_frame
from cpuperformanceraytracer_tpu.scene.presets import (
    cornell_box_scene,
    glass_spheres_scene,
)
from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
from cpuperformanceraytracer_tpu.texture.texture import texture_from_array


def _cfg(**kw):
    base = dict(width=256, height=32, spp=1, bounces=2, scene="cornell_box",
                env_mode="none", ambient=(0.1, 0.1, 0.1), env_flip_xz=False,
                jitter=False, roulette="off", rng="wang",
                tile_height=8, tile_width=128)
    base.update(kw)
    return RenderConfig(**base)


class TestMegakernelParity:
    def test_diffuse_scene_allclose(self):
        """Pure-diffuse cornell: no lottery sensitivity -> strict parity."""
        scene, cam = cornell_box_scene()
        cfg = _cfg()
        a = render_frame(scene, cam, None, cfg, 2)
        b = render_frame_pallas(scene, cam, None, cfg, 2)
        np.testing.assert_allclose(np.asarray(b.x), np.asarray(a.x),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(b.y), np.asarray(a.y),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(np.asarray(b.z), np.asarray(a.z),
                                   rtol=1e-4, atol=1e-5)

    def test_diffuse_with_jitter_and_spp(self):
        scene, cam = cornell_box_scene()
        cfg = _cfg(jitter=True, spp=2)
        a = render_frame(scene, cam, None, cfg, 1)
        b = render_frame_pallas(scene, cam, None, cfg, 1)
        np.testing.assert_allclose(np.asarray(b.x), np.asarray(a.x),
                                   rtol=1e-4, atol=1e-5)

    def test_counter_rng_mode(self):
        scene, cam = cornell_box_scene()
        cfg = _cfg(rng="counter", spp=2, jitter=True)
        a = render_frame(scene, cam, None, cfg, 1)
        b = render_frame_pallas(scene, cam, None, cfg, 1)
        np.testing.assert_allclose(np.asarray(b.x), np.asarray(a.x),
                                   rtol=1e-4, atol=1e-5)

    def test_glass_scene_robust(self):
        """Glass scene: lottery decisions can flip on 1-ulp differences;
        means must agree and outliers must be rare."""
        scene, cam = glass_spheres_scene()
        cfg = _cfg(scene="glass_spheres", bounces=4, jitter=True,
                   roulette="v4_quirk")
        a = render_frame(scene, cam, None, cfg, 2)
        b = render_frame_pallas(scene, cam, None, cfg, 2)
        pa, pb = np.asarray(a.x), np.asarray(b.x)
        assert abs(pa.mean() - pb.mean()) < 5e-3 * max(pa.mean(), 1e-3)
        frac_diff = np.mean(np.abs(pa - pb) > 1e-3)
        assert frac_diff < 0.01, f"{frac_diff:.4%} pixels diverged"

    def test_env_textured_robust(self):
        scene, cam = glass_spheres_scene()
        tex = texture_from_array(gradient_sky(64, 32))
        cfg = _cfg(scene="glass_spheres", bounces=3, jitter=True,
                   env_mode="equirect", env_sampling="stochastic",
                   env_flip_xz=True)
        a = render_frame(scene, cam, tex, cfg, 1)
        b = render_frame_pallas(scene, cam, tex, cfg, 1)
        pa, pb = np.asarray(a.x), np.asarray(b.x)
        assert abs(pa.mean() - pb.mean()) < 1e-2 * max(pa.mean(), 1e-3)
        assert np.mean(np.abs(pa - pb) > 1e-3) < 0.02

    def test_env_cubemap_parity(self):
        """Cubemap env through the KERNEL's deferred path vs the oracle
        (VERDICT r4 item 8: the kernel's cubemap branch had no frame-
        level parity test). Robust stats like test_env_textured_robust
        (glass lottery flips allowed)."""
        scene, cam = glass_spheres_scene()
        sky = gradient_sky(16, 16)
        # DISTINCT faces (scaled differently) so any face-order or
        # uv-mapping divergence between kernel and oracle shows up
        faces = [sky * (0.3 + 0.2 * i) for i in range(6)]
        tex = texture_from_array(np.concatenate(faces, axis=0))
        cfg = _cfg(scene="glass_spheres", bounces=3, jitter=True,
                   env_mode="cubemap", env_sampling="stochastic",
                   env_flip_xz=True)
        a = render_frame(scene, cam, tex, cfg, 1)
        b = render_frame_pallas(scene, cam, tex, cfg, 1)
        pa, pb = np.asarray(a.x), np.asarray(b.x)
        assert abs(pa.mean() - pb.mean()) < 1e-2 * max(pa.mean(), 1e-3)
        assert np.mean(np.abs(pa - pb) > 1e-3) < 0.02

    def test_spp_env_restriction(self):
        """wang streams are sequential across the sample loop and cannot
        split into per-sample dispatches."""
        scene, cam = glass_spheres_scene()
        tex = texture_from_array(gradient_sky(16, 8))
        cfg = _cfg(scene="glass_spheres", env_mode="equirect", spp=2)
        with pytest.raises(NotImplementedError):
            render_frame_pallas(scene, cam, tex, cfg, 0)

    def test_multi_spp_env_counter(self):
        """spp>1 with an env map splits into per-sample dispatches on
        addressable counter streams; robust stats vs the oracle (glass
        lottery flips allowed)."""
        scene, cam = glass_spheres_scene()
        tex = texture_from_array(gradient_sky(64, 32))
        cfg = _cfg(scene="glass_spheres", bounces=3, jitter=True,
                   env_mode="equirect", env_sampling="stochastic",
                   env_flip_xz=True, rng="counter", spp=3)
        a = render_frame(scene, cam, tex, cfg, 1)
        b = render_frame_pallas(scene, cam, tex, cfg, 1)
        pa, pb = np.asarray(a.x), np.asarray(b.x)
        assert abs(pa.mean() - pb.mean()) < 1e-2 * max(pa.mean(), 1e-3)
        assert np.mean(np.abs(pa - pb) > 1e-3) < 0.02


class TestFusedCombine:
    """The jitted progressive frame step on the pallas backend (baked
    scene, donated accumulation) must equal the kernel render + the
    running-mean accumulate, frame by frame."""

    def _run(self, cfg, frames=3):
        from cpuperformanceraytracer_tpu.render.frame import (
            accumulate_frame,
            make_frame_fn,
            zero_accum,
        )

        scene, cam = glass_spheres_scene()
        tex = texture_from_array(gradient_sky(64, 32))
        step = make_frame_fn(cfg, scene=scene, camera=cam)
        a_old = zero_accum(cfg)
        a_new = zero_accum(cfg)
        for f in range(frames):
            color = render_frame_pallas(scene, cam, tex, cfg, f)
            a_old = accumulate_frame(a_old, color, f)
            a_new = step(scene, cam, tex, f, a_new)
        for c_new, c_old in zip(a_new, a_old):
            np.testing.assert_allclose(np.asarray(c_new), np.asarray(c_old),
                                       rtol=1e-5, atol=1e-6)

    def test_fused_equals_unfused_wang_spp1(self):
        self._run(_cfg(scene="glass_spheres", bounces=3, jitter=True,
                       env_mode="equirect", env_sampling="stochastic",
                       env_flip_xz=True, backend="pallas"))

    def test_fused_equals_unfused_counter_spp3(self):
        self._run(_cfg(scene="glass_spheres", bounces=2, jitter=True,
                       env_mode="equirect", env_sampling="stochastic",
                       env_flip_xz=True, rng="counter", spp=3,
                       backend="pallas"), frames=2)


# (rng, spp, env_mode, bake_scene, early_exit); wang + spp>1 + env is
# rejected by design (test_spp_env_restriction)
_PARITY_CASES = [
    ("wang", 1, "none", True, True),
    ("wang", 1, "none", False, False),
    ("wang", 2, "none", True, True),
    ("wang", 2, "none", False, True),
    ("wang", 1, "equirect", True, True),
    ("wang", 1, "equirect", False, False),
    ("counter", 1, "none", True, False),
    ("counter", 2, "none", False, True),
    ("counter", 1, "equirect", True, True),
    ("counter", 1, "equirect", False, True),
    ("counter", 2, "equirect", True, True),
    ("counter", 2, "equirect", False, False),
]


@pytest.mark.parametrize("rng,spp,env,bake,early", _PARITY_CASES)
def test_kernel_parity_grid(rng, spp, env, bake, early):
    """Diffuse cornell box (decision-stable): the kernel matches the
    oracle to float tolerance across RNG family, samples per dispatch,
    env mode, scene baking and the block early exit. The frame is not a
    whole number of blocks, so padding and cropping run too."""
    scene, cam = cornell_box_scene()
    tex = texture_from_array(gradient_sky(32, 16)) if env != "none" else None
    cfg = _cfg(width=40, height=12, rng=rng, spp=spp, env_mode=env,
               env_sampling="stochastic", jitter=True, bake_scene=bake,
               early_exit=early, tile_height=8, tile_width=32)
    a = render_frame(scene, cam, tex, cfg, 3)
    b = render_frame_pallas(scene, cam, tex, cfg, 3)
    for ca, cb in zip(a, b):
        assert cb.shape == (12, 40)
        np.testing.assert_allclose(np.asarray(cb), np.asarray(ca),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("height,width,tile,want", [
    (720, 1280, (8, 32), (720, 1280)),
    (1080, 1920, (8, 64), (1080, 1920)),
    (240, 320, (8, 64), (240, 320)),
    (77, 100, (8, 64), (80, 128)),
    (540, 3840, (8, 64), (544, 3840)),
])
def test_padded_extent(height, width, tile, want):
    """Frames are padded to whole power-of-two blocks (the 4K frame's
    540-row shard on a 4-card mesh included)."""
    assert padded_extent(height, width, *tile) == want


def test_num_warps_from_block():
    assert num_warps(8, 64, 2) == 8
    assert num_warps(8, 64, 4) == 4
    assert num_warps(2, 2, 2) == 1       # clamped below
    assert num_warps(64, 256, 1) == 32   # clamped above


def test_odd_frame_padding_matches_oracle():
    """100x77 (no power-of-two factor in either dimension) through the
    whole frame step: the cropped padded render equals the oracle."""
    from cpuperformanceraytracer_tpu.render.frame import make_frame_fn, zero_accum

    scene, cam = cornell_box_scene()
    cfg = _cfg(width=100, height=77, backend="pallas", tile_height=8,
               tile_width=64, jitter=True)
    step = make_frame_fn(cfg, scene=scene, camera=cam)
    got = step(scene, cam, None, 0, zero_accum(cfg))
    want = render_frame(scene, cam, None, cfg, 0)
    for cg, cw in zip(got, want):
        assert cg.shape == (77, 100)
        np.testing.assert_allclose(np.asarray(cg), np.asarray(cw),
                                   rtol=1e-4, atol=1e-5)


def test_tile_must_be_power_of_two():
    with pytest.raises(ValueError, match="power of two"):
        _cfg(tile_height=24).validate()
    with pytest.raises(ValueError, match="power of two"):
        _cfg(tile_width=320).validate()


# ---------------------------------------------------------------------------
# CUDA-lowering rehearsals (no GPU needed)
# ---------------------------------------------------------------------------


def _triton_modules(lowered):
    """The Triton IR text of every Triton custom call in a lowering."""
    from jax._src.lib.mlir import ir
    from jax._src.pallas.triton.lowering import _new_ir_context

    blobs = []

    def walk(op):
        for region in op.regions:
            for block in region.blocks:
                for o in block.operations:
                    if o.operation.name == "stablehlo.custom_call" and (
                            "xla.gpu.triton" in str(
                                o.attributes["call_target_name"])):
                        cfg = ir.DictAttr(o.attributes["mhlo.backend_config"])
                        blobs.append(ir.StringAttr(cfg["ir"]).value_bytes)
                    walk(o.operation)

    walk(lowered.compiler_ir("stablehlo").operation)
    texts = []
    with _new_ir_context(), ir.Location.unknown():
        for b in blobs:
            texts.append(str(ir.Module.parse(b)))
    return texts


_FAMILIES = {
    # the reference default workload (wang, baked, env, stochastic)
    "headline": dict(scene="glass_spheres", env_mode="equirect",
                     env_sampling="stochastic", env_flip_xz=True,
                     jitter=True, roulette="v4_quirk", bounces=8),
    # simd_tiled_720: counter RNG, 4 samples per dispatch, no env
    "simd_tiled": dict(scene="glass_spheres", env_mode="none", spp=4,
                       rng="counter", jitter=True, roulette="v4_quirk"),
    # traced (unbaked) scene: tables read as scalars from device memory
    "traced_scene": dict(scene="glass_spheres", env_mode="equirect",
                         bake_scene=False, roulette="terminate"),
    # cubemap + bilinear env, zangle sampler (sin/cos), no early exit
    "cubemap_zangle": dict(scene="glass_spheres", env_mode="cubemap",
                           env_sampling="bilinear",
                           unit_vector_sampler="zangle", early_exit=False),
    # textured_1080: counter RNG with per-sample env dispatches
    "multi_sample_env": dict(scene="glass_spheres", env_mode="equirect",
                             rng="counter", spp=2),
}


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_cuda_lowering_rehearsal(family):
    """The compiled kernel of each config family lowers for CUDA: one
    Triton call per dispatch, normalization through libdevice's rsqrt
    (the instruction XLA emits for the oracle's normalize), the bounce
    loop rolled."""
    scene, cam = glass_spheres_scene()
    kw = _FAMILIES[family]
    cfg = _cfg(width=96, height=20, tile_height=8, tile_width=64, **kw)
    tex = None
    if cfg.env_mode == "equirect":
        tex = texture_from_array(gradient_sky(32, 16))
    elif cfg.env_mode == "cubemap":
        tex = texture_from_array(gradient_sky(8, 48))
    fn = jax.jit(lambda t, f: render_frame_pallas(scene, cam, t, cfg, f))
    lowered = fn.trace(tex, 1).lower(lowering_platforms=("cuda",))
    mods = _triton_modules(lowered)
    dispatches = cfg.spp if cfg.env_mode != "none" else 1
    assert len(mods) == dispatches
    for text in mods:
        assert "__nv_rsqrtf" in text
        assert "scf.while" in text


def test_cuda_lowering_sharded_window(devices8):
    """The kernel under shard_map (traced row0 from axis_index, padded
    540-row-like shard) lowers for CUDA on a 4-device mesh."""
    from cpuperformanceraytracer_tpu.parallel.mesh import make_mesh
    from cpuperformanceraytracer_tpu.parallel.shard import sharded_render_frame

    scene, cam = cornell_box_scene()
    mesh = make_mesh((4, 1), ("px", "spp"), devices=devices8[:4])
    cfg = _cfg(width=64, height=24, backend="pallas", tile_height=8,
               tile_width=64, rng="counter")
    fn = jax.jit(lambda f: sharded_render_frame(scene, cam, None, cfg, f,
                                                mesh))
    lowered = fn.trace(1).lower(lowering_platforms=("cuda",))
    assert len(_triton_modules(lowered)) == 1


def test_interpret_only_on_cpu_lowering():
    """The interpreter is chosen by the platform the call is lowered
    for: the CPU lowering holds no Triton call (it interprets), the CUDA
    lowering holds the Triton call and nothing of the interpreter."""
    scene, cam = cornell_box_scene()
    cfg = _cfg(width=64, height=8, tile_height=8, tile_width=64)
    fn = jax.jit(lambda f: render_frame_pallas(scene, cam, None, cfg, f))
    cpu = fn.trace(0).lower(lowering_platforms=("cpu",))
    cuda = fn.trace(0).lower(lowering_platforms=("cuda",))
    assert "xla.gpu.triton" not in cpu.as_text()
    assert "xla.gpu.triton" in cuda.as_text()
    # the interpreter's per-block loop over the grid is a while loop in
    # the CPU module; the CUDA module has none outside the kernel
    assert "stablehlo.while" in cpu.as_text()
    assert "stablehlo.while" not in cuda.as_text()
