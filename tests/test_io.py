"""IO tests: BMP/PNG writers, checkpoint roundtrip + resume."""

import numpy as np
import jax.numpy as jnp

from cpuperformanceraytracer_tpu.config import RenderConfig
from cpuperformanceraytracer_tpu.core.vecmath import Vec3
from cpuperformanceraytracer_tpu.io.checkpoint import (
    load_checkpoint,
    resume_or_fresh,
    save_checkpoint,
)
from cpuperformanceraytracer_tpu.io.image import read_bmp, write_bmp, write_png


def test_bmp_roundtrip(tmp_path):
    rs = np.random.RandomState(0)
    img = rs.randint(0, 256, (13, 17, 3), np.uint8)  # odd width: padding path
    p = str(tmp_path / "x.bmp")
    write_bmp(p, img)
    back = read_bmp(p)
    assert np.array_equal(back, img)


def test_png_valid_signature(tmp_path):
    img = np.zeros((4, 4, 3), np.uint8)
    p = str(tmp_path / "x.png")
    write_png(p, img)
    with open(p, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert b"IHDR" in data and b"IEND" in data


def test_checkpoint_roundtrip(tmp_path):
    cfg = RenderConfig(width=8, height=6)
    acc = Vec3(
        jnp.arange(48, dtype=jnp.float32).reshape(6, 8),
        jnp.ones((6, 8), jnp.float32),
        jnp.zeros((6, 8), jnp.float32),
    )
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, acc, 17, cfg)
    back, frame, saved_cfg = load_checkpoint(p)
    assert frame == 17
    assert saved_cfg.width == 8 and saved_cfg.height == 6
    assert np.allclose(np.asarray(back.x), np.asarray(acc.x))


def test_resume_or_fresh(tmp_path):
    cfg = RenderConfig(width=8, height=6)
    acc, frame = resume_or_fresh(None, cfg)
    assert frame == 0 and np.asarray(acc.x).shape == (6, 8)
    # incompatible resolution falls back to fresh
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, acc, 5, cfg)
    acc2, frame2 = resume_or_fresh(p, cfg.replace(width=16))
    assert frame2 == 0
    acc3, frame3 = resume_or_fresh(p, cfg)
    assert frame3 == 5


def test_resume_rejects_image_affecting_mismatch(tmp_path):
    """Any config field that shapes the accumulated image (not just
    resolution) must invalidate a checkpoint — resuming a different
    scene/spp/rng/roulette would silently corrupt the running mean."""
    cfg = RenderConfig(width=8, height=6)
    acc, _ = resume_or_fresh(None, cfg)
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, acc, 5, cfg)
    for bad in (cfg.replace(spp=4), cfg.replace(bounces=2),
                cfg.replace(scene="cornell_box"), cfg.replace(rng="counter"),
                cfg.replace(roulette="off"), cfg.replace(env_mode="none"),
                cfg.replace(jitter=False)):
        _, frame = resume_or_fresh(p, bad)
        assert frame == 0, f"should reject {bad}"
    # execution-strategy fields must NOT invalidate (same image)
    for ok in (cfg.replace(backend="pallas", tile_width=8, tile_height=4),
               cfg.replace(num_frames=3), cfg.replace(exposure=2.0),
               cfg.replace(frames_per_dispatch=4)):
        _, frame = resume_or_fresh(p, ok)
        assert frame == 5, f"should accept {ok}"


def test_native_codec_matches_python(tmp_path):
    """The C++ RGBE/BMP codec (native/rgbe.cpp) must agree with the pure
    python decoders; skipped only if the shared lib cannot be built."""
    import subprocess

    import pytest

    from cpuperformanceraytracer_tpu.io import native

    if native.get_lib() is None:
        r = subprocess.run(["make", "-C", "native"], cwd="/root/repo",
                           capture_output=True, text=True)
        native._TRIED, native._LIB = False, None  # force re-probe
        if r.returncode != 0 or native.get_lib() is None:
            pytest.skip("no C++ toolchain for native codec")

    from cpuperformanceraytracer_tpu.texture.hdr import read_hdr, write_hdr

    rs = np.random.RandomState(7)
    img = (rs.rand(9, 33, 3).astype(np.float32) * 4.0)
    p = str(tmp_path / "t.hdr")
    write_hdr(p, img)
    a = native.read_hdr_native(p)
    b = read_hdr(p)
    assert a is not None
    np.testing.assert_allclose(a, b, rtol=0, atol=0)

    u8 = rs.randint(0, 256, (11, 22, 3), np.uint8)
    bp = str(tmp_path / "t.bmp")
    assert native.write_bmp_native(bp, u8)
    np.testing.assert_array_equal(read_bmp(bp), u8)


def test_bilinear_resample_semantics():
    """Pixel-center bilinear resample (BilinearResampleRGB32 analog —
    correct semantics; the reference helper is unused and buggy)."""
    from cpuperformanceraytracer_tpu.texture.texture import bilinear_resample

    img = np.zeros((2, 2, 3), np.float32)
    img[0, 0] = 1.0
    img[1, 1] = 3.0
    # identity resample returns the image
    np.testing.assert_allclose(bilinear_resample(img, 2, 2), img, atol=1e-6)
    # 2x upsample center pixel interpolates the 2x2 neighborhood
    up = bilinear_resample(img, 4, 4)
    assert up.shape == (4, 4, 3)
    assert 0.0 < up[1, 1, 0] < 1.0
    # constant image stays constant at any size
    const = np.full((3, 5, 3), 2.5, np.float32)
    np.testing.assert_allclose(bilinear_resample(const, 7, 2), 2.5, atol=1e-6)


def test_screenshot_timestamped(tmp_path):
    from cpuperformanceraytracer_tpu.render.driver import OfflineRenderer

    cfg = RenderConfig(width=16, height=8, spp=1, bounces=1,
                       scene="cornell_box", env_mode="none",
                       num_frames=1, warmup_frames=0, roulette="off")
    r = OfflineRenderer(cfg, silent=True)
    r.step()
    p = r.screenshot(str(tmp_path))
    import os
    assert os.path.exists(p) and p.endswith("frame1.bmp")
