"""Driver + CLI tests: offline protocol, watch mode, checkpointing,
pallas backend selection."""

import json
import os
import subprocess
import sys

import numpy as np

from cpuperformanceraytracer_tpu.config import RenderConfig
from cpuperformanceraytracer_tpu.render.driver import OfflineRenderer


def _cfg(**kw):
    base = dict(width=32, height=24, spp=1, bounces=2, scene="cornell_box",
                env_mode="none", ambient=(0.1, 0.1, 0.1), env_flip_xz=False,
                jitter=True, roulette="off", num_frames=4, warmup_frames=1)
    base.update(kw)
    return RenderConfig(**base)


def test_offline_run_and_image(tmp_path):
    r = OfflineRenderer(_cfg(), silent=True)
    t = r.run()
    assert t.timed_frames == 4
    assert t.mean_ms > 0
    img = r.image_u8()
    assert img.shape == (24, 32, 3) and img.dtype == np.uint8
    p = str(tmp_path / "out.bmp")
    r.write_image(p)
    assert os.path.getsize(p) > 100


def test_warmup_does_not_pollute_accum():
    a = OfflineRenderer(_cfg(warmup_frames=0), silent=True)
    b = OfflineRenderer(_cfg(warmup_frames=2), silent=True)
    a.run()
    b.run()
    np.testing.assert_array_equal(np.asarray(a.state.accum.x),
                                  np.asarray(b.state.accum.x))


def test_checkpoint_resume_identical(tmp_path):
    ck = str(tmp_path / "ck.npz")
    # straight run of 4 frames
    a = OfflineRenderer(_cfg(num_frames=4), silent=True)
    a.run()
    # run 2, checkpoint, resume, run 2 more
    b = OfflineRenderer(_cfg(num_frames=2), silent=True)
    b.run(checkpoint_path=ck, checkpoint_every=2)
    c = OfflineRenderer(_cfg(num_frames=2), silent=True)
    c.resume(ck)
    assert c.state.frame == 2
    for _ in range(2):
        c.step()
    np.testing.assert_allclose(np.asarray(a.state.accum.x),
                               np.asarray(c.state.accum.x), atol=1e-6)


def test_checkpoint_cadence_not_coarsened(tmp_path):
    """checkpoint_every must not silently coarsen to lcm(sync, ckpt):
    with checkpoint_every=10 over 64 frames a checkpoint MUST be written
    (regression: sync_every=16 made the cadence lcm(16,10)=80 > 64)."""
    ck = str(tmp_path / "ck.npz")
    r = OfflineRenderer(_cfg(num_frames=64, warmup_frames=0), silent=True)
    r.run(checkpoint_path=ck, checkpoint_every=10)
    assert os.path.exists(ck)
    from cpuperformanceraytracer_tpu.io.checkpoint import load_checkpoint

    _, frame, _ = load_checkpoint(ck)
    # the final sync point (frame 64) is not a multiple of 10; the last
    # checkpoint must be at frame 60
    assert frame == 60


def test_frame_timer_spans_are_real_measurements():
    """add_span records (seconds, frames) spans, not fabricated
    per-frame samples (ADVICE round 1)."""
    from cpuperformanceraytracer_tpu.utils.timing import FrameTimer

    t = FrameTimer(warmup_frames=0)
    t.add_span(0.5, 10)
    t.add_span(0.25, 10)
    assert t.spans == [(0.5, 10), (0.25, 10)]
    assert t.timed_frames == 20
    assert abs(t.mean_ms - 37.5) < 1e-9
    assert abs(t.rays_per_second(100.0) - 100.0 * 20 / 0.75) < 1e-6

    # warmup straddling a span: prorated share attributed to timed frames
    t2 = FrameTimer(warmup_frames=2)
    t2.add_span(0.4, 4)
    assert t2.timed_frames == 2
    assert abs(t2.spans[0][0] - 0.2) < 1e-12


def test_pallas_backend_driver():
    cfg = _cfg(backend="pallas", width=128, height=16,
               tile_height=8, tile_width=64)
    r = OfflineRenderer(cfg, silent=True)
    r.run()
    assert np.isfinite(np.asarray(r.state.accum.x)).all()


def test_term_view_ansi():
    """Live-view rendering: truecolor half-block frame of the right
    geometry, mean-pooled from the image."""
    from cpuperformanceraytracer_tpu.utils.term_view import ansi_frame, live_view

    img = np.zeros((48, 96, 3), np.uint8)
    img[:24] = (255, 0, 0)   # top half red
    img[24:] = (0, 0, 255)   # bottom half blue
    s = ansi_frame(img, cols=32, rows=8)
    lines = s.split("\n")
    assert len(lines) == 8
    assert lines[0].count("▀") == 32
    assert "38;2;255;0;0" in lines[0] and "48;2;255;0;0" in lines[0]
    assert "38;2;0;0;255" in lines[-1]
    v = live_view(img, "frame 1/2 | stats", cols=16, rows=4, first=True)
    assert v.startswith("\x1b[2J\x1b[H") and v.rstrip().endswith("\x1b[K")
    assert "frame 1/2" in v


def test_cli_watch_live(tmp_path, capsys):
    """watch --live draws ANSI frames + a stats line and still writes
    the output file each interval."""
    from cpuperformanceraytracer_tpu.app.cli import main

    out = str(tmp_path / "live.bmp")
    rc = main(["watch", "--scene", "cornell_box", "--width", "32",
               "--height", "24", "--bounces", "2", "--frames", "4",
               "--warmup", "0", "--roulette", "off", "--interval", "2",
               "--live", "-o", out])
    assert rc == 0
    assert os.path.exists(out)
    cap = capsys.readouterr().out
    assert "▀" in cap and "ms/frame" in cap and "fps" in cap
    assert "frame 4/4" in cap


def test_cli_render(tmp_path):
    out = str(tmp_path / "cli.png")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = ""
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from cpuperformanceraytracer_tpu.app.cli import main;"
        f"main(['render','--scene','cornell_box','--width','32','--height','24',"
        f"'--bounces','2','--frames','2','--warmup','0','--roulette','off',"
        f"'-o','{out}','--silent'])"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd="/root/repo",
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert os.path.exists(out)


def test_cli_config_errors_are_one_line(capsys):
    """Config mistakes (bad --scene, missing env file) exit with a
    one-line `error:` message, not a traceback — the CLI analog of
    CheckValidSettings (Application.cpp:36-94)."""
    from cpuperformanceraytracer_tpu.app.cli import main

    rc = main(["render", "--scene", "not_a_scene", "-o", "/tmp/x.bmp"])
    assert rc == 2
    err = capsys.readouterr().err
    assert err.startswith("error:") and "cornell_box" in err

    rc = main(["render", "--env", "/no/such/file.hdr", "-o", "/tmp/x.bmp"])
    assert rc == 2
    assert "error:" in capsys.readouterr().err
