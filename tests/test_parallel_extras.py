"""Scaling harness, sharded driver, debug visualization, profiling report,
multi-process jax.distributed bring-up."""

import numpy as np

from cpuperformanceraytracer_tpu.config import RenderConfig
from cpuperformanceraytracer_tpu.parallel.mesh import default_mesh
from cpuperformanceraytracer_tpu.parallel.scaling import measure_scaling
from cpuperformanceraytracer_tpu.render.driver import OfflineRenderer
from cpuperformanceraytracer_tpu.scene.presets import cornell_box_scene
from cpuperformanceraytracer_tpu.utils.debug_vis import (
    block_ownership_image,
    overlay,
    shard_ownership_image,
)
from cpuperformanceraytracer_tpu.utils.profiling import throughput_report


def _cfg(**kw):
    base = dict(width=32, height=24, spp=2, bounces=2, scene="cornell_box",
                env_mode="none", ambient=(0.1, 0.1, 0.1), env_flip_xz=False,
                jitter=True, roulette="off", rng="counter",
                num_frames=3, warmup_frames=0)
    base.update(kw)
    return RenderConfig(**base)


def test_scaling_harness_runs(devices8):
    scene, cam = cornell_box_scene()
    pts = measure_scaling(scene, cam, None, _cfg(), device_counts=[1, 4],
                          frames=2)
    assert [p.devices for p in pts] == [1, 4]
    assert all(p.ms_per_frame > 0 and np.isfinite(p.mrays_per_s) for p in pts)
    assert pts[0].efficiency == 1.0


def test_sharded_driver_matches_unsharded(devices8):
    cfg = _cfg(num_frames=2)
    scene, cam = cornell_box_scene()
    a = OfflineRenderer(cfg, scene=scene, camera=cam, silent=True)
    b = OfflineRenderer(cfg, scene=scene, camera=cam, silent=True,
                        mesh=default_mesh(spp_shards=2))
    a.run()
    b.run()
    np.testing.assert_allclose(np.asarray(a.state.accum.x),
                               np.asarray(b.state.accum.x), atol=1e-5)


def test_debug_vis_shapes():
    cfg = _cfg(width=64, height=48, tile_height=8, tile_width=64)
    s = shard_ownership_image(cfg, 4)
    assert s.shape == (48, 64, 3)
    assert len(np.unique(s.reshape(-1, 3), axis=0)) == 4
    b = block_ownership_image(cfg)
    assert b.shape == (48, 64, 3)
    o = overlay(np.zeros((48, 64, 3), np.uint8), s)
    assert o.shape == (48, 64, 3) and o.max() > 0


import pytest


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_two_process_distributed_render(backend):
    """Exercise the REAL multi-host bring-up path: two localhost CPU
    processes through parallel.mesh.init_distributed form one 8-device
    global mesh and render a shard_map'd frame (the work_queue.cpp:17-66
    replacement story, finally multi-process). Each worker prints the
    frame's global mean radiance; both must agree with a single-process
    render of the same config to float tolerance. backend="pallas" runs
    the Pallas kernel under the multi-process mesh — the forward leg a
    multi-host deployment uses."""
    import os
    import socket
    import subprocess
    import sys

    import jax

    from cpuperformanceraytracer_tpu.scene.presets import scene_by_name

    # the reference value, computed in-process (single "host")
    cfg = _cfg(width=64, height=48, spp=2, bounces=2, jitter=True,
               rng="counter")
    from cpuperformanceraytracer_tpu.render.frame import render_frame

    scene, cam = scene_by_name(cfg.scene)
    color = render_frame(scene, cam, None, cfg, 3)
    want = float((color.x.mean() + color.y.mean() + color.z.mean()) / 3.0)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    worker = os.path.join(os.path.dirname(__file__), "distributed_worker.py")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(worker))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", coord, backend],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env)
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-2000:]}"
        line = [ln for ln in out.splitlines()
                if ln.startswith(f"WORKER {pid} MEAN")]
        assert line, f"worker {pid} printed no MEAN:\n{out[-2000:]}"
        got = float(line[0].split()[-1])
        assert abs(got - want) < 1e-5, (pid, got, want)


def test_two_process_distributed_training_step():
    """The multi-process TRAINING leg: two real processes run one
    value_and_grad step through sharded_render_frame — XLA's adjoint per
    shard, parameter gradients (incl. every env texel) all-reduced
    through the shard_map transpose over the 2-process global mesh. Both
    workers' gradients must match a single-process unsharded
    reference."""
    import os
    import socket
    import subprocess
    import sys

    import jax
    import jax.numpy as jnp

    from cpuperformanceraytracer_tpu.diff.grad import (
        image_loss,
        render_for_params,
    )
    from cpuperformanceraytracer_tpu.scene.presets import scene_by_name
    from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
    from cpuperformanceraytracer_tpu.texture.texture import texture_from_array

    # the same problem the worker builds (keep in sync with
    # distributed_worker.py mode="grad")
    cfg = _cfg(width=64, height=48, spp=2, bounces=2, jitter=True,
               rng="counter", env_mode="equirect").replace(env_flip_xz=True)
    scene, cam = scene_by_name(cfg.scene)
    tex = texture_from_array(gradient_sky(16, 8))
    target = render_for_params({}, scene, cam, tex, cfg, 0)

    albedo = np.stack([scene.materials.albedo.x, scene.materials.albedo.y,
                       scene.materials.albedo.z], -1)
    centers = np.stack([scene.spheres.center.x, scene.spheres.center.y,
                        scene.spheres.center.z], -1)
    params = {"albedo": albedo + 0.05, "sphere_centers": centers + 0.1,
              "env_rgb": np.stack([tex.r, tex.g, tex.b], -1)}

    def loss_fn(p):
        img = render_for_params(p, scene, cam, tex, cfg, 3)
        return image_loss(img, target)

    want_loss, want_grads = jax.value_and_grad(loss_fn)(
        jax.tree.map(jnp.asarray, params))

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"
    worker = os.path.join(os.path.dirname(__file__), "distributed_worker.py")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(worker))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(pid), "2", coord, "grad"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env)
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-2000:]}"
        lines = {ln.split()[3]: ln.split()[4:]
                 for ln in out.splitlines()
                 if ln.startswith(f"WORKER {pid} GRAD")}
        assert set(lines) == set(params), (pid, sorted(lines))
        loss_line = [ln for ln in out.splitlines()
                     if ln.startswith(f"WORKER {pid} LOSS")]
        got_loss = float(loss_line[0].split()[-1])
        assert abs(got_loss - float(want_loss)) <= 1e-5 * max(
            1.0, abs(float(want_loss))), (pid, got_loss, float(want_loss))
        for key, (norm_s, sum_s) in lines.items():
            g = np.asarray(want_grads[key], np.float64)
            want_norm, want_sum = np.linalg.norm(g), g.sum()
            tol = 1e-4 * max(want_norm, 1e-6)
            assert abs(float(norm_s) - want_norm) <= tol, (
                pid, key, norm_s, want_norm)
            assert abs(float(sum_s) - want_sum) <= 10 * tol, (
                pid, key, sum_s, want_sum)


def test_throughput_report():
    r = throughput_report(_cfg(width=1280, height=720, spp=1, bounces=8), 100.0)
    assert abs(r.primary_mrays_per_s - 9.216) < 0.01
    assert abs(r.max_segment_mrays_per_s - 9.216 * 9) < 0.1
    assert "ms/frame" in str(r)
