"""Worker process for the multi-process jax.distributed test.

Each of N localhost processes owns 4 virtual CPU devices; together they
form one 8-device global mesh over which a frame is rendered with
shard_map (pixel rows sharded). The worker prints the frame's global
mean radiance — identical across processes (the mean is a collective) —
which the parent test compares against a single-process render.

Run: python tests/distributed_worker.py <pid> <nproc> <coordinator> [mode]

``mode`` (default "xla") selects the leg under test: "xla" / "pallas"
render a forward frame with that backend; "grad" runs ONE
value_and_grad step of the L2 pixel loss through sharded_render_frame
— XLA's adjoint per shard with parameter gradients all-reduced through
the shard_map transpose across the two REAL processes (the leg a
2-host deployment trains on; replaces work_queue.cpp:17-66). Prints
per-key gradient summaries the parent compares against a
single-process reference.
"""

import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax

jax.config.update("jax_platforms", "cpu")


def main() -> int:
    pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    backend = sys.argv[4] if len(sys.argv) > 4 else "xla"

    from cpuperformanceraytracer_tpu.parallel.mesh import init_distributed

    init_distributed(coordinator=coord, num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 4 * nproc, len(jax.devices())

    import numpy as np

    from cpuperformanceraytracer_tpu.config import RenderConfig
    from cpuperformanceraytracer_tpu.parallel.mesh import make_mesh
    from cpuperformanceraytracer_tpu.parallel.shard import sharded_render_frame
    from cpuperformanceraytracer_tpu.scene.presets import scene_by_name

    # pallas: each of the 4*nproc row shards holds 48/(4*nproc) = 6
    # rows, padded to one 8-row block
    cfg = RenderConfig(width=64, height=48, spp=2, bounces=2,
                       scene="cornell_box", env_mode="none",
                       ambient=(0.1, 0.1, 0.1), jitter=True, rng="counter",
                       roulette="off", backend=backend,
                       tile_height=8, tile_width=64)
    scene, camera = scene_by_name(cfg.scene)
    # host-local jax.Arrays cannot feed a multi-process global shard_map;
    # numpy leaves are accepted as implicitly-replicated inputs
    scene = jax.tree.map(np.asarray, scene)
    camera = jax.tree.map(np.asarray, camera)

    if backend == "grad":
        from cpuperformanceraytracer_tpu.diff.grad import (
            apply_params,
            image_loss,
            render_for_params,
        )
        from cpuperformanceraytracer_tpu.texture.procedural import gradient_sky
        from cpuperformanceraytracer_tpu.texture.texture import (
            texture_from_array,
        )

        cfg = cfg.replace(backend="xla", env_mode="equirect",
                          env_sampling="stochastic")
        tex = texture_from_array(gradient_sky(16, 8))
        tex = tex._replace(r=np.asarray(tex.r), g=np.asarray(tex.g),
                           b=np.asarray(tex.b))
        # px=2*nproc rows-shards x spp=2 sample-shards over the global mesh
        mesh = make_mesh((2 * nproc, 2), ("px", "spp"))
        target = render_for_params({}, scene, camera, tex, cfg, 0)
        target = jax.tree.map(lambda x: np.asarray(x), target)

        albedo = np.stack([scene.materials.albedo.x,
                           scene.materials.albedo.y,
                           scene.materials.albedo.z], -1)
        centers = np.stack([scene.spheres.center.x, scene.spheres.center.y,
                            scene.spheres.center.z], -1)
        params = {"albedo": albedo + 0.05,
                  "sphere_centers": centers + 0.1,
                  "env_rgb": np.stack([tex.r, tex.g, tex.b], -1)}

        def loss_fn(p):
            s, t = apply_params(scene, tex, p)
            img = sharded_render_frame(s, camera, t, cfg, 3, mesh)
            return image_loss(img, target)

        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        print(f"WORKER {pid} LOSS {float(loss):.9f}", flush=True)
        for key in sorted(grads):
            g = np.asarray(grads[key], np.float64)
            print(f"WORKER {pid} GRAD {key} {np.linalg.norm(g):.9f} "
                  f"{g.sum():.9f}", flush=True)
        return 0

    mesh = make_mesh((4 * nproc, 1), ("px", "spp"))

    @jax.jit
    def frame_mean():
        color = sharded_render_frame(scene, camera, None, cfg, 3, mesh)
        return (color.x.mean() + color.y.mean() + color.z.mean()) / 3.0

    mean = float(frame_mean())
    print(f"WORKER {pid} MEAN {mean:.9f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
