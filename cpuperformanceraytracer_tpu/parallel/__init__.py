"""Parallel layer: device mesh + shard_map sharding of the frame function.

The replacement for the reference's L3 scheduling layer
(work_queue.{h,cpp} + the v4 private clone): the dynamic 150-tile
semaphore ring queue becomes STATIC SPMD sharding over a
``jax.sharding.Mesh`` — no queue, no load balancing, because every
pixel-row shard costs the same by construction and XLA collectives
(psum) replace the interlocked completion counter
(SURVEY.md section 2.3 mapping table).

Mesh axes:
  "px"  — data parallelism over pixels (rows of the flat pixel array);
          the analog of the reference's tile-level thread parallelism.
  "spp" — sample parallelism: each shard renders an spp slice with
          counter-RNG sample offsets, reduced with psum. The analog of
          the reference's sequential frame accumulation, parallelized.
TP/PP/EP have no geometry here (no model weights; SURVEY.md 2.3): the
closest analogs (env-map sharding, render/post pipeline, branch routing)
are documented where they live.
"""

from cpuperformanceraytracer_tpu.parallel.mesh import (  # noqa: F401
    make_mesh,
    default_mesh,
)
from cpuperformanceraytracer_tpu.parallel.shard import (  # noqa: F401
    make_sharded_frame_fn,
    sharded_render_frame,
)
