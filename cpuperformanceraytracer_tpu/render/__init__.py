"""Render layer: per-ray integrator, frame orchestration, offline driver.

The integrator is written once, per-ray, and serves as BOTH the JAX-CPU
parity oracle (run un-jitted / on CPU) and the production XLA path
(vmapped + jitted on the GPU) — the same trick the reference used by keeping
the scalar kernel as executable ground truth for the SIMD ladder
(SURVEY.md section 4), except here the two share one source of truth by
construction.
"""

from cpuperformanceraytracer_tpu.render.integrator import (  # noqa: F401
    Hit,
    MaterialSample,
    trace_scene,
    color_for_ray,
    camera_ray,
    render_pixel,
)
from cpuperformanceraytracer_tpu.render.frame import (  # noqa: F401
    render_frame,
    accumulate_frame,
    postprocess_image,
    make_frame_fn,
)
from cpuperformanceraytracer_tpu.render.driver import (  # noqa: F401
    RenderState,
    OfflineRenderer,
)
