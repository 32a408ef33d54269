"""Fused Pallas kernels, compiled for the GPU through Triton.

The path-tracing kernel is the analog of the reference's RenderTile →
mainImage → GetColorForRay hot path (SURVEY.md section 3.1): one fused
program per pixel block keeps the ~25 live per-ray values in registers
for the whole bounce loop instead of writing (P,)-sized state to device
memory between XLA loop iterations.
"""

from cpuperformanceraytracer_tpu.kernels.megakernel import (  # noqa: F401
    render_frame_pallas,
)
