"""Profiler integration + throughput accounting.

The analog of the reference's QPC-based profiling machinery and
PERFORMANCE_PROFILING_BUILD flag (SURVEY.md section 5): a context
manager around jax.profiler for XProf traces, plus a roofline-style
throughput report (rays/s, segments/s, bytes/frame) from the same
counters the bench uses.
"""

from __future__ import annotations

import contextlib
import dataclasses

from cpuperformanceraytracer_tpu.config import RenderConfig


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/cprt_trace"):
    """Capture a jax.profiler trace for the enclosed block (view with
    xprof/tensorboard)."""
    import jax

    with jax.profiler.trace(log_dir):
        yield log_dir


@dataclasses.dataclass
class ThroughputReport:
    ms_per_frame: float
    primary_mrays_per_s: float
    max_segment_mrays_per_s: float
    accum_bytes_per_frame: int

    def __str__(self) -> str:
        return (
            f"{self.ms_per_frame:.3f} ms/frame | "
            f"{self.primary_mrays_per_s:.1f} Mray/s primary | "
            f"<= {self.max_segment_mrays_per_s:.1f} Mray/s segments | "
            f"{self.accum_bytes_per_frame / 1e6:.1f} MB accum traffic"
        )


def throughput_report(cfg: RenderConfig, ms_per_frame: float) -> ThroughputReport:
    """Rays/s accounting from the workload shape (derivations mirror
    BASELINE.md 'rays per frame')."""
    primary = cfg.width * cfg.height * cfg.spp
    segments = primary * (cfg.bounces + 1)  # upper bound (miss/RR terminate)
    s = ms_per_frame / 1e3
    return ThroughputReport(
        ms_per_frame=ms_per_frame,
        primary_mrays_per_s=primary / s / 1e6,
        max_segment_mrays_per_s=segments / s / 1e6,
        accum_bytes_per_frame=cfg.width * cfg.height * 3 * 4 * 2,  # r+w f32
    )
