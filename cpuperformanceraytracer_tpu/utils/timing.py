"""Monotonic timers + the offline benchmark protocol.

Replaces the reference's QueryPerformanceCounter wrappers (utils.cpp:9-36)
and its offline measurement protocol (Application.cpp:420-452): N warmup
frames, then mean wall-clock ms/frame over M timed frames. On an async
backend like JAX the protocol additionally requires blocking on device
results (block_until_ready) — the device-side analog of the reference's
CompleteAllWork join barrier.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List


class Timer:
    """Context-manager wall-clock timer (monotonic, ns resolution)."""

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self.start
        return False

    @property
    def ms(self) -> float:
        return self.elapsed * 1e3


@dataclass
class FrameTimer:
    """Warmup-then-measure frame timer (Application.cpp:420-452 protocol).

    Measurements are stored as (seconds, frames) spans — a span of 1 frame
    for the per-frame protocol, wider spans for chained dispatch. Means
    and throughput come from the span totals; no synthetic per-frame
    samples are fabricated, so variance/percentile consumers see only
    real measurements (``spans``).
    """

    warmup_frames: int = 2
    _spans: List[tuple] = field(default_factory=list)  # (seconds, frames)
    _seen: int = 0
    _t0: float = 0.0

    def frame_start(self):
        self._t0 = time.perf_counter()

    def frame_end(self):
        dt = time.perf_counter() - self._t0
        self._seen += 1
        if self._seen > self.warmup_frames:
            self._spans.append((dt, 1))

    def add_span(self, seconds: float, frames: int):
        """Record a timed span covering ``frames`` frames (chained-dispatch
        protocol: frames enqueued back-to-back, one join per span)."""
        self._seen += frames
        timed = min(frames, self._seen - self.warmup_frames)
        if timed >= frames:
            self._spans.append((seconds, frames))
        elif timed > 0:
            # span straddles the warmup boundary: attribute a prorated
            # share of the wall time to the timed frames
            self._spans.append((seconds * timed / frames, timed))

    @property
    def spans(self) -> List[tuple]:
        """Real measurements: list of (seconds, frames) spans."""
        return list(self._spans)

    @property
    def timed_frames(self) -> int:
        return sum(n for _, n in self._spans)

    @property
    def mean_ms(self) -> float:
        n = self.timed_frames
        if not n:
            return float("nan")
        return 1e3 * sum(s for s, _ in self._spans) / n

    def rays_per_second(self, rays_per_frame: float) -> float:
        total = sum(s for s, _ in self._spans)
        if not total:
            return float("nan")
        return rays_per_frame * self.timed_frames / total
