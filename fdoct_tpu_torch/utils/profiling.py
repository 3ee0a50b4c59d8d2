"""Frame-rate meter and stage timers.

The reference's tracing is a 5-second FPS counter and a max-intensity
readout drawn into its Status window (BscanFFT.cpp:1100-1119); here the
same meter is a small object.  The port's own copy of ``FpsMeter`` and
``StageTimer`` from ``fdoct_tpu/utils/profiling.py`` (standard library
only); that module's ``device_trace`` wraps ``jax.profiler`` and has no
counterpart here yet.
"""

from __future__ import annotations

import contextlib
import time


class FpsMeter:
    """Frames/s over a sliding window (reference: 5 s window)."""

    def __init__(self, window_s: float = 5.0):
        self.window_s = window_s
        self._count = 0
        self._t0 = time.monotonic()
        self.fps = 0.0

    def tick(self, n: int = 1) -> float | None:
        """Count n frames; returns the fps reading each time a window
        completes (else None)."""
        self._count += n
        dt = time.monotonic() - self._t0
        if dt >= self.window_s:
            self.fps = self._count / dt
            self._count = 0
            self._t0 = time.monotonic()
            return self.fps
        return None


class StageTimer:
    """Accumulating per-stage wall-clock timers (no reference equivalent —
    the reference has no per-stage instrumentation)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {tot:8.3f}s total {tot / n * 1e3:8.2f}ms avg x{n}")
        return "\n".join(lines)
