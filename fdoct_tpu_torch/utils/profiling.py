"""Frame-rate meter and stage timers.

The reference's tracing is a 5-second FPS counter and a max-intensity
readout drawn into its Status window (BscanFFT.cpp:1100-1119); here the
same meter is a small object, plus ``torch.profiler`` for real traces.  The
port's own copy of ``FpsMeter`` and ``StageTimer`` from
``fdoct_tpu/utils/profiling.py``; its ``device_trace`` is that module's
``jax.profiler`` wrapper on ``torch.profiler``.

``StageTimer`` is also the program's span recorder: ``SPANS`` holds the
spans and counters that :func:`span` and :func:`count` record while a
``torch.profiler`` session runs, and nothing otherwise.  The profiler
session is the only switch.  Each span is also a host event of the
profiler's trace, ``fdoct.<name>``, on the profiler's clock; it adds no
event on the device.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from pathlib import Path

import torch.autograd.profiler as _autograd_profiler


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
    the reference has no per-stage instrumentation).  Stages nest per
    thread: each name keeps the parent it was first entered under and its
    self time, its duration less what its child stages cover.  ``add``
    keeps counters beside them."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}
        self.selfs: dict[str, float] = {}
        self.parents: dict[str, str | None] = {}
        self.counters: dict[str, int] = {}
        self._lock = threading.Lock()
        self._local = threading.local()

    @contextlib.contextmanager
    def stage(self, name: str):
        stack = self._local.__dict__.setdefault("stack", [])
        parent = stack[-1][0] if stack else None
        frame = [name, 0.0]                       # the name, its children's seconds
        stack.append(frame)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            stack.pop()
            if stack:
                stack[-1][1] += dt
            with self._lock:
                self.totals[name] = self.totals.get(name, 0.0) + dt
                self.counts[name] = self.counts.get(name, 0) + 1
                self.selfs[name] = self.selfs.get(name, 0.0) + dt - frame[1]
                self.parents.setdefault(name, parent)

    def add(self, name: str, n: int) -> None:
        """Add ``n`` to counter ``name``."""
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def snapshot(self) -> dict:
        """``{"spans": {name: {"count", "total_s", "self_s", "parent"}},
        "counters": {name: n}}``, a copy."""
        with self._lock:
            return {"spans": {k: {"count": self.counts[k], "total_s": self.totals[k],
                                  "self_s": self.selfs[k], "parent": self.parents[k]}
                              for k in self.totals},
                    "counters": dict(self.counters)}

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:24s} {tot:8.3f}s total {tot / n * 1e3:8.2f}ms avg x{n}")
        return "\n".join(lines)


#: the program's spans and counters, recorded while a profiler session runs
SPANS = StageTimer()
#: the prefix of the spans' events in the profiler's trace
EVENT_PREFIX = "fdoct."
_OFF = contextlib.nullcontext()


def tracing() -> bool:
    """Whether a ``torch.profiler`` session runs, so that spans record."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str):
    """A context that records stage ``name`` in :data:`SPANS` and as the
    host event ``fdoct.<name>`` of the profiler's trace while a profiler
    session runs; otherwise one shared context that does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _recorded(name)


@contextlib.contextmanager
def _recorded(name: str):
    # _RecordFunctionFast opens a host operation, not a user annotation: the
    # profiler mirrors user annotations onto the device's timeline
    from torch._C._profiler import _RecordFunctionFast
    with _RecordFunctionFast(EVENT_PREFIX + name), SPANS.stage(name):
        yield


def count(name: str, n: int) -> None:
    """Add ``n`` to counter ``name`` of :data:`SPANS` while a profiler
    session runs."""
    if _autograd_profiler._is_profiler_enabled:
        SPANS.add(name, n)


@contextlib.contextmanager
def device_trace(logdir: str | Path):
    """``torch.profiler`` over the enclosed work, the host's activity and,
    where PyTorch sees a card, the device's; written into ``logdir`` (made if
    missing) as a Chrome trace, ``trace_<pid>_<unix ms>.json``, when the block
    ends, on an exception too (open with Perfetto or chrome://tracing).
    Yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / f"trace_{os.getpid()}_{int(time.time() * 1e3)}.json"))
