"""The device trace of a steady stretch of the window, reduced to numbers.

``torch.profiler`` records the stretch; the harness marks each unit of
work (a volume) with a ``record_function`` span named
``oct_bench.<unit>``.  The traced window runs from the first such span's
start to the last one's end.  The reductions are copies of
``chip_smoke.py``'s ``union_us`` and ``device_breakdown`` (busy = the union
of the kernel and copy intervals; idle share = 1 − busy / window; H2D =
the sum of the ``Memcpy HtoD`` intervals).
"""

from __future__ import annotations

import collections

#: the prefix of the harness's own spans
SPAN_PREFIX = "oct_bench."
#: entries of each list of the result line's ``breakdown``
TOP = 10


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def merged(intervals) -> list[tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy")


class Profiler:
    """``torch.profiler`` over a stretch of units, started and stopped by the
    traffic generator between units."""

    def __init__(self, unit: str, device):
        self.unit = unit
        self.cuda = device.type == "cuda"
        self.prof = None
        self.summary: dict | None = None

    def _profile(self):
        from torch.profiler import ProfilerActivity, profile
        return profile(activities=[ProfilerActivity.CPU]
                       + ([ProfilerActivity.CUDA] if self.cuda else []))

    def warm(self, device) -> None:
        """A first profiler session over one small operation, in set-up: the
        first session of a process loses most of its events (seen on the
        CPU and on the card), and starting the device tracing stalls the
        host for some 200 ms."""
        import torch
        with self._profile() as p:
            torch.ones(8, device=device).sum()
        p.events()

    def start(self) -> None:
        self.prof = self._profile()
        self.prof.start()

    @property
    def on(self) -> bool:
        return self.prof is not None and self.summary is None

    def span(self):
        from torch.profiler import record_function
        return record_function(SPAN_PREFIX + self.unit)

    def stop(self) -> None:
        import torch
        if self.cuda:
            torch.cuda.synchronize()
        self.prof.stop()
        self.summary = summarize(self.prof.events(), SPAN_PREFIX + self.unit)
        self.prof = None


def summarize(events, span_name: str) -> dict:
    """Reduce profiler events to the traced window's numbers: the window
    (first span start to last span end), the units in it, the device's
    busy time (union of every kernel and copy interval), the kernels' and
    the copies' summed times, the device operations that took most time and
    the longest idle gaps, each named by the innermost host operation that
    ran across its middle."""
    from torch.autograd import DeviceType
    device, host, spans = [], [], []
    for e in events:
        tr = (e.time_range.start, e.time_range.end)
        if e.name.startswith(SPAN_PREFIX):
            if e.name == span_name and e.device_type == DeviceType.CPU:
                spans.append(tr)
        elif e.device_type == DeviceType.CUDA:
            device.append((e.name, *tr))
        else:
            host.append((e.name, *tr))
    if not spans:
        return {"units": 0}
    w0, w1 = min(s for s, _ in spans), max(e for _, e in spans)
    inside = [(n, max(s, w0), min(e, w1)) for n, s, e in device if e > w0 and s < w1]
    busy = merged([(s, e) for _, s, e in inside])
    by_name: dict[str, float] = collections.defaultdict(float)
    for n, s, e in inside:
        by_name[n] += e - s
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]), reverse=True)
    return {
        "units": len(spans),
        "window_us": w1 - w0,
        "busy_us": union_us((s, e) for _, s, e in inside),
        "kernel_us": sum(e - s for n, s, e in inside if not is_copy(n)),
        "h2d_us": sum(e - s for n, s, e in inside if n.startswith("Memcpy HtoD")),
        "d2h_us": sum(e - s for n, s, e in inside if n.startswith("Memcpy DtoH")),
        "device_ops": [[n[:200], t / 1e6] for n, t in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[_host_at(host, spans, (a + b) / 2), d / 1e6] for d, a, b in gaps[:TOP]],
    }


def _host_at(host, spans, t: float) -> str:
    """The innermost host operation running at ``t``; else whether ``t`` lies
    inside or outside the harness's unit spans."""
    best = None
    for n, s, e in host:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (n, e - s)
    if best is not None:
        return best[0][:200]
    inside = any(s <= t <= e for s, e in spans)
    return "inside the unit, no profiled host op" if inside else "outside the unit's span"
