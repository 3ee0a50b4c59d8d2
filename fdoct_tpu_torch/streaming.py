"""High-rate streaming: a host→device input pipeline that overlaps the copy
of the next batch with the compute of the current one.

The port of ``fdoct_tpu/streaming.py``.  A producer thread (camera ring,
replay, synthetic) fills a bounded queue; the consumer assembles batches,
copies batch N+1 to the device while batch N computes, and never blocks the
device on the host.  The JAX package gets the overlap from its asynchronous
``device_put``; here it is explicit:

- on a CUDA device each batch is written straight into a page-locked
  (pinned) host slot of a small ring as its frames are dequeued (one host
  copy, as ``np.stack`` costs), then copied with ``non_blocking=True`` on a
  side copy stream;
- the compute stream waits on the copy's event just before the step reads
  the batch, and ``record_stream`` keeps the caching allocator from handing
  the device buffer to the next copy while the step still reads it;
- a slot is refilled only after its last copy's event has completed.

On the CPU the same loop runs with plain tensors and no streams: the device
given decides the route.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterator

import numpy as np
import torch

#: pinned host slots in the ring of a CUDA run: the batch being stepped, the
#: next one (copy in flight) and one more being filled
PINNED_SLOTS = 3
_END = object()


@dataclass
class StreamStats:
    frames_in: int = 0
    batches_done: int = 0
    dropped: int = 0
    t_start: float = field(default_factory=time.monotonic)

    @property
    def fps(self) -> float:
        dt = time.monotonic() - self.t_start
        return self.frames_in / dt if dt > 0 else 0.0


class FrameStreamer:
    """Producer thread feeding a bounded frame queue.

    ``drop_oldest=True`` gives live-camera semantics (newest frame wins,
    like polling fdoct_ring's latest); False gives lossless replay
    semantics (producer blocks on backpressure).  ``rate_fps`` paces the
    producer; a ``None`` from the source (a triggered camera idling between
    pulses) is skipped.
    """

    def __init__(self, source_frames: Iterator[np.ndarray],
                 maxsize: int = 64, drop_oldest: bool = False,
                 rate_fps: float | None = None):
        self._it = source_frames
        self.q: queue.Queue = queue.Queue(maxsize=maxsize)
        self.drop_oldest = drop_oldest
        self.rate_fps = rate_fps
        self.stats = StreamStats()
        self.error: BaseException | None = None   # producer death, surfaced
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "FrameStreamer":
        self._thread.start()
        return self

    def _run(self) -> None:
        # paced before the source is asked for a frame (the JAX class sleeps
        # after taking it), so a frame is queued as soon as it is taken and
        # its age in the queue is the consumer's
        period = 1.0 / self.rate_fps if self.rate_fps else 0.0
        next_t = time.monotonic()
        it = iter(self._it)
        try:
            while not self._stop.is_set():
                delay = next_t - time.monotonic()
                if period and delay > 0 and self._stop.wait(delay):
                    break
                frame = next(it, _END)
                if frame is _END:
                    break
                if frame is None:
                    continue
                next_t += period
                while True:
                    try:
                        self.q.put_nowait(frame)
                        self.stats.frames_in += 1
                        break
                    except queue.Full:
                        if self.drop_oldest:
                            try:
                                self.q.get_nowait()
                                self.stats.dropped += 1
                            except queue.Empty:
                                pass
                        elif self._stop.wait(0.001):
                            return
        except BaseException as e:   # a dead source must not look like EOF
            self.error = e

    def ready(self, n: int) -> bool:
        """Whether :meth:`get_batch` of ``n`` would return without waiting
        for the source: ``n`` frames are queued, or the producer has ended."""
        return self.q.qsize() >= n or self.error is not None or not self._thread.is_alive()

    def get_batch(self, n: int, timeout_s: float = 10.0,
                  out: Callable[[np.ndarray], np.ndarray] | None = None) -> np.ndarray | None:
        """Up to ``n`` frames (a short final batch when the producer ended
        with frames still queued); None on a clean end with nothing queued.
        Re-raises the producer's exception (e.g. the camera watchdog's
        TimeoutError) instead of masking it as a silent timeout.

        ``out``, given the batch's first frame, returns the array the batch
        is written into (``n`` frames of that frame's shape and dtype, e.g.
        a pinned slot); each frame is copied there as it is dequeued and the
        filled rows are returned.  Without it the frames are stacked."""
        frames: list[np.ndarray] = []
        buf = None
        k = 0
        deadline = time.monotonic() + timeout_s
        while k < n:
            try:
                frame = self.q.get(timeout=min(0.2, max(0.0, deadline - time.monotonic())))
            except queue.Empty:
                if self.error is not None:
                    raise self.error
                if not self._thread.is_alive() or time.monotonic() >= deadline:
                    break
                continue
            if out is None:
                frames.append(frame)
            else:
                if buf is None:
                    buf = out(frame)
                np.copyto(buf[k], frame)
            k += 1
        if k == 0:
            return None
        return np.stack(frames) if out is None else buf[:k]

    def stop(self, join_timeout_s: float = 10.0) -> None:
        """Signal the producer and wait for it to exit, so the caller can
        safely close the frame source (the ring mmap) afterwards."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=join_timeout_s)


class _PinnedRing:
    """``PINNED_SLOTS`` page-locked batch buffers, each with the event of its
    last copy to the device.  Allocated once, on the first frame (pinning
    costs milliseconds), and again only if the frames change shape or type."""

    def __init__(self, batch: int):
        self.batch = batch
        self.key: tuple | None = None
        self.slots: list[torch.Tensor] = []
        self.views: list[np.ndarray] = []
        self.events = [torch.cuda.Event() for _ in range(PINNED_SLOTS)]
        self.used = [False] * PINNED_SLOTS
        self.i = -1

    def take(self, frame: np.ndarray) -> np.ndarray:
        """The next slot as a numpy view, once its last copy has completed."""
        key = (frame.shape, frame.dtype)
        if key != self.key:
            for ev, used in zip(self.events, self.used):
                if used:
                    ev.synchronize()
            host = np.empty((PINNED_SLOTS, self.batch, *frame.shape), frame.dtype)
            self.slots = list(torch.from_numpy(host).pin_memory())
            self.views = [s.numpy() for s in self.slots]
            self.key = key
        if self.used[self.i]:
            self.events[self.i].synchronize()    # never refill a slot under copy
        return self.views[self.i]


class _Feed:
    """Host batches → device batches for :func:`run_streaming`."""

    def __init__(self, streamer: FrameStreamer, batch: int, device: torch.device,
                 put: Callable | None):
        self.streamer = streamer
        self.batch = batch
        self.device = device
        self.put = put
        self.pinned = put is None and device.type == "cuda"
        if self.pinned:
            self.ring = _PinnedRing(batch)
            self.copy_stream = torch.cuda.Stream(device)
            self.compute = torch.cuda.current_stream(device)

    def next(self) -> tuple[torch.Tensor, torch.cuda.Event | None] | None:
        """The next batch on the device, its copy issued; None at the end."""
        if not self.pinned:
            host = self.streamer.get_batch(self.batch)
            if host is None:
                return None
            if self.put is not None:
                return self.put(host), None
            return torch.as_tensor(host).to(self.device), None
        ring = self.ring
        ring.i = (ring.i + 1) % PINNED_SLOTS
        host = self.streamer.get_batch(self.batch, out=ring.take)
        if host is None:
            return None
        i, k = ring.i, len(host)
        with torch.cuda.stream(self.copy_stream):
            dev = ring.slots[i][:k].to(self.device, non_blocking=True)
            ring.events[i].record(self.copy_stream)
        ring.used[i] = True
        return dev, ring.events[i]

    def ready(self, item: tuple[torch.Tensor, torch.cuda.Event | None]) -> torch.Tensor:
        """The batch, once the compute stream waits on its copy."""
        dev, ev = item
        if ev is not None:
            self.compute.wait_event(ev)
            dev.record_stream(self.compute)
        return dev


def run_streaming(
    source_frames: Iterator[np.ndarray],
    step: Callable,                  # (frames on ``device``) -> result
    batch: int,
    n_batches: int,
    *,
    device: torch.device | str,
    rate_fps: float | None = None,
    drop_oldest: bool = False,
    put: Callable | None = None,
    sharding=None,
) -> tuple[list, StreamStats]:
    """Pump up to ``n_batches`` batches of ``batch`` frames through ``step``
    with transfer/compute overlap; returns (results, stats), ``stats.fps``
    the end-to-end ingest rate.

    Two-deep pipeline: when batch N+1 is queued by the time batch N is
    ready to step, its copy is issued before step N runs, so it overlaps
    step N's kernels.  When it is not (the source is slower than the
    device), step N runs at once rather than hold its result until the next
    batch arrives.  As in the JAX package, a result is appended once it is
    complete: each step's work is waited for (a CUDA event on the compute
    stream) after the next step has been issued, the last before returning.

    ``device`` is where the step's frames go (required; on CUDA through the
    pinned ring and a side copy stream, see the module docstring).  ``put``
    overrides the placement, ``put(host_batch) -> frames on the device``,
    with host batches stacked by numpy.  ``sharding`` (a device mesh) is not
    ported yet.
    """
    if sharding is not None:
        raise NotImplementedError("run_streaming(sharding=...) is not ported to "
                                  "fdoct_tpu_torch yet (ROADMAP Queue 1 item 12)")
    device = torch.device(device)
    streamer = FrameStreamer(source_frames, maxsize=4 * batch,
                             drop_oldest=drop_oldest, rate_fps=rate_fps).start()
    feed = _Feed(streamer, batch, device, put)
    results: list = []
    inflight = None                  # (result, event) of the step before
    taken = 0
    try:
        nxt = feed.next() if n_batches > 0 else None
        taken += nxt is not None
        while nxt is not None:
            cur, nxt = nxt, None
            if taken < n_batches and streamer.ready(batch):
                nxt = feed.next()            # batch N+1's copy before step N
                taken += nxt is not None
            out = step(feed.ready(cur))
            done = None
            if device.type == "cuda":
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(device))
            if inflight is not None:
                _complete(inflight, results)
            inflight = (out, done)
            if nxt is None and taken < n_batches:
                nxt = feed.next()
                taken += nxt is not None
        if inflight is not None:
            _complete(inflight, results)
        streamer.stats.batches_done = len(results)
        return results, streamer.stats
    finally:
        streamer.stop()


def _complete(inflight: tuple, results: list) -> None:
    out, done = inflight
    if done is not None:
        done.synchronize()
    results.append(out)
