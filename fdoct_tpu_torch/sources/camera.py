"""Camera shim: read frames from the native shared-memory ring.

The host-side half of the native acquisition seam (native/fdoct_ring.cpp +
native/capture_daemon.cpp).  Replaces the reference's blocking
GetQHYCCDLiveFrame call (BscanFFT.cpp:948) with a poll of the newest
complete frame in the ring — the daemon owns the camera SDK / V4L2 device,
this process owns the GPU.  Binding is ctypes; no compiled Python extension
needed.

The port's own copy of ``fdoct_tpu/sources/camera.py`` (standard library and
numpy).  It loads the repository's ``native/`` ring library and daemons, as
that module does; :meth:`RingReader.latest_into` writes a frame straight
into caller memory, such as a pinned block of PyTorch's caching host
allocator (:mod:`fdoct_tpu_torch.bench_ingest` phase 5).
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
import time
from pathlib import Path
from typing import Iterator

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"

# control-slot indices in the ring header's control block — must match the
# enum in native/capture_daemon.cpp.  The channel is the live-camera control
# loop: exposure/gain keys land here and the daemon applies them to the
# running device (the reference's SetQHYCCDParam-from-the-key-switch seam,
# BscanFFT.cpp:1600-1624).
CTRL_PARAMS = {"exposure": 0, "gain": 1, "gamma": 2, "fps": 3, "trigger": 4}


def _build_native() -> None:
    subprocess.run(["make", "-C", str(_NATIVE_DIR),
                    "libfdoct_ring.so", "capture_daemon"],
                   check=True, capture_output=True, timeout=120)


def load_ring_lib(build: bool = True) -> ctypes.CDLL:
    so = _NATIVE_DIR / "libfdoct_ring.so"
    if not so.exists():
        if not build:
            raise FileNotFoundError(so)
        _build_native()
    lib = ctypes.CDLL(str(so))
    lib.fdoct_ring_open.restype = ctypes.c_void_p
    lib.fdoct_ring_open.argtypes = [ctypes.c_char_p, ctypes.c_int] + \
        [ctypes.c_uint32] * 4
    lib.fdoct_ring_close.argtypes = [ctypes.c_void_p]
    for name in ("fdoct_ring_width", "fdoct_ring_height", "fdoct_ring_bpp"):
        getattr(lib, name).restype = ctypes.c_uint32
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.fdoct_ring_frame_bytes.restype = ctypes.c_uint64
    lib.fdoct_ring_frame_bytes.argtypes = [ctypes.c_void_p]
    lib.fdoct_ring_push.restype = ctypes.c_uint64
    lib.fdoct_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.fdoct_ring_latest.restype = ctypes.c_uint64
    lib.fdoct_ring_latest.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                      ctypes.c_char_p]
    lib.fdoct_ring_get.restype = ctypes.c_uint64
    lib.fdoct_ring_get.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                   ctypes.c_char_p]
    lib.fdoct_ring_head.restype = ctypes.c_uint64
    lib.fdoct_ring_head.argtypes = [ctypes.c_void_p]
    lib.fdoct_ring_nslots.restype = ctypes.c_uint32
    lib.fdoct_ring_nslots.argtypes = [ctypes.c_void_p]
    lib.fdoct_ring_set_ctrl.restype = None
    lib.fdoct_ring_set_ctrl.argtypes = [ctypes.c_void_p, ctypes.c_uint32,
                                        ctypes.c_double]
    lib.fdoct_ring_get_ctrl.restype = ctypes.c_double
    lib.fdoct_ring_get_ctrl.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
    lib.fdoct_ring_poll_ctrl.restype = ctypes.c_int
    lib.fdoct_ring_poll_ctrl.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_double)]
    lib.fdoct_ring_ctrl_applied.restype = ctypes.c_uint64
    lib.fdoct_ring_ctrl_applied.argtypes = [ctypes.c_void_p]
    lib.fdoct_ring_ctrl_seq.restype = ctypes.c_uint64
    lib.fdoct_ring_ctrl_seq.argtypes = [ctypes.c_void_p]
    lib.fdoct_ring_ctrl_mask.restype = ctypes.c_uint64
    lib.fdoct_ring_ctrl_mask.argtypes = [ctypes.c_void_p]
    lib.fdoct_ring_epoch.restype = ctypes.c_uint64
    lib.fdoct_ring_epoch.argtypes = [ctypes.c_void_p]
    return lib


class RingWriter:
    """In-process writer (used by tests; production uses the daemon)."""

    def __init__(self, path: str | Path, width: int, height: int,
                 bpp: int = 8, nslots: int = 16):
        self.lib = load_ring_lib()
        self.h = self.lib.fdoct_ring_open(str(path).encode(), 1,
                                          width, height, bpp, nslots)
        if not self.h:
            raise OSError(f"cannot create ring at {path}")

    def push(self, frame: np.ndarray) -> int:
        buf = np.ascontiguousarray(frame)
        return self.lib.fdoct_ring_push(
            self.h, buf.ctypes.data_as(ctypes.c_char_p))

    def close(self) -> None:
        if self.h:
            self.lib.fdoct_ring_close(self.h)
            self.h = None


class RingReader:
    """Polling reader over an existing ring."""

    def __init__(self, path: str | Path, timeout_s: float = 10.0):
        self.lib = load_ring_lib()
        deadline = time.monotonic() + timeout_s
        self.h = None
        while time.monotonic() < deadline:
            h = self.lib.fdoct_ring_open(str(path).encode(), 0, 0, 0, 0, 0)
            if h:
                self.h = h
                break
            time.sleep(0.05)
        if not self.h:
            raise TimeoutError(f"ring {path} never appeared")
        self.width = self.lib.fdoct_ring_width(self.h)
        self.height = self.lib.fdoct_ring_height(self.h)
        self.bpp = self.lib.fdoct_ring_bpp(self.h)
        self.frame_bytes = self.lib.fdoct_ring_frame_bytes(self.h)
        self._dtype = np.uint16 if self.bpp > 8 else np.uint8
        self._buf = np.empty(self.frame_bytes, np.uint8)
        self.last_seq = 0
        self.epoch = self.lib.fdoct_ring_epoch(self.h)

    def _poll(self, fetch, ptr, timeout_s: float) -> int:
        """Shared poll skeleton for every read mode: deadline loop, 1 ms
        cadence, and the writer-restart resync.  A restart is detected by
        the header's generation counter changing (v4 epoch field — reliable
        even when the new writer's head races PAST last_seq within one poll
        interval, where the old head-went-backwards rule saw "progress");
        head < last_seq is kept as belt-and-braces for pre-epoch rings.
        ``fetch(head)`` attempts one read into ``ptr`` and returns the
        frame's seq or 0; one implementation of the restart rule so the
        three read modes cannot drift."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            ep = self.lib.fdoct_ring_epoch(self.h)
            if ep != self.epoch:
                self.epoch = ep
                self.last_seq = 0
            head = self.lib.fdoct_ring_head(self.h)
            if head < self.last_seq:
                self.last_seq = 0
            seq = fetch(head)
            if seq:
                # seqlock-style re-verification: a restart landing BETWEEN
                # this iteration's epoch load and the fetch could have
                # raced head past last_seq, making the fetched frame a
                # mid-stream frame of the NEW epoch stitched onto the old
                # sequence — discard and resync instead of returning it
                if self.lib.fdoct_ring_epoch(self.h) != ep:
                    self.epoch = self.lib.fdoct_ring_epoch(self.h)
                    self.last_seq = 0
                    continue
                self.last_seq = seq
                return seq
            time.sleep(0.001)
        return 0

    def _frame(self) -> np.ndarray:
        return self._buf.view(self._dtype).reshape(
            self.height, self.width).copy()

    def latest(self, timeout_s: float = 5.0) -> np.ndarray | None:
        """Newest frame not yet seen; blocks up to timeout (the reference's
        blocking GetQHYCCDLiveFrame role)."""
        ptr = self._buf.ctypes.data_as(ctypes.c_char_p)
        seq = self._poll(
            lambda head: self.lib.fdoct_ring_latest(self.h, self.last_seq,
                                                    ptr),
            ptr, timeout_s)
        return self._frame() if seq else None

    def latest_into(self, out: np.ndarray, timeout_s: float = 5.0) -> bool:
        """Copy the newest unseen frame DIRECTLY into caller memory — one
        memcpy from the shared-memory ring into ``out`` (e.g. a slot of a
        persistent batch buffer that device_put ships as-is), versus
        :meth:`latest`'s ring→scratch→fresh-array two-copy path.  The
        bytes-on-wire are identical (u8 either way); this removes the
        host-side assembly copies on the 500+ fps ingest path
        (scripts/bench_ingest.py section 5).  Returns False on timeout."""
        assert out.dtype == self._dtype and out.nbytes == self.frame_bytes, \
            (out.dtype, out.nbytes, self.frame_bytes)
        assert out.flags["C_CONTIGUOUS"]
        ptr = out.ctypes.data_as(ctypes.c_char_p)
        return bool(self._poll(
            lambda head: self.lib.fdoct_ring_latest(self.h, self.last_seq,
                                                    ptr),
            ptr, timeout_s))

    def next_in_order(self, timeout_s: float = 5.0) -> np.ndarray | None:
        """Oldest frame not yet seen — lossless in-order consumption (for
        triggered capture, where every pulse's frame must be collected;
        the reference's AcquireImages loop likewise takes every triggered
        frame, BscanFFTspinj.cpp:258-347).  Falls forward to the oldest
        still-available frame if the writer lapped this reader."""
        ptr = self._buf.ctypes.data_as(ctypes.c_char_p)
        nslots = self.lib.fdoct_ring_nslots(self.h)

        def fetch(head):
            want = self.last_seq + 1
            if head < want:
                return 0
            if head - want >= nslots:
                want = head - nslots + 1       # lapped: skip to oldest
            return self.lib.fdoct_ring_get(self.h, want, ptr)

        seq = self._poll(fetch, ptr, timeout_s)
        return self._frame() if seq else None

    # --- control channel (host → daemon) --------------------------------
    def set_ctrl(self, param: str | int, value: float) -> None:
        """Write one control parameter for the daemon to apply (the '+'/'-'
        exposure key seam)."""
        pid = CTRL_PARAMS[param] if isinstance(param, str) else int(param)
        self.lib.fdoct_ring_set_ctrl(self.h, pid, float(value))

    def get_ctrl(self, param: str | int) -> float:
        pid = CTRL_PARAMS[param] if isinstance(param, str) else int(param)
        return self.lib.fdoct_ring_get_ctrl(self.h, pid)

    def ctrl_acknowledged(self) -> bool:
        """True when the daemon has applied the latest control snapshot."""
        return (self.lib.fdoct_ring_ctrl_applied(self.h)
                == self.lib.fdoct_ring_ctrl_seq(self.h))

    def trigger(self, n: int = 1) -> None:
        """Fire ``n`` software trigger pulses: bump the CTRL_TRIGGER counter
        the daemon consumes one frame per unit (the GrabNextImageByTrigger
        seam, BscanFFTspinj.cpp:192-230; Spinnaker daemons execute the
        GenICam TriggerSoftware command per pulse)."""
        cur = self.get_ctrl("trigger")
        self.set_ctrl("trigger", cur + n)

    def wait_ctrl_applied(self, timeout_s: float = 2.0) -> bool:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.ctrl_acknowledged():
                return True
            time.sleep(0.002)
        return False

    def close(self) -> None:
        if self.h:
            self.lib.fdoct_ring_close(self.h)
            self.h = None


class CameraSource:
    """FrameSource over a ring, optionally spawning the capture daemon.

    background/pi frames are captured live by averaging (the 'b'/'p' key
    flow) — like real hardware, there is no oracle image to read.

    Failure recovery (the reference has none — its SDK loops
    ``goto failure`` and exit, BscanFFT.cpp:1991-1993): when the ring
    starves and this source owns the daemon, the daemon is restarted up to
    ``max_restarts`` times before giving up.
    """

    def __init__(self, ring_path: str | Path, daemon_args: list[str] | None = None,
                 width: int = 0, height: int = 0, bpp: int = 8,
                 nslots: int = 16, fps: float = 100.0,
                 max_restarts: int = 2, starve_timeout_s: float = 5.0,
                 daemon_exe: str = "capture_daemon",
                 sequential: bool = False, triggered: bool = False,
                 initial_ctrl: dict[str, float] | None = None):
        self.ring_path = ring_path
        self.daemon_args = daemon_args
        self.daemon_exe = daemon_exe
        self.sequential = sequential
        self.triggered = triggered
        self._spawn_spec = (width, height, bpp, nslots, fps)
        self.max_restarts = max_restarts
        self.restarts = 0
        self.starve_timeout_s = starve_timeout_s
        self.proc = None
        # last commanded control values; re-asserted after a daemon restart
        # (a restarted daemon re-creates the ring header, zeroing the
        # control block).  The seqlock assumes a SINGLE control writer;
        # set_param (session thread) and _restart's re-assert (possibly the
        # FrameStreamer producer thread) serialize on this lock.
        self._ctrl_state: dict[str, float] = {}
        self._ctrl_lock = threading.Lock()
        if daemon_args is not None:
            self._spawn()
        try:
            self.reader = RingReader(ring_path)
        except Exception:
            # don't leak a running daemon holding the camera device when
            # the ring never appears (e.g. a slow/failed SDK init)
            if self.proc is not None:
                self.proc.kill()
                self.proc.wait(timeout=5)
            raise
        # seed the control block with the configured initial values so
        # later single-param set_ctrl writes never present the daemon a
        # snapshot whose other slots read 0-meaning-unset
        for name, value in (initial_ctrl or {}).items():
            self.set_param(name, value)

    def _spawn(self) -> None:
        exe = _NATIVE_DIR / self.daemon_exe
        if not exe.exists():
            if self.daemon_exe == "capture_daemon":
                _build_native()
            else:
                # SDK seam daemons (capture_daemon_qhy / _spin) build
                # against stubs/ by default; deployments override
                # SDK_INC/SDK_LIB in native/Makefile for the vendor SDK
                subprocess.run(["make", "-C", str(_NATIVE_DIR),
                                self.daemon_exe],
                               check=True, capture_output=True, timeout=120)
        width, height, bpp, nslots, fps = self._spawn_spec
        cmd = [str(exe), str(self.ring_path), str(width), str(height),
               str(bpp), str(nslots), str(fps)] + self.daemon_args
        self.proc = subprocess.Popen(cmd)

    def _restart(self) -> bool:
        if self.daemon_args is None or self.restarts >= self.max_restarts:
            return False
        self.restarts += 1
        # generation BEFORE the kill: the fresh daemon's header re-create
        # bumps it exactly once (fdoct_ring.cpp v4 epoch), so "epoch moved"
        # is an unmissable reset signal — unlike the old two-phase
        # head/ctrl_applied heuristic, which could miss both transitions
        # when the new daemon finished its memset and first ctrl apply
        # before the first poll sample, and then spun the full deadline
        lib, h = self.reader.lib, self.reader.h
        e0 = lib.fdoct_ring_epoch(h)
        if self.proc is not None:
            self.proc.kill()
            self.proc.wait(timeout=5)
        self._spawn()
        # The ring preserves the control snapshot across a writer re-create
        # (fdoct_ring.cpp), so the restarted daemon re-applies exposure/gain
        # by itself.  Before re-asserting, wait for the header re-create
        # (epoch bump — a re-assert racing the multi-ms memset would be
        # wiped), then for the daemon's startup merge of a preserved
        # snapshot (ctrl_applied nonzero, which the memset zeroed).  When
        # nothing was preserved (fresh ring file: ctrl_seq == 0 after the
        # re-create) there is no merge to wait for — just re-assert.
        if self._ctrl_state:
            deadline = time.monotonic() + 5.0
            seen_reset = False
            while time.monotonic() < deadline:
                if not seen_reset and lib.fdoct_ring_epoch(h) != e0:
                    seen_reset = True
                if seen_reset and (lib.fdoct_ring_ctrl_seq(h) == 0
                                   or lib.fdoct_ring_ctrl_applied(h) != 0):
                    break
                time.sleep(0.005)
            with self._ctrl_lock:
                for name, value in self._ctrl_state.items():
                    self.reader.set_ctrl(name, value)
        return True

    def set_param(self, param: str, value: float) -> None:
        """Session control callback (``Session(camera=src.set_param)``):
        route an exposure/gain/gamma change to the daemon via the ring's
        control block — the working counterpart of the reference's
        SetQHYCCDParam key handlers (BscanFFT.cpp:1600-1624)."""
        if param not in CTRL_PARAMS:
            return  # unknown knobs are ignored, like an SDK without them
        if param == "trigger":
            # the pulse COUNTER is consumable state, not a knob: it must
            # never enter _ctrl_state, or a daemon restart's re-assert
            # would replay the whole cumulative count as spurious pulses.
            # Pulses go through trigger() (a locked read-modify-write).
            return self.trigger(int(value))
        with self._ctrl_lock:
            self._ctrl_state[param] = float(value)
            self.reader.set_ctrl(param, value)

    def trigger(self, n: int = 1) -> None:
        """Fire n software trigger pulses (daemon in --trigger sw/hw mode);
        the session's t/k/| batch-capture handlers call this so triggered
        capture drives the real acquisition seam instead of sampling
        free-running frames (BscanFFTspinj.cpp:1695-1720).

        Under _ctrl_lock: the ring seqlock assumes ONE control writer, and
        RingReader.trigger is a read-modify-write of the pulse counter —
        unlocked it races set_param / _restart's re-assert (a torn seq or
        a lost pulse hangs the triggered capture)."""
        with self._ctrl_lock:
            self.reader.trigger(n)

    def frames(self) -> Iterator[np.ndarray]:
        """Frame iterator with the starvation watchdog.

        In ``triggered`` mode the daemon (by design) emits nothing between
        trigger pulses, so an empty ring is NOT a wedged daemon: instead of
        restarting, the iterator yields ``None`` after a short poll so the
        caller can keep servicing the keys that fire the pulses (an
        always-blocking read here would deadlock the live loop: the 't'
        key that triggers the first frame is only read between frames).
        The daemon-death fast path still applies."""
        poll_s = min(self.starve_timeout_s, 0.05) if self.triggered \
            else self.starve_timeout_s
        while True:
            # watchdog, fast path: daemon exited — restart immediately
            # rather than serving stale ring frames until the starve timeout
            if (self.proc is not None and self.proc.poll() is not None
                    and not self._restart()):
                raise TimeoutError("camera daemon died")
            frame = (self.reader.next_in_order(timeout_s=poll_s)
                     if self.sequential else
                     self.reader.latest(timeout_s=poll_s))
            if frame is None:
                if self.triggered:
                    yield None   # between pulses: idle, not starved
                    continue
                # watchdog, slow path: daemon alive but wedged (no frames)
                if not self._restart():
                    raise TimeoutError("camera ring starved")
                continue
            yield frame

    def background(self) -> np.ndarray:
        raise NotImplementedError("capture via the session 'b' key flow")

    def pi_frame(self) -> np.ndarray:
        raise NotImplementedError("capture via the session 'p' key flow")

    def close(self) -> None:
        self.reader.close()
        if self.proc is not None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=5)
