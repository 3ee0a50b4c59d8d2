"""The port's camera source (``fdoct_tpu_torch/sources/camera.py``), a copy
of ``fdoct_tpu/sources/camera.py`` over the repository's ``native/`` ring
and capture daemon: the copy pinned to its original, the ring and its
control channel, the daemon's exposure/gain loop driven by the port's
``Session`` keys, the watchdog restart, 16-bit frames, ``latest_into``
(into a pinned-ring slot's numpy view) and the trigger counter, modelled on
tests/test_camera_control.py and tests/test_native.py.  The two packages
share one ring format: a frame pushed by either's writer reads back
byte-equal through the other's reader.

The cases that run the native code skip without a C++ toolchain and
without prebuilt binaries, as tests/test_camera_control.py does.
"""

import ast
import ctypes
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
NATIVE = ROOT / "native"
HAVE_NATIVE = shutil.which("g++") is not None or (
    (NATIVE / "libfdoct_ring.so").exists() and (NATIVE / "capture_daemon").exists())
native = pytest.mark.skipif(not HAVE_NATIVE, reason="no C++ toolchain and no native binaries")


@pytest.fixture(scope="module")
def build():
    if shutil.which("g++") is not None:
        subprocess.run(["make", "-C", str(NATIVE), "libfdoct_ring.so", "capture_daemon"],
                       check=True, capture_output=True, timeout=180)


def _mean_of_next_frames(it, n=3, skip=2):
    """Mean brightness over the next n frames, skipping frames possibly
    generated before a control change landed."""
    for _ in range(skip):
        next(it)
    return float(np.mean([next(it).mean() for _ in range(n)]))


def test_native_dir_is_the_repos():
    """The port's file sits at the same depth as the JAX one, so
    ``parents[2]`` reaches the repository's native/ from both."""
    from fdoct_tpu.sources import camera as jcam
    from fdoct_tpu_torch.sources import camera as tcam
    assert tcam._NATIVE_DIR == NATIVE.resolve() == jcam._NATIVE_DIR
    assert (tcam._NATIVE_DIR / "fdoct_ring.cpp").exists()


def test_port_camera_is_a_copy_of_the_jax_module():
    """Below its docstring the port's module is the JAX module's code, and
    it imports only the standard library and numpy."""
    def body(path):
        tree = ast.parse(path.read_text())
        tree.body = tree.body[1:]                        # the module docstring
        return ast.dump(tree)

    port = ROOT / "fdoct_tpu_torch" / "sources" / "camera.py"
    assert body(port) == body(ROOT / "fdoct_tpu" / "sources" / "camera.py")
    mods = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import) else n.module.split(".")[0]
            for n in ast.walk(ast.parse(port.read_text()))
            if isinstance(n, (ast.Import, ast.ImportFrom))}
    assert mods <= {"__future__", "ctypes", "subprocess", "threading", "time", "pathlib",
                    "typing", "numpy"}, mods


def test_camera_source_is_exported():
    from fdoct_tpu_torch.sources import CameraSource
    from fdoct_tpu_torch.sources.camera import CameraSource as C
    assert CameraSource is C


@native
def test_ring_ctrl_roundtrip(tmp_path, build):
    """Host writes land in the control block; a poll consumes exactly one
    snapshot and acknowledges it."""
    from fdoct_tpu_torch.sources.camera import RingReader, RingWriter

    path = tmp_path / "ring.bin"
    w = RingWriter(path, 16, 8, nslots=4)
    r = RingReader(path)
    try:
        assert r.ctrl_acknowledged()
        r.set_ctrl("exposure", 2500.0)
        r.set_ctrl("gain", 7.0)
        assert r.get_ctrl("exposure") == 2500.0 and not r.ctrl_acknowledged()
        vals = (ctypes.c_double * 8)()
        assert w.lib.fdoct_ring_poll_ctrl(w.h, vals) == 1
        assert vals[0] == 2500.0 and vals[1] == 7.0 and r.ctrl_acknowledged()
        assert w.lib.fdoct_ring_poll_ctrl(w.h, vals) == 0
    finally:
        w.close()
        r.close()


@native
@pytest.mark.parametrize("writer_pkg,bpp", [("fdoct_tpu_torch", 8), ("fdoct_tpu", 8),
                                            ("fdoct_tpu_torch", 16)])
def test_ring_frames_cross_packages(tmp_path, build, writer_pkg, bpp):
    """Frames pushed by one package's writer read back byte-equal through
    the other's reader (latest, next_in_order, latest_into), wrapping."""
    import importlib
    reader_pkg = "fdoct_tpu" if writer_pkg == "fdoct_tpu_torch" else "fdoct_tpu_torch"
    W = importlib.import_module(f"{writer_pkg}.sources.camera").RingWriter
    R = importlib.import_module(f"{reader_pkg}.sources.camera").RingReader
    dtype = np.uint16 if bpp > 8 else np.uint8
    rng = np.random.default_rng(bpp)
    frames = rng.integers(0, np.iinfo(dtype).max, (7, 8, 32)).astype(dtype)
    path = tmp_path / "x.ring"
    w = W(path, 32, 8, bpp=bpp, nslots=4)
    latest, ordered = R(path), R(path)
    try:
        out = np.empty((8, 32), dtype)
        for k, f in enumerate(frames):
            w.push(f)
            np.testing.assert_array_equal(ordered.next_in_order(timeout_s=2.0), f)
            if k % 2:
                np.testing.assert_array_equal(latest.latest(timeout_s=2.0), f)
            else:
                assert latest.latest_into(out, timeout_s=2.0)
                np.testing.assert_array_equal(out, f)
        assert latest.latest(timeout_s=0.05) is None             # nothing new
    finally:
        w.close()
        latest.close()
        ordered.close()


@native
def test_latest_into_writes_a_pinned_slot_view(tmp_path, build):
    """latest_into fills the rows of a batch buffer in place, as it fills a
    pinned block of the caching host allocator (its numpy view), and rejects
    a buffer of another type."""
    from fdoct_tpu_torch.sources.camera import RingReader, RingWriter

    path = tmp_path / "zc.ring"
    w = RingWriter(path, 32, 8, nslots=4)
    r = RingReader(path)
    try:
        slot = torch.zeros((3, 8, 32), dtype=torch.uint8).numpy()   # a pinned block's view
        frames = np.arange(3 * 256, dtype=np.uint16).reshape(3, 8, 32).astype(np.uint8)
        for k, f in enumerate(frames):
            w.push(f)
            assert r.latest_into(slot[k], timeout_s=2.0)
        np.testing.assert_array_equal(slot, frames)
        with pytest.raises(AssertionError):
            r.latest_into(np.empty((8, 32), np.uint16))
    finally:
        w.close()
        r.close()


@native
def test_daemon_applies_exposure_and_gain(tmp_path, build):
    from fdoct_tpu_torch.sources.camera import CameraSource

    src = CameraSource(tmp_path / "cam.ring", daemon_args=["--synthetic"],
                       width=64, height=16, fps=500.0)
    try:
        it = iter(src.frames())
        bright = _mean_of_next_frames(it)
        src.set_param("exposure", 250.0)
        assert src.reader.wait_ctrl_applied(timeout_s=5.0)
        dim = _mean_of_next_frames(it)
        assert dim < bright * 0.5, (bright, dim)
        src.set_param("gain", 300.0)
        assert src.reader.wait_ctrl_applied(timeout_s=5.0)
        assert _mean_of_next_frames(it) > dim * 1.5
    finally:
        src.close()
    assert src.proc.poll() is not None                    # the daemon stopped


@native
@pytest.mark.parametrize("bpp", [8, 16])
def test_session_keys_drive_the_camera(tmp_path, build, bpp):
    """The port's Session on the CPU fed by the ring: a full group
    reconstructs from the daemon's frames, and the '+' keys brighten the
    following frames through the control loop (BscanFFT.cpp:1600)."""
    from fdoct_tpu_torch.config import PipelineConfig
    from fdoct_tpu_torch.session import Session
    from fdoct_tpu_torch.sources.camera import CameraSource

    cfg = PipelineConfig(width=64, height=16, bpp=bpp, averages=2, numfftpoints=128,
                         numdisplaypoints=64, exposure_us=500)
    src = CameraSource(tmp_path / f"cam{bpp}.ring", daemon_args=["--synthetic"],
                       width=64, height=16, bpp=bpp, fps=500.0,
                       initial_ctrl={"exposure": 500.0, "gain": 0.0})
    try:
        s = Session(cfg, device="cpu", camera=src.set_param)
        assert src.reader.wait_ctrl_applied(5.0)
        it = iter(src.frames())
        frame = next(it)
        assert frame.dtype == (np.uint16 if bpp > 8 else np.uint8) and frame.shape == (16, 64)
        before = _mean_of_next_frames(it)
        results = [r for _ in range(2) if (r := s.process(next(it))) is not None]
        assert len(results) == 1 and results[0].bscandisp.shape == (64, 16)
        for _ in range(5):
            s.key("+")
        assert s.exposure_us == 1000
        assert src.reader.wait_ctrl_applied(5.0)
        assert _mean_of_next_frames(it) > before * 1.5
    finally:
        src.close()


@native
def test_ctrl_survives_daemon_restart(tmp_path, build):
    from fdoct_tpu_torch.sources.camera import CameraSource

    src = CameraSource(tmp_path / "cam3.ring", daemon_args=["--synthetic"],
                       width=64, height=16, fps=500.0, starve_timeout_s=2.0)
    try:
        it = iter(src.frames())
        src.set_param("exposure", 250.0)
        assert src.reader.wait_ctrl_applied(5.0)
        dim = _mean_of_next_frames(it)
        src.proc.kill()
        src.proc.wait(timeout=5)
        assert next(it) is not None and src.restarts == 1
        assert src.reader.wait_ctrl_applied(5.0)
        assert _mean_of_next_frames(it) < dim * 2.0 + 2.0
        assert src.reader.get_ctrl("exposure") == 250.0
    finally:
        src.close()


@native
def test_dead_daemon_past_restarts_raises(tmp_path, build):
    from fdoct_tpu_torch.sources.camera import CameraSource

    src = CameraSource(tmp_path / "dead.ring", daemon_args=["--synthetic"], width=64,
                       height=16, fps=500.0, max_restarts=0, starve_timeout_s=1.0)
    try:
        src.proc.kill()
        src.proc.wait(timeout=5)
        with pytest.raises(TimeoutError, match="daemon died"):
            next(iter(src.frames()))
    finally:
        src.close()


@native
def test_set_param_trigger_never_reasserted(tmp_path, build):
    from fdoct_tpu_torch.sources.camera import CameraSource, RingWriter

    ring = tmp_path / "trigring"
    w = RingWriter(ring, 16, 8)
    try:
        src = CameraSource(ring, daemon_args=None, starve_timeout_s=0.5)
        try:
            src.set_param("exposure", 123)
            src.set_param("trigger", 3)
            assert "trigger" not in src._ctrl_state and src._ctrl_state["exposure"] == 123
            assert src.reader.get_ctrl("trigger") == 3
            src.set_param("trigger", 2)
            assert src.reader.get_ctrl("trigger") == 5
        finally:
            src.close()
    finally:
        w.close()


@native
def test_triggered_source_idles_then_yields(tmp_path, build):
    """A triggered daemon emits one frame per software pulse and the source
    yields None between pulses (the live loop's keys fire them)."""
    from fdoct_tpu_torch.sources.camera import CameraSource

    src = CameraSource(tmp_path / "trig.ring", daemon_args=["--synthetic", "--trigger", "sw"],
                       width=64, height=16, fps=500.0, sequential=True, triggered=True)
    try:
        it = iter(src.frames())
        assert next(it) is None                              # no pulse yet
        src.trigger(2)
        got, deadline = [], time.monotonic() + 10
        while len(got) < 2 and time.monotonic() < deadline:
            f = next(it)
            if f is not None:
                got.append(f)
        assert len(got) == 2 and all(f.shape == (16, 64) for f in got)
    finally:
        src.close()
