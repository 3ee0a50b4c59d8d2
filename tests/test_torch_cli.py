"""The port's command line (``fdoct_tpu_torch/cli.py``, ``python -m
fdoct_tpu_torch``) on the CPU with ``--device cpu``, in process, each case
of tests/test_cli.py that the port covers, and its outputs held to the JAX
CLI's (``fdoct_tpu/cli.py``) run on the same inputs.

Tolerances.  Decoded B-scan PNG pixels within one uint8 level (JET PNGs
within 8: one display level moves a JET channel by up to ~4); raw-frame PNGs
(capture, viewport) exact; ``.m`` data (numbers printed to 10 digits) and
float32 ``.npz`` data at rtol 1e-5, atol 1e-5 of the peak; a float64
``cscan`` volume at rtol 1e-9, atol 1e-9 of the peak, with its
``surface_map`` and ``ascan_peaks`` exactly equal; the dispersion sweep's
winner exactly equal and its scores' printed range at rtol 1e-4; converter
outputs byte-equal.
"""

import io
import json
import re
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from fdoct_tpu.cli import main as jax_main
from fdoct_tpu_torch import cli
from fdoct_tpu_torch.cli import SourceTimeoutError, _frame_iter, main
from fdoct_tpu_torch.config import PipelineConfig, write_ini
from fdoct_tpu_torch.sources.synthetic import staircase_phantom, wang_lambda_grid
from fdoct_tpu_torch.utils.imageio import read_png, write_png
from fdoct_tpu_torch.volume import ascan_peaks, surface_map

ROOT = Path(__file__).resolve().parents[1]
CPU = ["--device", "cpu"]
HAVE_NATIVE = shutil.which("g++") is not None or (
    (ROOT / "native" / "libfdoct_ring.so").exists()
    and (ROOT / "native" / "capture_daemon").exists())
native = pytest.mark.skipif(not HAVE_NATIVE, reason="no C++ toolchain and no native binaries")
SMALL = dict(width=256, height=40, binvalue=1, averages=1, numfftpoints=512,
             numdisplaypoints=128, lambdamin=816e-9, lambdamax=884e-9, dirdescr="cli",
             dtype="float32")


@pytest.fixture(autouse=True)
def no_stdin(monkeypatch):
    """live reads keys from stdin through select: none here."""
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    monkeypatch.setattr("select.select", lambda *a, **k: ([], [], []))


@pytest.fixture(scope="module")
def phantom_dir(tmp_path_factory):
    """Small staircase phantom PNG set (the imgi/piimgi/backg trio)."""
    d = tmp_path_factory.mktemp("phantom")
    for name, img in staircase_phantom(h=40, w=256).items():
        write_png(d / f"{name}.png", img)
    return d


@pytest.fixture()
def small_ini(tmp_path):
    p = tmp_path / "cli.ini"
    write_ini(PipelineConfig(**SMALL), p, "base")
    return str(p)


def json_config(path: Path, **kw) -> str:
    path.write_text(PipelineConfig(**{**SMALL, **kw}).to_json())
    return str(path)


def run_dir(base: Path) -> Path:
    (run,) = [p for p in Path(base).iterdir() if p.is_dir()]
    return run


def both(argv: list[str], tmp_path: Path, device_args=CPU) -> tuple[Path, Path]:
    """The JAX CLI and the port's on the same arguments, each into its own
    --outdir; returns the two run directories."""
    outs = {}
    for name, fn, extra in (("jax", jax_main, []), ("port", main, device_args)):
        out = tmp_path / name
        out.mkdir()
        assert fn(argv + ["--outdir", str(out)] + extra) == 0, name
        outs[name] = run_dir(out)
    return outs["jax"], outs["port"]


def assert_png_close(got: Path, want: Path, levels: int = 1) -> None:
    a, b = read_png(got).astype(int), read_png(want).astype(int)
    assert a.shape == b.shape, (got.name, a.shape, b.shape)
    assert np.abs(a - b).max() <= levels, (got.name, np.abs(a - b).max())


def m_numbers(path: Path) -> tuple[list[str], np.ndarray]:
    text = path.read_text()
    names = re.findall(r"^(\w+)=", text, re.M)
    nums = re.findall(r"[-+]?(?:\d+\.?\d*(?:[eE][-+]?\d+)?|inf|nan)", re.sub(r"^\w+=", "", text,
                                                                         flags=re.M))
    return names, np.array([float(x) for x in nums])


def assert_data_close(a, b, rtol: float) -> None:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


# ---------------------------------------------------------------------------
# sim


class TestSim:
    def test_sim_matches_jax(self, phantom_dir, small_ini, tmp_path):
        jdir, tdir = both(["sim", "--config", small_ini, "--image",
                           str(phantom_dir / "imgi.png"), "--frames", "2"], tmp_path)
        names = {p.name for p in tdir.iterdir()}
        assert names == {p.name for p in jdir.iterdir()}
        assert {"bscan001.png", "bscanc002.png", "BscanFFT.m"} <= names
        for i in (1, 2):
            assert_png_close(tdir / f"bscan{i:03d}.png", jdir / f"bscan{i:03d}.png")
            assert_png_close(tdir / f"bscanc{i:03d}.png", jdir / f"bscanc{i:03d}.png", 8)
        tn, tv = m_numbers(tdir / "BscanFFT.m")
        jn, jv = m_numbers(jdir / "BscanFFT.m")
        assert tn == jn
        assert_data_close(tv, jv, 1e-5)

    def test_sim_bscan_shows_staircase(self, phantom_dir, small_ini, tmp_path):
        assert main(["sim", "--config", small_ini, "--image", str(phantom_dir / "imgi.png"),
                     "--outdir", str(tmp_path), "--frames", "1"] + CPU) == 0
        b = read_png(run_dir(tmp_path) / "bscan001.png").astype(float)
        assert b.max() > 128
        depth_idx = np.arange(b.shape[0])[:, None]
        w = np.maximum(b - np.percentile(b, 90), 0)
        centroid = (depth_idx * w).sum(0) / np.maximum(w.sum(0), 1e-9)
        assert centroid[35] > centroid[5]

    def test_sim_npz_and_debug_dump_match_jax(self, phantom_dir, small_ini, tmp_path):
        jdir, tdir = both(["sim", "--config", small_ini, "--image",
                           str(phantom_dir / "imgi.png"), "--frames", "1", "--format", "npz",
                           "--debug-dump"], tmp_path)
        with np.load(jdir / "BscanFFT.npz") as j, np.load(tdir / "BscanFFT.npz") as t:
            assert set(j.files) == set(t.files) == {"bscan001", "debugzpaddedlin",
                                                     "nearestkindex"}
            for k in j.files:
                assert j[k].dtype == t[k].dtype, k
                assert_data_close(t[k], j[k], 1e-5)

    def test_precision_flag_overrides_config(self, phantom_dir, small_ini, tmp_path,
                                             monkeypatch):
        from fdoct_tpu_torch import session as session_mod
        seen = {}
        real = session_mod.Session

        def spy(cfg, *a, **kw):
            seen["precision"], seen["device"] = cfg.matmul_precision, kw["device"]
            return real(cfg, *a, **kw)

        monkeypatch.setattr(session_mod, "Session", spy)
        assert main(["sim", "--config", small_ini, "--image", str(phantom_dir / "imgi.png"),
                     "--outdir", str(tmp_path), "--frames", "1", "--precision",
                     "int8_direct"] + CPU) == 0
        assert seen == {"precision": "int8_direct", "device": torch.device("cpu")}
        with pytest.raises(SystemExit):
            main(["sim", "--config", small_ini, "--precision", "int4"] + CPU)


# ---------------------------------------------------------------------------
# capture, offline, viewport, converters


class TestCaptureOffline:
    def test_capture_then_offline_matches_jax(self, small_ini, tmp_path):
        assert main(["capture", "--config", small_ini, "--outdir", str(tmp_path / "cap"),
                     "--sets", "2", "--frames-per-set", "3"] + CPU) == 0
        run = run_dir(tmp_path / "cap")
        assert sorted(p.name for p in run.glob("Trig*.png")) == [
            f"Trig{s:03d}-{f:03d}.png" for s in range(2) for f in range(3)]
        jdir = shutil.copytree(run, tmp_path / "jaxoff")
        assert jax_main(["capture", "--config", small_ini, "--outdir",
                         str(tmp_path / "jcap"), "--sets", "2", "--frames-per-set", "3"]) == 0
        for p in run.glob("Trig*.png"):
            assert np.array_equal(read_png(p), read_png(run_dir(tmp_path / "jcap") / p.name))
        assert main(["offline", str(run), "3", "--config", small_ini] + CPU) == 0
        assert jax_main(["offline", str(jdir), "3", "--config", small_ini]) == 0
        for si in range(2):
            assert_png_close(run / f"offline_bscan{si:03d}.png",
                             jdir / f"offline_bscan{si:03d}.png")
            assert_png_close(run / f"offline_bscanc{si:03d}.png",
                             jdir / f"offline_bscanc{si:03d}.png", 8)

    def test_offline_of_empty_dir_fails(self, tmp_path, capsys):
        assert main(["offline", str(tmp_path)] + CPU) == 1
        assert "no Trig*.png sets" in capsys.readouterr().err

    def test_capture_skips_triggered_idle_yields(self, small_ini, tmp_path, monkeypatch):
        class TriggeredStub:
            def frames(self):
                while True:
                    yield None
                    yield np.full((40, 256), 7, np.uint8)

        monkeypatch.setattr(cli, "_make_source", lambda args, cfg: TriggeredStub())
        assert main(["capture", "--config", small_ini, "--outdir", str(tmp_path), "--sets",
                     "1", "--frames-per-set", "2"] + CPU) == 0
        assert sorted(p.name for p in run_dir(tmp_path).glob("Trig*.png")) == [
            "Trig000-000.png", "Trig000-001.png"]

    @pytest.mark.parametrize("bits16", [False, True])
    def test_capture_alternate_and_bits16(self, small_ini, tmp_path, bits16):
        argv = ["capture", "--config", small_ini, "--sets", "1", "--frames-per-set", "2",
                "--alternate"] + (["--bits16"] if bits16 else [])
        jdir, tdir = both(argv, tmp_path)
        assert {p.name for p in tdir.iterdir()} == {p.name for p in jdir.iterdir()}
        for name in ("Trig000-001.png", "KTrig000-000.png"):
            got = read_png(tdir / name)
            assert got.dtype == (np.uint16 if bits16 and name.startswith("T") else np.uint8)
            assert np.array_equal(got, read_png(jdir / name))


class TestViewport:
    def test_viewport_matches_jax(self, small_ini, tmp_path):
        jdir, tdir = both(["viewport", "--config", small_ini, "--frames", "3"], tmp_path)
        assert sorted(p.name for p in tdir.glob("frame*.png")) == [
            f"frame{i:03d}.png" for i in range(3)]
        for p in tdir.glob("frame*.png"):
            assert np.array_equal(read_png(p), read_png(jdir / p.name))


class TestConverters:
    @pytest.mark.parametrize("mode", ["m", "mm", "ms"])
    def test_xml2m_outputs_equal_jax(self, tmp_path, mode):
        from fdoct_tpu_torch.utils.cvxml import write_xml
        rng = np.random.default_rng(42)
        mats = {"bscan001": rng.normal(size=(3, 4)), "linearized": rng.normal(size=(2, 5))}
        outs = {}
        for name, fn in (("jax", jax_main), ("port", main)):
            d = tmp_path / name
            d.mkdir()
            write_xml(d / "dump.xml", mats, scalars={"camgain": 7})
            assert fn([f"xml2{mode}", str(d / "dump.xml")]) == 0
            outs[name] = {p.name: p.read_bytes() for p in d.glob("*.m")}
        assert outs["port"] == outs["jax"] and outs["port"]
        if mode == "m":
            text = outs["port"]["dump_xml2m.m"].decode()
            assert "bscan001=[" in text and "camgain=7" in text


def test_fps_measures_the_source(small_ini, capsys):
    assert main(["fps", "--config", small_ini, "--seconds", "0.3", "--window", "0.1"] + CPU) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("final fps = ") and float(out[-1].split("=")[1]) > 0
    assert any(line.startswith("fps = ") and "max intensity" in line for line in out)


class TestConfigEdit:
    def test_configedit_sets_and_lists(self, small_ini, capsys):
        assert main(["configedit", small_ini, "--set", "averages=4"]) == 0
        assert main(["configedit", small_ini]) == 0
        assert "averages = 4" in capsys.readouterr().out
        assert main(["configedit", small_ini, "--set", "nosuchfield=1"]) == 1


# ---------------------------------------------------------------------------
# live


class TestLive:
    def test_live_synthetic(self, small_ini, tmp_path, capsys):
        assert main(["live", "--config", small_ini, "--outdir", str(tmp_path), "--frames",
                     "3"] + CPU) == 0
        assert "processed 3 frames" in capsys.readouterr().out

    def test_live_batch_exact_frames(self, small_ini, tmp_path, capsys):
        """--batch rides Session.process_group and honors --frames exactly."""
        assert main(["live", "--config", small_ini, "--outdir", str(tmp_path), "--batch", "4",
                     "--frames", "10"] + CPU) == 0
        assert "processed 10 frames" in capsys.readouterr().out

    def test_live_triggered_ignores_batch(self, small_ini, tmp_path, monkeypatch, capsys):
        class TriggeredStub:
            triggered = True

            def frames(self):
                while True:
                    yield None
                    yield np.full((40, 256), 9, np.uint8)

        monkeypatch.setattr(cli, "_make_source", lambda args, cfg: TriggeredStub())
        assert main(["live", "--config", small_ini, "--outdir", str(tmp_path), "--batch", "16",
                     "--frames", "2"] + CPU) == 0
        assert "per-frame loop" in capsys.readouterr().err

    def test_variant_spinj_maps_to_spinj_session(self, small_ini, tmp_path, monkeypatch):
        from fdoct_tpu_torch import session as session_mod
        seen = {}
        real = session_mod.Session

        def spy(cfg, *a, **kw):
            seen["variant"] = kw.get("variant")
            return real(cfg, *a, **kw)

        monkeypatch.setattr(session_mod, "Session", spy)
        assert main(["live", "--config", small_ini, "--variant", "spinj", "--outdir",
                     str(tmp_path), "--frames", "2"] + CPU) == 0
        assert seen["variant"] == "spinj"

    def test_live_trace_writes_a_chrome_trace(self, small_ini, tmp_path):
        assert main(["live", "--config", small_ini, "--outdir", str(tmp_path), "--frames",
                     "2", "--trace", str(tmp_path / "trace")] + CPU) == 0
        (trace,) = (tmp_path / "trace").glob("trace_*.json")
        assert json.loads(trace.read_text())["traceEvents"]

    def test_live_saves_on_s_key_match_jax(self, small_ini, tmp_path, monkeypatch):
        """An 's' from stdin saves the next group in both CLIs: the same
        files, the display PNG within one level."""
        def keys():
            monkeypatch.setattr("sys.stdin", io.StringIO("s\n"))
            calls = iter([([sys.stdin], [], [])])
            monkeypatch.setattr("select.select", lambda *a, **k: next(calls, ([], [], [])))

        outs = {}
        for name, fn, extra in (("jax", jax_main, []), ("port", main, CPU)):
            keys()
            assert fn(["live", "--config", small_ini, "--outdir", str(tmp_path / name),
                       "--frames", "3", "--format", "npz"] + extra) == 0
            outs[name] = run_dir(tmp_path / name)
        assert {p.name for p in outs["port"].iterdir()} == {p.name for p in outs["jax"].iterdir()}
        assert_png_close(outs["port"] / "bscan001.png", outs["jax"] / "bscan001.png")
        with np.load(outs["port"] / "BscanFFT.npz") as t, \
                np.load(outs["jax"] / "BscanFFT.npz") as j:
            assert_data_close(t["bscan001"], j["bscan001"], 1e-5)


class TestMesh:
    """``--mesh``: a world of one in process, no launcher (tests/
    test_torch_parallel.py holds the multi-rank mesh to JAX's)."""

    def test_live_mesh_1x1_matches_jax(self, tmp_path, monkeypatch):
        """The batched groups ride the mesh session step in both CLIs (the
        JAX CLI on its 8 virtual devices, 8 × 1); an 's' from stdin saves
        alike; the world is closed on exit."""
        import torch.distributed as dist

        from fdoct_tpu_torch.session import Session
        used = []
        orig = Session._process_group_mesh
        monkeypatch.setattr(Session, "_process_group_mesh",
                            lambda self, *a: used.append(1) or orig(self, *a))
        cfg_path = json_config(tmp_path / "c.json", averages=8)
        outs = {}
        for name, fn, extra in (("jax", jax_main, ["--mesh", "8x1"]),
                                ("port", main, ["--mesh", "1x1"] + CPU)):
            monkeypatch.setattr("sys.stdin", io.StringIO("s\n"))
            calls = iter([([sys.stdin], [], [])])
            monkeypatch.setattr("select.select", lambda *a, **k: next(calls, ([], [], [])))
            assert fn(["live", "--config", cfg_path, "--outdir", str(tmp_path / name),
                       "--frames", "24", "--batch", "8", "--format", "npz"] + extra) == 0
            outs[name] = run_dir(tmp_path / name)
        assert used and not dist.is_initialized()
        assert {p.name for p in outs["port"].iterdir()} == {p.name for p in outs["jax"].iterdir()}
        assert_png_close(outs["port"] / "bscan001.png", outs["jax"] / "bscan001.png")
        with np.load(outs["port"] / "BscanFFT.npz") as t, \
                np.load(outs["jax"] / "BscanFFT.npz") as j:
            assert_data_close(t["bscan001"], j["bscan001"], 1e-5)

    def test_cscan_mesh_1x1_matches_jax(self, tmp_path):
        """The volume on the port's 1 × 1 mesh and on the JAX CLI's 8 × 1."""
        cfg_path = json_config(tmp_path / "c.json", dtype="float64", height=16)
        argv = ["cscan", "--config", cfg_path, "--frames", "8"]
        outs = {}
        for name, fn, extra in (("jax", jax_main, ["--mesh", "8x1"]),
                                ("port", main, ["--mesh", "1x1"] + CPU)):
            (tmp_path / name).mkdir()
            assert fn(argv + ["--outdir", str(tmp_path / name)] + extra) == 0
            outs[name] = run_dir(tmp_path / name)
        jdir, tdir = outs["jax"], outs["port"]
        with np.load(jdir / "BscanFFT.npz") as j, np.load(tdir / "BscanFFT.npz") as t:
            assert t["cscan"].shape == (8, 128, 16)
            assert_data_close(t["cscan"], j["cscan"], 1e-9)
            np.testing.assert_array_equal(t["surface"], j["surface"])

    @pytest.mark.parametrize("spec,want", [
        ("2xq", "invalid --mesh '2xq' (expected DxA, e.g. 4x2): "),
        ("3x1", "--mesh 3x1: mesh 3x1 != ")])
    def test_parse_mesh_errors_match_jax(self, small_ini, tmp_path, spec, want):
        """A malformed spec and one the world cannot hold: the JAX CLI's
        SystemExit messages (the device count is the world's: 8 virtual CPU
        devices in JAX, one process here)."""
        import torch.distributed as dist

        argv = ["cscan", "--config", small_ini, "--outdir", str(tmp_path), "--frames", "2",
                "--mesh", spec]
        for fn, extra in ((jax_main, []), (main, CPU)):
            with pytest.raises(SystemExit) as e:
                fn(argv + extra)
            assert str(e.value).startswith(want), str(e.value)
        assert not dist.is_initialized()


@native
class TestLiveCamera:
    def test_live_from_camera_ring(self, small_ini, tmp_path, monkeypatch):
        """live --camera: frames arrive via the native ring fed by the
        spawned capture daemon, which main() stops on the way out."""
        from fdoct_tpu_torch.sources import camera
        made = []
        real = camera.CameraSource

        def track(*a, **kw):
            made.append(real(*a, **kw))
            return made[-1]

        monkeypatch.setattr(camera, "CameraSource", track)
        assert main(["live", "--config", small_ini, "--outdir", str(tmp_path), "--camera",
                     str(tmp_path / "cam.ring"), "--camera-fps", "300", "--frames", "3"]
                    + CPU) == 0
        assert len(made) == 1 and made[0].proc.poll() is not None     # no orphan
        assert any(p.is_dir() for p in tmp_path.iterdir())

    def test_live_batch_dead_daemon_is_an_error(self, small_ini, tmp_path, monkeypatch):
        from fdoct_tpu_torch.sources import camera
        real_init = camera.CameraSource.__init__

        def init(self, *a, **kw):
            kw["max_restarts"], kw["starve_timeout_s"] = 0, 1.0
            real_init(self, *a, **kw)
            self.proc.kill()
            self.proc.wait(timeout=5)

        monkeypatch.setattr(camera.CameraSource, "__init__", init)
        with pytest.raises(TimeoutError):
            main(["live", "--config", small_ini, "--outdir", str(tmp_path), "--camera",
                  str(tmp_path / "dead.ring"), "--batch", "4", "--frames", "20"] + CPU)

    def test_resume_pushes_restored_exposure(self, small_ini, tmp_path, monkeypatch):
        ring, ck = tmp_path / "cam.ring", tmp_path / "ck.npz"
        monkeypatch.setattr("sys.stdin", io.StringIO("u\n"))
        calls = iter([([sys.stdin], [], [])])
        monkeypatch.setattr("select.select", lambda *a, **k: next(calls, ([], [], [])))
        assert main(["live", "--config", small_ini, "--outdir", str(tmp_path), "--camera",
                     str(ring), "--camera-fps", "300", "--frames", "3", "--checkpoint",
                     str(ck)] + CPU) == 0
        assert ck.exists()
        monkeypatch.setattr("sys.stdin", io.StringIO(""))
        monkeypatch.setattr("select.select", lambda *a, **k: ([], [], []))
        assert main(["live", "--config", small_ini, "--outdir", str(tmp_path), "--camera",
                     str(ring), "--camera-fps", "300", "--frames", "2", "--resume", str(ck)]
                    + CPU) == 0
        from fdoct_tpu_torch.sources.camera import RingReader
        r = RingReader(ring)
        try:
            assert r.get_ctrl("exposure") == 2000.0
        finally:
            r.close()


def test_bad_camera_daemon_spec(small_ini, tmp_path):
    with pytest.raises(SystemExit, match="unknown --camera-daemon"):
        main(["live", "--config", small_ini, "--outdir", str(tmp_path), "--camera",
              str(tmp_path / "x.ring"), "--camera-daemon", "bogus", "--frames", "1"] + CPU)


class TestLiveCheckpoint:
    def test_checkpoint_then_resume_across_packages(self, small_ini, tmp_path, monkeypatch):
        """A checkpoint of either CLI resumes in the other, and the port's
        checkpoint resumes in the port."""
        port_ck, jax_ck = tmp_path / "port.npz", tmp_path / "jax.npz"
        assert main(["live", "--config", small_ini, "--outdir", str(tmp_path), "--frames", "2",
                     "--checkpoint", str(port_ck)] + CPU) == 0
        assert jax_main(["live", "--config", small_ini, "--outdir", str(tmp_path), "--frames",
                         "2", "--checkpoint", str(jax_ck)]) == 0
        for ck in (port_ck, jax_ck):
            assert main(["live", "--config", small_ini, "--outdir", str(tmp_path), "--frames",
                         "2", "--resume", str(ck)] + CPU) == 0
        assert jax_main(["live", "--config", small_ini, "--outdir", str(tmp_path), "--frames",
                         "2", "--resume", str(port_ck)]) == 0

    def test_checkpoint_suffixless_path_resumable(self, small_ini, tmp_path):
        ckpt = tmp_path / "sess"
        assert main(["live", "--config", small_ini, "--outdir", str(tmp_path), "--frames", "2",
                     "--checkpoint", str(ckpt)] + CPU) == 0
        assert (tmp_path / "sess.npz").exists()
        assert main(["live", "--config", small_ini, "--outdir", str(tmp_path), "--frames", "2",
                     "--resume", str(ckpt)] + CPU) == 0

    def test_periodic_checkpoint_every_n_groups(self, small_ini, tmp_path, monkeypatch):
        from fdoct_tpu_torch.utils import checkpoint
        saves = []
        orig = checkpoint.save_session
        monkeypatch.setattr(checkpoint, "save_session",
                            lambda s, p, **k: (saves.append(str(p)), orig(s, p, **k))[1])
        ckpt = tmp_path / "sess.npz"
        assert main(["live", "--config", small_ini, "--outdir", str(tmp_path), "--frames", "6",
                     "--checkpoint", str(ckpt), "--checkpoint-every", "2"] + CPU) == 0
        assert ckpt.exists()
        # 6 groups -> 3 periodic + 1 exit save, all through the atomic write-aside
        assert len(saves) == 4 and all(p.endswith(".tmp.npz") for p in saves), saves
        assert checkpoint.load_session(ckpt, device="cpu") is not None

    def test_checkpoint_every_requires_checkpoint_path(self, small_ini, tmp_path):
        with pytest.raises(SystemExit, match="requires --checkpoint"):
            main(["live", "--config", small_ini, "--outdir", str(tmp_path), "--frames", "1",
                  "--checkpoint-every", "5"] + CPU)

    def test_sigterm_exits_through_checkpoint(self, small_ini, tmp_path):
        ckpt, log = tmp_path / "sess.npz", tmp_path / "live.log"
        code = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n"
                "from fdoct_tpu_torch.cli import main\n"
                f"sys.exit(main(['live', '--config', {small_ini!r}, '--outdir', "
                f"{str(tmp_path)!r}, '--frames', '0', '--verbose', '--checkpoint', "
                f"{str(ckpt)!r}, '--device', 'cpu']))\n")
        with open(log, "w") as lf:
            proc = subprocess.Popen([sys.executable, "-c", code], stdin=subprocess.DEVNULL,
                                    stdout=lf, stderr=subprocess.STDOUT, text=True)
        try:
            deadline = time.monotonic() + 90
            while time.monotonic() < deadline:
                if "bscan group done" in log.read_text():
                    break
                time.sleep(0.3)
            else:
                raise AssertionError(f"never started: {log.read_text()[-800:]}")
            proc.send_signal(signal.SIGTERM)
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            raise
        out = log.read_text()
        assert proc.returncode == 0, out[-800:]
        assert "finishing up" in out and "processed" in out, out[-800:]
        assert ckpt.exists()


# ---------------------------------------------------------------------------
# cscan and sweep


def chirped_dir(tmp_path: Path, cfg: PipelineConfig, a2_true: float) -> Path:
    """tests/test_autofocus.py's chirped interferogram and its background
    as an imgi/backg PNG pair."""
    from fdoct_tpu_torch.calibration import Calibration
    kl = Calibration.create(cfg, "cpu").klinear.numpy()
    kc, half = (kl[0] + kl[-1]) / 2, (kl[-1] - kl[0]) / 2
    lambdas = wang_lambda_grid(cfg.width)
    k = 2 * np.pi / lambdas
    x = (k - kc) / half
    S = np.exp(-0.5 * ((lambdas - 850e-9) / 17e-9) ** 2)
    fringe = S * (1.25 + np.cos(2 * k * 60e-6 + a2_true * x**2))
    d = tmp_path / "chirp"
    d.mkdir()
    write_png(d / "imgi.png",
              np.round(np.tile(fringe / fringe.max(), (cfg.height, 1)) * 255).astype(np.uint8))
    write_png(d / "backg.png",
              np.round(np.tile(S / S.max(), (cfg.height, 1)) * 255).astype(np.uint8))
    return d


class TestCscan:
    @pytest.mark.parametrize("dtype,sweep,rtol", [("float64", True, 1e-9),
                                                  ("float64", False, 1e-9),
                                                  ("float32", True, 1e-5)])
    def test_cscan_matches_jax(self, tmp_path, dtype, sweep, rtol, capsys):
        """The chirped image replayed: the sweep's winner printed alike, the
        volume at ``rtol``, its surface map and every frame's A-scan peaks
        exactly equal, the same files, the PNGs within one level (JET 8)."""
        cfg_path = json_config(tmp_path / "c.json", dtype=dtype, height=16,
                               numdisplaypoints=160)
        d = chirped_dir(tmp_path, PipelineConfig.from_json(Path(cfg_path).read_text()), 5.0)
        argv = ["cscan", "--config", cfg_path, "--image", str(d / "imgi.png"), "--frames",
                "8"] + (["--dispersion-sweep"] if sweep else [])
        jdir, tdir = both(argv, tmp_path)
        if sweep:
            lines = [ln for ln in capsys.readouterr().out.splitlines()
                     if ln.startswith("dispersion sweep")]
            assert len(lines) == 2 and lines[0] == lines[1] and lines[0].endswith("+5.00")
        assert {p.name for p in tdir.iterdir()} == {p.name for p in jdir.iterdir()}
        with np.load(jdir / "BscanFFT.npz") as j, np.load(tdir / "BscanFFT.npz") as t:
            vol, jvol, surf = t["cscan"], j["cscan"], t["surface"]
            assert vol.shape == (8, 160, 16) and vol.dtype == jvol.dtype
            assert_data_close(vol, jvol, rtol)
            np.testing.assert_array_equal(surf, j["surface"])
        np.testing.assert_array_equal(surface_map(torch.as_tensor(vol)).numpy(), surf)
        for f in range(vol.shape[0]):
            from fdoct_tpu.volume import ascan_peaks as jax_peaks
            idx, _ = ascan_peaks(torch.as_tensor(vol[f]))
            np.testing.assert_array_equal(idx.numpy(), np.asarray(jax_peaks(jnp.asarray(vol[f]))[0]))
        for p in tdir.glob("*.png"):
            assert_png_close(p, jdir / p.name, 8 if p.name != "surface_map.png" else 1)

    def test_cscan_synthetic_writes_volume(self, small_ini, tmp_path):
        assert main(["cscan", "--config", small_ini, "--outdir", str(tmp_path), "--frames",
                     "8"] + CPU) == 0
        run = run_dir(tmp_path)
        with np.load(run / "BscanFFT.npz") as data:
            assert data["cscan"].shape == (8, 128, 40) and data["surface"].shape == (8, 40)
        assert any(p.name.startswith("cscan_frame") for p in run.iterdir())
        assert (run / "enface_mip.png").exists() and (run / "surface_map.png").exists()

    def test_cscan_int8_direct_matches_jax(self, small_ini, tmp_path):
        """The int8-direct volume path in both CLIs (each folds its own plan
        from its own float32 M; one quantized operator step apart at most)."""
        jdir, tdir = both(["cscan", "--config", small_ini, "--frames", "4", "--precision",
                           "int8_direct"], tmp_path)
        with np.load(jdir / "BscanFFT.npz") as j, np.load(tdir / "BscanFFT.npz") as t:
            assert t["cscan"].dtype == np.float32
            assert_data_close(t["cscan"], j["cscan"], 1e-4)


class TestSweep:
    @pytest.mark.parametrize("joint", [False, True])
    def test_sweep_matches_jax(self, tmp_path, joint, capsys):
        cfg_path = json_config(tmp_path / "s.json", dtype="float64", height=16,
                               numdisplaypoints=160)
        d = chirped_dir(tmp_path, PipelineConfig.from_json(Path(cfg_path).read_text()), 5.0)
        outs = {}
        for name, fn, extra in (("jax", jax_main, []), ("port", main, CPU)):
            png = tmp_path / f"{name}.png"
            assert fn(["sweep", "--config", cfg_path, "--image", str(d / "imgi.png"), "--out",
                       str(png)] + (["--joint", "--steps", "13"] if joint else []) + extra) == 0
            outs[name] = [ln for ln in capsys.readouterr().out.splitlines()
                          if ln.startswith("best")][0]
        if joint:
            assert outs["port"] == outs["jax"]
        else:
            nums = {k: [float(x) for x in re.findall(r"[-+]?\d+\.\d+(?:e[-+]\d+)?", v)]
                    for k, v in outs.items()}
            assert nums["port"][0] == nums["jax"][0] == pytest.approx(5.0, abs=0.75)
            np.testing.assert_allclose(nums["port"][1:], nums["jax"][1:], rtol=1e-4)
        assert_png_close(tmp_path / "port.png", tmp_path / "jax.png", 8)


# ---------------------------------------------------------------------------
# selftest, device, unported features, the idle timeout, the offline hand-off


class TestSelftest:
    def test_selftest_passes(self, capsys):
        assert main(["selftest"] + CPU) == 0
        out = capsys.readouterr().out
        assert "[--] single device; sharded parity skipped" in out and "PASSED" in out

    def test_python_m_selftest(self):
        r = subprocess.run([sys.executable, "-m", "fdoct_tpu_torch", "selftest", "--device",
                            "cpu"], cwd=ROOT, capture_output=True, text=True, timeout=240)
        assert r.returncode == 0, r.stdout[-800:] + r.stderr[-800:]
        assert "gather/fused agreement" in r.stdout and "selftest PASSED" in r.stdout


def test_default_device_is_cuda_and_fails_loudly(small_ini, tmp_path):
    """Without --device every computing command asks for the card; with no
    card that is an error, never the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    for argv in (["selftest"], ["sim", "--config", small_ini, "--outdir", str(tmp_path)],
                 ["cscan", "--config", small_ini, "--outdir", str(tmp_path)]):
        with pytest.raises(SystemExit, match="--device cuda: torch.cuda.is_available"):
            main(argv)
    assert not [p for p in tmp_path.iterdir() if p.is_dir()]      # no run directory


@pytest.mark.parametrize("argv,item", [(["bench"], "item 5")])
def test_unported_features_name_their_roadmap_item(argv, item, monkeypatch, tmp_path, capsys):
    """The last feature the ROADMAP listed as unported (Queue 1 ``item``),
    ``bench``, now runs through the CLI: on the CPU at a small shape, its
    clock charging each chained run 1 ms a group, one JSON line with
    bench.py's headline keys."""
    from fdoct_tpu_torch import bench

    def clock(fn, frames):
        fn(frames)
        return len(frames) * 1e-3

    monkeypatch.setattr(bench, "FLAGSHIP", bench.Shape(rows=16, cols=128, nfft=128, ndisp=32,
                                                       batch=2, g1=1, g2=2, batched_g1=1,
                                                       batched_g2=2, repeats=1))
    monkeypatch.setattr(bench, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(bench, "BASELINE_SECONDS", 0.2)
    monkeypatch.setattr(bench, "run_seconds", clock)
    assert main(argv + CPU) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["metric"] == "ascans_per_sec_per_chip_2048px"
    assert out["value"] == 2 * 16 / 1e-3 and out["vs_baseline"] > 0
    assert out["dropped"] == {} and out["timer"] == "host_clock"


def test_live_viewer_files_match_jax(small_ini, tmp_path):
    """live --viewer DIR renders the display windows as the JAX CLI does: the
    same files; the raw frame exactly, the JET B-scan within 8 levels (one
    display level), the status image of the same size with rows in both or
    in neither (the port draws its own font)."""
    views = {}
    for name, fn, extra in (("jax", jax_main, []), ("port", main, CPU)):
        views[name] = tmp_path / f"view_{name}"
        assert fn(["live", "--config", small_ini, "--outdir", str(tmp_path / name), "--frames",
                   "3", "--viewer", str(views[name])] + extra) == 0
    names = {p.name for p in views["port"].iterdir()}
    assert {"show.png", "status.png", "bscan.png"} <= names
    assert names == {p.name for p in views["jax"].iterdir()}
    np.testing.assert_array_equal(read_png(views["port"] / "show.png"),
                                  read_png(views["jax"] / "show.png"))
    assert_png_close(views["port"] / "bscan.png", views["jax"] / "bscan.png", levels=8)
    status, jstatus = (read_png(views[n] / "status.png") for n in ("port", "jax"))
    assert status.shape == jstatus.shape == (300, 600)
    assert status.any() == jstatus.any()          # rows drawn in both or in neither


def test_live_viewer_http_prints_its_url(small_ini, tmp_path, capsys):
    """--viewer-mode http --viewer-port 0 serves on an ephemeral port, prints
    the URL on stderr and exits 0 when the frames are done."""
    assert main(["live", "--config", small_ini, "--outdir", str(tmp_path), "--frames", "4",
                 "--batch", "2", "--viewer-mode", "http", "--viewer-port", "0"] + CPU) == 0
    out = capsys.readouterr()
    assert re.search(r"live viewer at http://127\.0\.0\.1:\d+/", out.err), out.err
    assert "processed 4 frames" in out.out


class TestIdleTimeout:
    def test_frame_iter_names_source_and_timeout(self):
        class NeverFires:
            def frames(self):
                while True:
                    yield None

        with pytest.raises(SourceTimeoutError, match=r"NeverFires produced no frame for 0\.05 s"):
            next(_frame_iter(NeverFires(), idle_timeout_s=0.05))
        assert issubclass(SourceTimeoutError, TimeoutError)

    def test_frame_iter_tolerates_idle_gaps(self):
        class Gappy:
            def frames(self):
                for i in range(3):
                    yield None
                    yield np.full((4, 4), i, np.uint8)

        assert [int(f[0, 0]) for f in _frame_iter(Gappy(), idle_timeout_s=5.0)] == [0, 1, 2]

    def test_main_exits_cleanly_on_idle_timeout(self, small_ini, tmp_path, monkeypatch,
                                                capsys):
        """The JAX CLI raises a bare TimeoutError here; the port's main
        reports the source and the timeout and exits 1."""
        class NeverFires:
            ring_path = "cam.ring"

            def frames(self):
                while True:
                    yield None

        monkeypatch.setattr(cli, "_make_source", lambda args, cfg: NeverFires())
        assert main(["capture", "--config", small_ini, "--outdir", str(tmp_path),
                     "--idle-timeout", "0.05"] + CPU) == 1
        err = capsys.readouterr().err
        assert "fdoct-torch capture: NeverFires (cam.ring) produced no frame for 0.05 s" in err

    def test_idle_timeout_nonpositive_waits(self):
        for v, want in ((0, float("inf")), (-1.0, float("inf")), (5.5, 5.5)):
            class A:
                idle_timeout = v
            assert cli._idle_timeout(A()) == want


def test_spinj_y_key_runs_the_ports_offline_command(tmp_path, monkeypatch):
    """The spinj 'y' key with no offline_tool_path starts ``python -m
    fdoct_tpu_torch.cli offline DIR N --device cpu`` on the session's run
    directory, and that command reconstructs the triggered set there."""
    from fdoct_tpu_torch.session import Session
    from fdoct_tpu_torch.sinks import RunWriter
    from fdoct_tpu_torch.sources.synthetic import SyntheticSource

    monkeypatch.setenv("PYTHONPATH", str(ROOT))
    cfg = PipelineConfig(**{**SMALL, "manualaverages": 2})
    sink = RunWriter(tmp_path, "spinj")
    s = Session(cfg, device="cpu", variant="spinj", sink=sink)
    it = SyntheticSource(height=40, width=256, noise=0.01).frames()
    s.key("t")
    for _ in range(2):
        s.process(next(it))
    assert sorted(p.name for p in sink.dir.glob("Trig*.png")) == ["Trig000-000.png",
                                                                 "Trig000-001.png"]
    s.key("y")
    assert s._offline_proc.args[1:] == ["-m", "fdoct_tpu_torch.cli", "offline", str(sink.dir),
                                        "2", "--device", "cpu"]
    assert s._offline_proc.wait(timeout=240) == 0
    assert (sink.dir / "offline_bscan000.png").exists()
    assert (sink.dir / "offline_bscanc000.png").exists()
