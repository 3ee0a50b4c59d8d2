"""The program's span recorder (``utils.profiling``: ``StageTimer``,
``SPANS``, ``span``, ``count``), the spans of ``to_host`` and of the C-scan
volume, the per-layer readers of ``oct_bench/metrics/`` that read them, and
``fdoct-torch cscan --trace``.

    python -m pytest tests/test_torch_spans.py -q

The ``cuda`` case skips without a card; on the card it runs with
``python -m pytest --noconftest -m cuda tests/test_torch_spans.py``.  This
file imports no JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from fdoct_tpu_torch import cli, utils
from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.parallel import sharded_cscan_volume
from fdoct_tpu_torch.sources.synthetic import SyntheticSource
from fdoct_tpu_torch.utils import profiling, to_host
from fdoct_tpu_torch.utils.profiling import StageTimer, count, span

ROOT = Path(__file__).resolve().parents[1]
READERS = ("cscan.d2h_copy_ms", "cscan.d2h_wait_ms", "cscan.d2h_gb_per_s",
           "cscan.d2h_reused_share")
SMALL = dict(width=256, height=40, binvalue=1, averages=1, numfftpoints=512,
             numdisplaypoints=128, lambdamin=816e-9, lambdamax=884e-9, dirdescr="spans",
             dtype="float32")


@pytest.fixture
def spans(monkeypatch):
    """A fresh ``SPANS`` for the test."""
    fresh = StageTimer()
    monkeypatch.setattr(profiling, "SPANS", fresh)
    return fresh


@pytest.fixture
def copy_as_on_card(monkeypatch):
    """``to_host`` takes its traced path for CPU tensors too, the stream's
    synchronize a no-op: the CPU stands in for the card."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(synchronize=lambda: None))
    monkeypatch.setattr(cli, "to_host", utils._to_host_traced)
    return utils._to_host_traced


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def small_volume(device, n: int = 3):
    cfg = PipelineConfig(**SMALL).validate()
    src = SyntheticSource(height=cfg.height, width=cfg.width, noise=0.02, seed=5)
    it = src.frames()
    frames = torch.as_tensor(np.stack([next(it) for _ in range(n)])).to(device)
    bg = torch.as_tensor(np.maximum(src.background(), 1.0), dtype=torch.float32).to(device)
    return frames, bg, torch.zeros_like(bg), Calibration.create(cfg, device), cfg


def volume_outputs(device, host=to_host) -> dict:
    frames, bg, pi, calib, cfg = small_volume(device)
    vol = sharded_cscan_volume(frames, bg, pi, calib, cfg)
    return {"volume": host(vol), "frame": host(vol[1]), "surface": host(vol.argmax(1))}


# --------------------------------------------------------------------------
# the recorder


def test_span_off_is_one_shared_noop(spans):
    assert not profiling.tracing()
    assert span("a") is span("b") is profiling._OFF
    count("c", 7)
    volume_outputs(torch.device("cpu"))
    assert spans.snapshot() == {"spans": {}, "counters": {}}


def test_nested_spans_give_parents_self_time_and_counters(spans):
    with cpu_profile():
        assert profiling.tracing()
        for _ in range(2):
            with span("outer"):
                time.sleep(0.002)
                with span("inner"):
                    time.sleep(0.003)
                    with span("leaf"):
                        time.sleep(0.001)
                with span("inner"):
                    pass
        count("bytes", 5)
        count("bytes", 6)
    assert not profiling.tracing()
    snap = spans.snapshot()
    s = snap["spans"]
    assert {k: (v["count"], v["parent"]) for k, v in s.items()} == {
        "outer": (2, None), "inner": (4, "outer"), "leaf": (2, "inner")}
    assert s["outer"]["self_s"] == pytest.approx(s["outer"]["total_s"] - s["inner"]["total_s"],
                                                 abs=1e-12)
    assert s["inner"]["self_s"] == pytest.approx(s["inner"]["total_s"] - s["leaf"]["total_s"],
                                                 abs=1e-12)
    assert s["leaf"]["self_s"] == s["leaf"]["total_s"] >= 0.002
    assert s["outer"]["self_s"] >= 0.004 and s["inner"]["self_s"] >= 0.006
    assert snap["counters"] == {"bytes": 11}
    assert spans.counts == {"outer": 2, "inner": 4, "leaf": 2}
    assert [r.split()[0] for r in spans.report().splitlines()] == ["outer", "inner", "leaf"]


def test_spans_nest_per_thread(spans):
    """A span opened on another thread is no child of this thread's."""
    with cpu_profile():
        with span("main"):
            worker = threading.Thread(target=_one_span, args=("worker",))
            worker.start()
            worker.join(timeout=10)
    assert not worker.is_alive()
    assert spans.snapshot()["spans"]["worker"]["parent"] is None
    assert spans.snapshot()["spans"]["main"]["self_s"] == spans.totals["main"]


def _one_span(name):
    with span(name):
        pass


def test_spans_are_host_operations_not_user_annotations(spans):
    with cpu_profile() as prof:
        volume_outputs(torch.device("cpu"))
    ours = [e for e in prof.events() if e.name.startswith(profiling.EVENT_PREFIX)]
    assert [e.name for e in ours] == ["fdoct.cscan.volume"]
    assert all(e.device_type == DeviceType.CPU and not e.is_user_annotation for e in ours)
    # a CPU tensor's copy records nothing; the volume counts its frames,
    # none of them a kernel's on the CPU
    snap = spans.snapshot()
    assert set(snap["spans"]) == {"cscan.volume"}
    assert snap["counters"] == {"cscan.frames": 3, "cscan.kernel_frames": 0}


def test_traced_copy_records_wait_copy_and_bytes(spans, copy_as_on_card):
    x = torch.arange(48, dtype=torch.float32).reshape(4, 12)
    with cpu_profile() as prof:
        got = copy_as_on_card(x[1:3])
    np.testing.assert_array_equal(got, x[1:3].numpy())
    s = spans.snapshot()
    assert {k: (v["count"], v["parent"]) for k, v in s["spans"].items()} == {
        "to_host": (1, None), "to_host.wait": (1, "to_host"), "to_host.copy": (1, "to_host")}
    assert s["counters"] == {"to_host.bytes": 2 * 12 * 4}
    names = [e.name for e in prof.events() if e.name.startswith("fdoct.")]
    assert names == ["fdoct.to_host", "fdoct.to_host.wait", "fdoct.to_host.copy"]


def test_volume_outputs_bit_for_bit_with_tracing_on_and_off(spans, copy_as_on_card):
    cpu = torch.device("cpu")
    off = volume_outputs(cpu)
    with cpu_profile():
        on = volume_outputs(cpu, host=copy_as_on_card)
    assert off.keys() == on.keys()
    for k in off:
        assert off[k].dtype == on[k].dtype and np.array_equal(off[k], on[k]), k
    snap = spans.snapshot()
    assert snap["spans"]["cscan.volume"]["count"] == 1
    assert snap["spans"]["to_host.copy"]["count"] == 3
    assert snap["counters"]["to_host.bytes"] == sum(v.nbytes for v in on.values())


# --------------------------------------------------------------------------
# the readers of oct_bench/metrics/


def reader(name):
    from oct_bench.catalog import Catalog
    return Catalog(ROOT).reader(name)


def made_snapshot(spans, copy_s=0.9, wait_s=0.12, volumes=3, nbytes=1_624_800_000,
                  reused=1_073_741_824):
    spans.totals.update({"cscan.volume": 0.003, "to_host": copy_s + wait_s + 0.001,
                         "to_host.wait": wait_s, "to_host.copy": copy_s})
    spans.counts.update({"cscan.volume": volumes, "to_host": 36, "to_host.wait": 36,
                         "to_host.copy": 36})
    spans.selfs.update({"cscan.volume": 0.003, "to_host": 0.001, "to_host.wait": wait_s,
                        "to_host.copy": copy_s})
    spans.parents.update({"cscan.volume": None, "to_host": None, "to_host.wait": "to_host",
                          "to_host.copy": "to_host"})
    spans.counters["to_host.bytes"] = nbytes
    spans.counters["to_host.reused_bytes"] = reused


TRACED = {"kind": "cscan", "trace": {"units": 3, "window_us": 1.0}, "bound_s": 1e-3}


def test_readers_follow_their_formulas(spans):
    made_snapshot(spans)
    assert reader("cscan.d2h_copy_ms")(TRACED) == pytest.approx(0.9 / 3 * 1e3)
    assert reader("cscan.d2h_wait_ms")(TRACED) == pytest.approx(0.12 / 3 * 1e3)
    assert reader("cscan.d2h_gb_per_s")(TRACED) == pytest.approx(1_624_800_000 / 0.9 / 1e9)
    assert reader("cscan.d2h_reused_share")(TRACED) == pytest.approx(1_073_741_824
                                                                     / 1_624_800_000)
    spans.counters["to_host.reused_bytes"] = 0            # every block made for its copy
    assert reader("cscan.d2h_reused_share")(TRACED) == 0
    del spans.counters["to_host.reused_bytes"]            # a program that does not count it
    assert reader("cscan.d2h_reused_share")(TRACED) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_give_none_without_a_traced_volume(spans, name):
    read = reader(name)
    assert read(TRACED) is None                                   # an empty snapshot
    made_snapshot(spans)
    assert read({**TRACED, "trace": None}) is None                # --trace 0
    assert read({**TRACED, "trace": {"units": 0}}) is None        # no harness span
    assert read({**TRACED, "kind": "live"}) is None
    del spans.totals["cscan.volume"]
    assert read(TRACED) is None                                   # no cscan.volume span


def test_tiny_traced_run_prints_the_contract_line(tmp_path):
    """A tiny ``--trace 1`` run on the CPU in a process without JAX: the
    contract line as before, the program's volume spans recorded, and no
    d2h metric (the run makes no device copy)."""
    prog = (
        "import json, sys, torch\n"
        "from pathlib import Path\n"
        "from oct_bench import devtrace, run\n"
        "from oct_bench.tests.tiny import make_root\n"
        "from fdoct_tpu_torch.utils.profiling import SPANS\n"
        "run.require_devices = lambda chips: torch.device('cpu')\n"
        "units, summarize = [], devtrace.summarize\n"
        "def counted(*a):\n"
        "    out = summarize(*a)\n"
        "    units.append(out['units'])\n"
        "    return out\n"
        "devtrace.summarize = counted\n"
        "root = make_root(Path(sys.argv[1]))\n"
        "rc = run.main(['--workload', 'flagship-cscan512', '--seed', '3000000019',\n"
        "               '--seconds', '0.5', '--trace', '1'], root=root)\n"
        "print(json.dumps({'units': units, **SPANS.snapshot()}), file=sys.stderr)\n"
        "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", prog, str(tmp_path)], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(out) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                         "checks"]
    assert out["correct"] is True and out["failed"] == 0
    assert out["metrics"] and not set(READERS) & set(out["metrics"])
    assert all(math.isfinite(m["value"]) for m in out["metrics"].values())
    snap = json.loads(r.stderr.strip().splitlines()[-1])
    # one program span for each of the harness's traced volumes
    assert snap["units"][0] >= 1
    assert snap["spans"]["cscan.volume"]["count"] == snap["units"][0]
    assert "to_host" not in snap["spans"]
    assert set(snap["counters"]) == {"cscan.frames", "cscan.kernel_frames"}
    assert snap["counters"]["cscan.kernel_frames"] == 0


# --------------------------------------------------------------------------
# fdoct-torch cscan --trace


def test_cscan_trace_writes_the_spans(tmp_path, spans, copy_as_on_card, capsys):
    cfg = tmp_path / "small.json"
    cfg.write_text(PipelineConfig(**SMALL).to_json())
    assert cli.main(["cscan", "--config", str(cfg), "--outdir", str(tmp_path / "out"),
                     "--frames", "4", "--trace", str(tmp_path / "trace"), "--device",
                     "cpu"]) == 0
    (trace,) = (tmp_path / "trace").glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]}
    assert {"fdoct.cscan.volume", "fdoct.to_host", "fdoct.to_host.wait",
            "fdoct.to_host.copy"} <= names
    report = capsys.readouterr().err
    listed = {line.split()[0] for line in report.splitlines() if line and line[0] != " "}
    assert {"cscan.volume", "to_host", "to_host.copy"} <= listed
    # the volume, its 4 dB frames, the MIP, the surface and its uint8 view
    assert spans.counts["cscan.volume"] == 1 and spans.counts["to_host"] == 8


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_spans_add_no_device_event_on_the_card(cuda, spans):
    from oct_bench.devtrace import SPAN_PREFIX, Profiler, summarize
    frames, bg, pi, calib, cfg = small_volume(cuda, n=8)
    p = Profiler("volume", cuda)
    p.warm(cuda)
    p.start()
    prof = p.prof
    with p.span():
        vol = sharded_cscan_volume(frames, bg, pi, calib, cfg)
        got = to_host(vol)
        row = to_host(vol[2])
    p.stop()
    events = prof.events()
    device_names = [e.name for e in events if e.device_type == DeviceType.CUDA]
    assert device_names and not [n for n in device_names if "fdoct." in n]
    assert not [n for n, _ in summarize(events, SPAN_PREFIX + "volume")["device_ops"]
                if "fdoct." in n]
    host = [e for e in events if e.name.startswith(profiling.EVENT_PREFIX)]
    assert {e.name for e in host} == {"fdoct.cscan.volume", "fdoct.to_host",
                                      "fdoct.to_host.wait", "fdoct.to_host.copy"}
    assert all(e.device_type == DeviceType.CPU for e in host)
    snap = spans.snapshot()
    assert set(snap["counters"]) == {"to_host.bytes", "to_host.reused_bytes", "cscan.frames",
                                     "cscan.kernel_frames"}
    assert snap["counters"]["cscan.kernel_frames"] == snap["counters"]["cscan.frames"] == 8
    assert snap["counters"]["to_host.bytes"] == got.nbytes + row.nbytes
    assert 0 <= snap["counters"]["to_host.reused_bytes"] <= got.nbytes + row.nbytes
    assert snap["spans"]["to_host.wait"]["parent"] == "to_host"
    assert snap["spans"]["to_host.copy"]["parent"] == "to_host"
    assert snap["spans"]["to_host"]["count"] == 2 and snap["spans"]["cscan.volume"]["count"] == 1
    np.testing.assert_array_equal(got, vol.cpu().numpy())


@pytest.mark.cuda
def test_volume_outputs_on_the_card_alike_pinned_and_through_cpu(cuda):
    pinned = volume_outputs(cuda)
    paged = volume_outputs(cuda, host=lambda t: t.cpu().numpy())
    assert pinned.keys() == paged.keys()
    for k in pinned:
        assert pinned[k].dtype == paged[k].dtype and np.array_equal(pinned[k], paged[k]), k
        assert pinned[k].base.is_pinned(), k
