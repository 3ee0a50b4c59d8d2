"""CPU tests of the benchmark harness: each traffic mix run end to end at a
tiny size, the result line's keys, the reference against the port, the
JAX-free guard, the bounds and the look-up by name.

    python -m pytest oct_bench/tests -q

The tests marked ``cuda`` skip here; on the card they run with
``python -m pytest --noconftest -m cuda oct_bench/tests``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

from oct_bench import bounds, guard, judge, run
from oct_bench.catalog import Catalog
from oct_bench.reference import RefConfig, cscan_views, volume
from oct_bench.tests.tiny import REPO, make_root, small

CELLS = [w["name"] for w in Catalog(REPO).bench["workloads"]]
#: the configurations of the cells whose traffic kind is ``cscan``
CSCAN_CONFIGS = list(dict.fromkeys(c.workload["config"] for c in map(Catalog(REPO).cell, CELLS)
                                   if c.traffic["kind"] == "cscan"))
SEED = 3_000_000_019                # larger than 32 signed bits hold


@pytest.fixture(scope="module")
def root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("bench"))


def run_cpu(root: Path, monkeypatch, capsys, workload: str, trace: int = 0, seed: int = SEED,
            extra=()) -> tuple[int, dict | None, str]:
    """``run.main`` of one tiny cell on the CPU (the look for a card
    skipped): (exit code, the last stdout line's object, stderr)."""
    monkeypatch.setattr(run, "require_devices", lambda chips: torch.device("cpu"))
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds", "0.5",
                   "--trace", str(trace), *extra], root=root)
    cap = capsys.readouterr()
    lines = cap.out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), cap.err


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_run_prints_the_contract_line(root, monkeypatch, capsys, workload, trace):
    rc, out, err = run_cpu(root, monkeypatch, capsys, workload, trace)
    assert rc == 0
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    cat = Catalog(root)
    named = cat.per_layer(workload) if trace else cat.end_to_end(workload)
    units = {m["name"]: m["unit"] for m in named}
    assert out["metrics"] and set(out["metrics"]) <= set(units)
    if not trace:
        assert set(out["metrics"]) == set(units)
    for name, m in out["metrics"].items():
        assert m["unit"] == units[name] and math.isfinite(m["value"])
    assert out["checks"] and all(c["value"] <= c["limit"] for c in out["checks"].values())
    assert err.strip().splitlines()[-len(out["checks"]):] == [
        f"check {k} = {c['value']} (limit {c['limit']})" for k, c in out["checks"].items()]
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert out["device"]["window_s"] > 0


def test_same_seed_same_inputs(root, monkeypatch, capsys):
    from oct_bench import frames
    from fdoct_tpu_torch.config import PipelineConfig
    cfg = PipelineConfig(**Catalog(root).cell("flir-cscan512").config["pipeline"])
    cpu = torch.device("cpu")
    a, b = (frames.sample_frames(cfg, 3, frames.generator(SEED, cpu), cpu) for _ in range(2))
    c = frames.sample_frames(cfg, 3, frames.generator(SEED + 1, cpu), cpu)
    assert a.dtype == torch.uint16 and torch.equal(a, b) and not torch.equal(a, c)
    assert len({bytes(f.numpy()) for f in a}) == 3             # frames differ
    assert len({bytes(r.numpy()) for r in a[0]}) == cfg.height  # rows differ


def test_no_card_no_result(root, capsys):
    assert run.main(["--workload", "flagship-cscan512", "--seed", "1", "--seconds", "1"],
                    root=root) == 2
    assert capsys.readouterr().out == ""


def test_no_program_no_result(root, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "fdoct_tpu_torch", None)     # import fails
    rc, out, err = run_cpu(root, monkeypatch, capsys, "flagship-cscan512")
    assert rc == 2 and out is None and "not importable" in err


def test_a_loaded_jax_fails_the_run(root, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, out, err = run_cpu(root, monkeypatch, capsys, "flagship-cscan512")
    assert rc == 2 and out is None and "jax" in err


@pytest.mark.parametrize("where", ["reader", "comparison"])
def test_jax_loaded_after_the_window_fails_the_run(root, monkeypatch, capsys, where):
    """A per-layer reader or the comparison, which run after the window has
    closed, loading a forbidden module: no result."""
    def plant():
        monkeypatch.setitem(sys.modules, "fdoct_tpu", types.ModuleType("fdoct_tpu"))

    if where == "reader":
        def reader(self, metric):
            def read(layer):
                plant()
                return 1.0
            return read
        monkeypatch.setattr(Catalog, "reader", reader)
    else:
        readings = judge.readings

        def planting(*a, **kw):
            plant()
            return readings(*a, **kw)
        monkeypatch.setattr(judge, "readings", planting)
    rc, out, err = run_cpu(root, monkeypatch, capsys, "flagship-cscan512",
                           trace=int(where == "reader"))
    assert rc == 2 and out is None and "fdoct_tpu" in err


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_loaded(["fdoct_tpu_torch", "fdoct_tpu_torch.session", "jaxtyping",
                                   "numpy"]) == []
    assert guard.forbidden_loaded(["jax.numpy", "fdoct_tpu_torch"]) == ["jax"]
    assert guard.forbidden_loaded(["fdoct_tpu.session", "jaxlib", "flax.linen"]) == [
        "fdoct_tpu", "flax", "jaxlib"]


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, oct_bench.reference, oct_bench.judge, oct_bench.frames; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'fdoct_tpu_torch', 'fdoct_tpu', 'jax', 'jaxlib', 'flax'}))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, check=True)
    assert res.stdout.strip() == "[]"


def test_bounds_at_the_flagship():
    from fdoct_tpu_torch.config import PipelineConfig
    conf = json.loads((REPO / "oct_bench/configs/flagship-2048-u8.json").read_text())
    vol, by = bounds.volume_bound(PipelineConfig(**conf["pipeline"]), 512)
    assert by == "operations" and round(vol * 1e3, 3) == 1.112


@pytest.mark.parametrize("config", CSCAN_CONFIGS)
def test_reference_agrees_with_the_port(root, config):
    """The port's 'highest' C-scan volume and its views on the CPU against
    the reference, on the tiny configuration."""
    from fdoct_tpu_torch.calibration import Calibration
    from fdoct_tpu_torch.config import PipelineConfig
    from fdoct_tpu_torch.ops import normalize_minmax, to_db, to_uint8
    from fdoct_tpu_torch.parallel.sharded import sharded_cscan_volume
    from fdoct_tpu_torch.volume import enface_projection, surface_map
    from oct_bench import frames
    conf = json.loads((root / Catalog(root)._entry("configs", config)["file"]).read_text())
    cfg = PipelineConfig(**{**conf["pipeline"], "matmul_precision": "highest"})
    cpu = torch.device("cpu")
    g = frames.generator(SEED, cpu)
    raw = frames.sample_frames(cfg, cfg.averages, g, cpu)
    bg = frames.background_frames(cfg, 1, g, cpu)[0].to(torch.float32)
    pi = frames.sample_frames(cfg, 1, g, cpu, r_ref=-1.0)[0].to(torch.float32)
    calib = Calibration.create(cfg, cpu)
    rc = RefConfig.from_pipeline(conf["pipeline"])
    vol = sharded_cscan_volume(raw, bg, pi, calib, cfg)
    ref = volume(raw.to(torch.int32), bg, pi, rc)
    rel = ((vol.double() - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)).max()
    assert rel < 1e-5
    views = cscan_views(ref, rc.compat)
    assert views["frames"].shape[0] == len(range(0, cfg.averages, max(1, cfg.averages // 8)))
    db = to_db(vol + 1e-5, eps=0.0, compat=cfg.compat)
    mip = to_uint8(normalize_minmax(enface_projection(db, "max")))
    assert (mip.int() - views["mip"].int()).abs().max() <= 1
    assert torch.equal(surface_map(vol).long(), views["surface"].long())


def test_a_config_file_is_found_by_name(root, tmp_path):
    """A configuration, a cell, a traffic kind and a per-layer metric added
    as files and entries, with no edit to the harness."""
    new = make_root(tmp_path / "more")
    conf = json.loads((new / "oct_bench/configs/flagship-2048-u8.json").read_text())
    conf["name"] = "flagship-2048-u8-highest"
    conf["pipeline"]["matmul_precision"] = "highest"
    (new / "oct_bench/configs/flagship-2048-u8-highest.json").write_text(json.dumps(conf))
    (new / "oct_bench/metrics/cscan.volumes.py").write_text(
        "def read(layer):\n    return float(layer['units'])\n")
    bench = json.loads((new / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": conf["name"], "source": "x", "reduced": [], "why": "x",
                             "file": "oct_bench/configs/flagship-2048-u8-highest.json"})
    bench["workloads"].append({"name": "flagship-highest-cscan512", "config": conf["name"],
                               "traffic": "cscan-512", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "cscan.volumes", "unit": "volumes", "better": "higher",
                               "source": "host_clock", "layer": "C-scan volume",
                               "moves": "cscan_frames_per_s",
                               "workloads": ["flagship-highest-cscan512"]})
    (new / "BENCHMARK.json").write_text(json.dumps(bench))
    cat = Catalog(new)
    cell = cat.cell("flagship-highest-cscan512")
    assert cell.pipeline().matmul_precision == "highest" and cell.traffic["kind"] == "cscan"
    assert "cscan.volumes" in [m["name"] for m in cat.per_layer("flagship-highest-cscan512")]
    assert "cscan.volumes" not in [m["name"] for m in cat.per_layer("flagship-cscan512")]
    assert cat.reader("cscan.volumes")({"units": 3}) == 3.0
    assert [m["name"] for m in cat.end_to_end("flagship-highest-cscan512")] == ["setup_s"]
    (new / "oct_bench/traffic/echo.py").write_text(
        "def run(*a):\n    return 'ran'\n\ndef readings(check, rc, device):\n"
        "    return {'n': 1.0}\n")
    kind = cat.kind("echo")
    assert kind.run() == "ran" and kind.readings({}, None, None) == {"n": 1.0}
    assert cat.kind("cscan").run.__module__ != kind.run.__module__


def test_decide_fails_a_missing_or_nan_number():
    limits = {"checks": {"mip_mean_gap": 0.5}}
    assert judge.decide({"mip_mean_gap": 0.1}, limits)[0]
    assert not judge.decide({"mip_mean_gap": 0.6}, limits)[0]
    assert not judge.decide({"mip_mean_gap": math.nan}, limits)[0]
    assert not judge.decide({}, limits)[0]
    assert not judge.decide({"mip_mean_gap": 0.1}, {})[0]


def test_every_limits_file_names_numbers_the_judge_gives(root):
    cat = Catalog(root)
    assert [w["name"] for w in cat.bench["workloads"]] == CELLS
    for w in cat.bench["workloads"]:
        cell = cat.cell(w["name"])
        names = set(small(root, "kinds", cell.traffic["kind"])["checks"])
        assert cell.limits["checks"], w["name"]
        assert set(cell.limits["checks"]) <= names, w["name"]
