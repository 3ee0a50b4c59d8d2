"""A configuration, a traffic mix, a traffic kind and a cell added as new
files and ``BENCHMARK.json`` entries only, with no file that is there
edited: the new cell's tiny run is correct and reports the end-to-end
metric whose ``workloads`` lists it, and each fault planted in its timed
path reads ``correct`` false, through the helpers the benchmark's own cells
take.  A configuration, mix or kind without its tiny file is refused by
name."""

from __future__ import annotations

import hashlib
import json
import shutil
from pathlib import Path

import pytest

from oct_bench.catalog import Catalog
from oct_bench.tests.test_oct_bench_faults import (_frame_altered, _half, _stale,
                                                   assert_not_correct, run_broken)
from oct_bench.tests.test_oct_bench_harness import run_cpu
from oct_bench.tests.tiny import SMALL, make_root, small

CELL, CONFIG, MIX, KIND = "twin-highest-cscan4", "twin-2048-u8-highest", "twin-cscan-4", "twin"
SMALL_CONFIG = {"width": 128, "height": 16, "averages": 3, "numfftpoints": 128,
                "numdisplaypoints": 64}


def _write(path: Path, obj) -> None:
    path.write_text(json.dumps(obj))


def _digests(root: Path) -> dict[str, str]:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def grown(tmp_path_factory) -> Path:
    """A tiny tree grown by a new configuration, mix, kind and cell, as new
    files and entries; the tree made from it by ``make_root``."""
    base = make_root(tmp_path_factory.mktemp("base"))
    before, bench_before = _digests(base), json.loads((base / "BENCHMARK.json").read_text())
    pkg, tiny = base / "oct_bench", base / SMALL
    # the kind: a copy of cscan.py under another name, with its tiny file
    shutil.copy(pkg / "traffic/cscan.py", pkg / f"traffic/{KIND}.py")
    shutil.copy(tiny / "kinds/cscan.json", tiny / f"kinds/{KIND}.json")
    conf = json.loads((pkg / "configs/flagship-2048-u8.json").read_text())
    conf["name"] = CONFIG
    conf["pipeline"]["matmul_precision"] = "highest"
    _write(pkg / f"configs/{CONFIG}.json", conf)
    _write(tiny / f"configs/{CONFIG}.json", SMALL_CONFIG)
    _write(pkg / f"traffic/{MIX}.json", {"kind": KIND, "frames": 64, "host_volumes": 2,
                                         "warmup_volumes": 2, "traced_volumes": 3})
    _write(tiny / f"traffic/{MIX}.json", {"frames": 4, "warmup_volumes": 1,
                                          "traced_volumes": 2})
    shutil.copy(pkg / "limits/flagship-cscan512.json", pkg / f"limits/{CELL}.json")
    bench = json.loads((base / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": CONFIG, "source": "x", "reduced": [], "why": "x",
                             "file": f"oct_bench/configs/{CONFIG}.json"})
    bench["workloads"].append({"name": CELL, "config": CONFIG, "traffic": MIX, "chips": 1,
                               "why": "x"})
    rate = next(m for m in bench["end_to_end"] if m["name"] == "cscan_frames_per_s")
    rate["workloads"].append(CELL)
    _write(base / "BENCHMARK.json", bench)

    after = _digests(base)
    assert {k: after[k] for k in before if k != "BENCHMARK.json"} == \
        {k: v for k, v in before.items() if k != "BENCHMARK.json"}
    rate["workloads"].remove(CELL)
    for key in ("configs", "workloads"):
        bench[key].pop()
    assert bench == bench_before          # the entries only appended to
    return make_root(tmp_path_factory.mktemp("grown"), src=base)


def test_the_new_cell_is_cut_to_its_tiny_files(grown):
    cell = Catalog(grown).cell(CELL)
    assert {k: cell.config["pipeline"][k] for k in SMALL_CONFIG} == SMALL_CONFIG
    assert cell.traffic["kind"] == KIND and cell.traffic["frames"] == 4
    assert small(grown, "kinds", KIND) == small(grown, "kinds", "cscan")


@pytest.mark.parametrize("fault", [None, _half, _stale, _frame_altered],
                         ids=["sound", "half", "stale", "frame_altered"])
def test_a_cell_added_as_files_runs_and_its_faults_are_not_correct(grown, monkeypatch, capsys,
                                                                   fault):
    if fault is None:
        rc, out, _ = run_cpu(grown, monkeypatch, capsys, CELL)
        assert rc == 0 and out["correct"] is True and out["failed"] == 0
        assert "cscan_frames_per_s" in out["metrics"] and out["attempted"] > 0
    else:
        rc, out, _ = run_broken(grown, monkeypatch, capsys, CELL, fault)
        assert_not_correct(rc, out)


@pytest.mark.parametrize("sub", ["configs", "traffic", "kinds"])
def test_a_missing_tiny_file_names_what_was_looked_for(tmp_path, sub):
    src = make_root(tmp_path / "src")
    bench = json.loads((src / "BENCHMARK.json").read_text())
    name = {"configs": bench["configs"][0]["name"], "traffic": bench["workloads"][0]["traffic"],
            "kinds": Catalog(src).cell(bench["workloads"][0]["name"]).traffic["kind"]}[sub]
    path = src / SMALL / sub / f"{name}.json"
    path.unlink()
    with pytest.raises(FileNotFoundError) as e:
        if sub == "kinds":
            small(src, "kinds", name)
        else:
            make_root(tmp_path / "dest", src=src)
    assert repr(name) in str(e.value) and str(path) in str(e.value)
