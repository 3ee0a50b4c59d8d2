"""A tiny copy of the benchmark for the CPU tests: the real metric readers,
traffic kinds and limits, with every configuration and mix that
``BENCHMARK.json`` names cut by its file under ``tests/small/``, found by
name:

- ``small/configs/<config>.json``: the ``pipeline`` fields changed for the
  CPU (a few rows and samples);
- ``small/traffic/<mix>.json``: the mix's fields changed (a few frames);
- ``small/kinds/<kind>.json``: ``timed``, the ``[module, function]`` pairs
  of the program whose results the kind's timed path returns (where the
  tests plant their faults), and ``checks``, the numbers its ``readings``
  gives.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # oct_bench/
REPO = HERE.parent
SMALL = Path("oct_bench/tests/small")               # under a checkout's root


def small(root: Path, sub: str, name: str) -> dict:
    """The file ``small/<sub>/<name>.json`` of the checkout at ``root``."""
    path = Path(root) / SMALL / sub / f"{name}.json"
    if not path.exists():
        what = {"configs": "configuration", "traffic": "traffic mix", "kinds": "traffic kind"}
        raise FileNotFoundError(f"no tiny file for {what[sub]} {name!r}: {path} is missing")
    return json.loads(path.read_text())


def make_root(dest: Path, src: Path = REPO) -> Path:
    """``dest`` made a checkout root of the tiny benchmark of the checkout at
    ``src``; returns it."""
    src = Path(src)
    bench = json.loads((src / "BENCHMARK.json").read_text())
    pkg = dest / "oct_bench"
    for sub in ("metrics", "limits", "traffic", "tests/small"):
        shutil.copytree(src / "oct_bench" / sub, pkg / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    for c in bench["configs"]:
        conf = json.loads((src / c["file"]).read_text())
        conf["pipeline"].update(small(src, "configs", c["name"]))
        (dest / c["file"]).parent.mkdir(parents=True, exist_ok=True)
        (dest / c["file"]).write_text(json.dumps(conf))
    for name in sorted({w["traffic"] for w in bench["workloads"]}):
        mix = json.loads((src / "oct_bench/traffic" / f"{name}.json").read_text())
        mix.update(small(src, "traffic", name))
        (pkg / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest
