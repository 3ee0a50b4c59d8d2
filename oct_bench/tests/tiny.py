"""A tiny copy of the benchmark for the CPU tests: the real metric readers,
traffic kinds and limits, with the configurations cut to a few rows and
samples and the mixes to a few frames."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]          # oct_bench/
REPO = HERE.parent

#: configuration → the fields changed for the CPU
SMALL = {
    "flagship-2048-u8": {"width": 256, "height": 24, "averages": 4, "numfftpoints": 256,
                         "numdisplaypoints": 96},
    "flir-spinjnt-720-u16": {"width": 96, "height": 20, "averages": 5, "numfftpoints": 384,
                             "numdisplaypoints": 48},
}
TRAFFIC = {
    "cscan-512": {"frames": 6, "warmup_volumes": 1, "traced_volumes": 2},
}


def make_root(dest: Path) -> Path:
    """``dest`` made a checkout root of the tiny benchmark; returns it."""
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    pkg = dest / "oct_bench"
    for sub in ("metrics", "limits", "traffic"):
        shutil.copytree(HERE / sub, pkg / sub, ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "configs").mkdir(parents=True)
    for c in bench["configs"]:
        conf = json.loads((REPO / c["file"]).read_text())
        conf["pipeline"].update(SMALL[c["name"]])
        (dest / c["file"]).write_text(json.dumps(conf))
    for name, change in TRAFFIC.items():
        mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
        mix.update(change)
        (pkg / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    (dest / "BENCHMARK.json").write_text(json.dumps(bench))
    return dest
