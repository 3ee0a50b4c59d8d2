"""Everything of a cell found by name: the harness holds no list of cells.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix; the files are

- ``oct_bench/configs/<config>.json`` (the configuration entry's ``file``):
  ``pipeline`` (the program's configuration fields), ``session_variant``,
  ``control_precision`` and the source's notes;
- ``oct_bench/traffic/<traffic>.json``: ``kind`` and its parameters;
- ``oct_bench/traffic/<kind>.py``: the code of a traffic kind, its
  ``run`` and its ``readings`` (:mod:`oct_bench.generator`);
- ``oct_bench/limits/<workload>.json``: each number the comparison with the
  reference holds the cell to, with its limit;
- ``oct_bench/metrics/<metric>.py``: one reader per per-layer metric.

A later change adds a configuration, a mix, a traffic kind, a cell or a
metric by adding its files and its entry in ``BENCHMARK.json``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

PACKAGE = "oct_bench"


@dataclasses.dataclass
class Cell:
    root: Path
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    precision: str | None = None          # a run at another precision (the control)

    @property
    def name(self) -> str:
        return self.workload["name"]

    def pipeline(self):
        """The program's configuration object of this cell."""
        from fdoct_tpu_torch.config import PipelineConfig
        cfg = PipelineConfig(**self.config["pipeline"])
        if self.precision:
            cfg = cfg.replace(matmul_precision=self.precision)
        return cfg.validate()


class Catalog:
    def __init__(self, root: Path | str = "."):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def _entry(self, key: str, name: str) -> dict:
        for e in self.bench[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"no {key[:-1]} named {name!r} in BENCHMARK.json")

    def _json(self, *parts: str) -> dict:
        return json.loads(self.root.joinpath(*parts).read_text())

    def cell(self, workload: str, precision: str | None = None) -> Cell:
        w = self._entry("workloads", workload)
        conf = self._entry("configs", w["config"])
        limits_file = self.root / PACKAGE / "limits" / f"{workload}.json"
        return Cell(self.root, w, self._json(conf["file"]),
                    self._json(PACKAGE, "traffic", f"{w['traffic']}.json"),
                    json.loads(limits_file.read_text()) if limits_file.exists() else {},
                    precision)

    def end_to_end(self, workload: str) -> list[dict]:
        """The end-to-end metrics this cell reports."""
        return [m for m in self.bench["end_to_end"]
                if workload in m.get("workloads", [workload])]

    def per_layer(self, workload: str) -> list[dict]:
        """The per-layer metrics this cell reports: those that list it, and
        those with no list whose end-to-end metric it reports."""
        e2e = {m["name"] for m in self.end_to_end(workload)}
        return [m for m in self.bench["per_layer"]
                if (workload in m["workloads"] if "workloads" in m else m["moves"] in e2e)]

    def _module(self, sub: str, name: str):
        path = self.root / PACKAGE / sub / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"{PACKAGE}_{sub}_{name.replace('.', '_').replace('-', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def kind(self, name: str):
        """The module of traffic kind ``name``: ``run`` and ``readings``."""
        return self._module("traffic", name)

    def reader(self, metric: str):
        """The ``read(layer) -> float | None`` function of a per-layer metric."""
        return self._module("metrics", metric).read
