"""The readings the limits of the comparison are set from: one cell, many
seeds, in one process.

    python3 -m oct_bench.readings --workload <cell> --seeds 11,12,13 \\
        --seconds 3 [--precision <p> | --control] [--trace 1]

prints one JSON line a seed: the seed, the precision, every number the
comparison can take (``readings``), ``correct`` under the cell's limits
file, and the run's metrics.  ``--control`` runs the configuration's
``control_precision``, the next precision below the one it states.  Each
seed's run is a whole run of the cell at its own load and size with a
shorter window; only ``setup_s`` means nothing after the first seed.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from oct_bench import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m oct_bench.readings")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--precision", default=None)
    p.add_argument("--control", action="store_true")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    root = Path.cwd()
    run.fix_cache_dirs(root)
    precision = a.precision
    if a.control:
        from oct_bench.catalog import Catalog
        precision = Catalog(root).cell(a.workload).config["control_precision"]
    for seed in (int(s) for s in a.seeds.split(",")):
        argv1 = ["--workload", a.workload, "--seed", str(seed), "--seconds", str(a.seconds),
                 "--trace", str(a.trace)] + (["--precision", precision] if precision else [])
        try:
            out = run.execute(run.parse(argv1), root)
        except run.NoResult as e:
            print(f"oct_bench: no result: {e}", file=sys.stderr)
            return 2
        print(json.dumps({"seed": seed, "precision": precision or "configured",
                          "correct": out["correct"], "readings": out.pop("_readings"),
                          **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
