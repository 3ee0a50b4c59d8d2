"""Run one cell of the benchmark once and print its result line.

    python3 -m oct_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``oct_bench/``
and the program, ``fdoct_tpu_torch/``.  The run sets up (the frames from
the seed, the calibration, any kernel the program builds, once per
checkout, into ``build/fdoct_tpu_torch/``), warms up, measures for
``--seconds``, checks what the timed path produced against the plain
reference and prints, as the last line of its standard output, one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device`` and, last, ``checks`` (each compared number
beside its limit); with ``--trace 1`` also ``breakdown``.  The compared
numbers are also the last lines of its standard error.

It exits non-zero, and prints no result, without a CUDA card (or with
fewer than the cell asks for), without the program, or if JAX or the JAX
package (``jax``, ``jaxlib``, ``flax``, ``fdoct_tpu``, by whole top-level
name) was loaded.  ``--precision`` runs the cell at another matmul
precision (the control of the comparison); the checks keep their limits.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

#: build and kernel caches, fixed directories inside the checkout
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/oct_bench/torch_extensions",
              "TRITON_CACHE_DIR": "build/oct_bench/triton",
              "CUDA_CACHE_PATH": "build/oct_bench/nv_compute_cache"}


class NoResult(Exception):
    """A run that must print no result line."""


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m oct_bench.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--precision", default=None,
                   help="run at this matmul_precision instead of the configuration's")
    return p.parse_args(argv)


def fix_cache_dirs(root: Path) -> None:
    for var, rel in CACHE_DIRS.items():
        path = (root / rel).resolve()
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)


def require_devices(chips: int):
    """The CUDA device of the run; :class:`NoResult` without ``chips`` cards."""
    import torch
    if not torch.cuda.is_available():
        raise NoResult("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoResult(f"the cell asks for {chips} cards, {torch.cuda.device_count()} present")
    return torch.device("cuda", 0)


def device_info(device, count: int, peak: int) -> dict:
    import torch
    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
            "count": count, "memory_peak_bytes": peak}


def _num(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else None


def refuse_forbidden(when: str) -> None:
    """:class:`NoResult` if JAX or the JAX package is in ``sys.modules``."""
    from oct_bench import guard
    found = guard.forbidden_loaded()
    if found:
        raise NoResult(f"forbidden modules loaded {when}: {found}")


def execute(args, root: Path, device=None) -> dict:
    """One run; returns the result object.  ``device`` skips the look for a
    card (the harness's tests drive the rest of a run on the CPU)."""
    from oct_bench import generator, judge
    from oct_bench.catalog import Catalog

    cat = Catalog(root)
    cell = cat.cell(args.workload, args.precision)
    chips = int(cell.workload.get("chips", 1))
    if device is None:
        device = require_devices(chips)
    try:
        import fdoct_tpu_torch  # noqa: F401
    except ImportError as e:
        raise NoResult(f"the program is not importable: {e}") from e
    kind = cat.kind(cell.traffic["kind"])
    if device.type == "cuda":
        import torch
        torch.zeros(1, device=device)        # the allocator's stats exist once it has allocated
        torch.cuda.reset_peak_memory_stats(device)
        generator.mark(T_START, "CUDA ready")
    run = kind.run(cell, args.seed, args.seconds, bool(args.trace), device, T_START)
    refuse_forbidden("once the window closed")
    gc.collect()
    if device.type == "cuda":
        import torch
        torch.cuda.empty_cache()
    generator.mark(T_START, "window closed, program state freed")
    values = judge.readings(kind, run.check, cell.config["pipeline"], device)
    generator.mark(T_START, "compared with the reference")
    correct, checks = judge.decide(values, cell.limits)
    dev = device_info(device, chips, run.memory_peak_bytes)
    breakdown = None
    if args.trace:
        metrics = {}
        for m in cat.per_layer(args.workload):
            v = cat.reader(m["name"])(run.layer)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        tr = run.layer.get("trace") or {}
        if tr.get("units"):
            dev["busy_s"] = tr["busy_us"] / 1e6
            dev["window_s"] = tr["window_us"] / 1e6
            breakdown = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    else:
        units = {m["name"]: m["unit"] for m in cat.end_to_end(args.workload)}
        metrics = {k: {"value": v, "unit": units[k]} for k, v in run.e2e.items() if k in units}
    out = {"correct": bool(correct), "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": _num(c["value"]), "limit": c["limit"]}
                     for k, c in checks.items()}
    out["_readings"] = values
    return out


def main(argv=None, root: Path | None = None) -> int:
    args = parse(argv)
    root = Path(root or Path.cwd())
    fix_cache_dirs(root)
    try:
        out = execute(args, root)
        # the comparison and the per-layer readers run after the first look
        refuse_forbidden("by the comparison or the per-layer readers")
    except NoResult as e:
        print(f"oct_bench: no result: {e}", file=sys.stderr)
        return 2
    out.pop("_readings")
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
