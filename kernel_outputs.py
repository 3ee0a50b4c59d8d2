#!/usr/bin/env python3
"""Kernel 1's u8 instances and the resident kernel of one checkout, at fixed
inputs: their outputs saved for a bit-for-bit comparison with another
checkout's, and kernel 1's back-to-back times.  Needs a GPU.

    python3 kernel_outputs.py --tree DIR OUT.pt     # DIR: a checkout (default .)
    python3 kernel_outputs.py --compare A.pt B.pt   # exit 0 when every output is equal

Each tree builds its own kernels under its own ``build/``.  The inputs, made
from a seed with numpy: u8 frames, pi and inv_background as
``chip_smoke.random_problem`` draws them, and random float32 operators (and
their bf16 rounding), at the flagship (8 × 512 × 2048 → 512 depths),
chip_smoke.py's RAGGED shape and every ``ops.kernels.EDGE_SHAPES`` entry.
Compare two commits in one call, in turns: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import statistics
import sys
from pathlib import Path

import numpy as np
import torch

SHAPES = {"flagship": (8, 512, 2048, 512), "ragged": (3, 100, 300, 77)}
B2B = 10
RUNS = 20


def b2b_ms(fn) -> tuple[float, float, float]:
    """Median, min and max ms per call of RUNS samples of B2B back-to-back
    calls, CUDA events, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(RUNS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(B2B):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / B2B)
    return statistics.median(times), min(times), max(times)


def save(tree: Path, out: Path) -> None:
    sys.path.insert(0, str(tree))
    from fdoct_tpu_torch.ops import kernels
    if Path(kernels.__file__).resolve().parents[2] != tree:
        raise RuntimeError(f"imported {kernels.__file__}, not the tree {tree}")
    dev = torch.device("cuda")
    outputs = {}
    for label, (B, rows, n_in, ndisp) in {**SHAPES, **kernels.EDGE_SHAPES}.items():
        rng = np.random.default_rng(7)
        raw = torch.as_tensor(rng.integers(0, 255, (B, rows, n_in), dtype=np.uint8)).to(dev)
        pi = torch.as_tensor(rng.uniform(0, 50, (rows, n_in))).to(dev, torch.float32)
        inv = torch.as_tensor(1.0 / rng.uniform(50, 200, (rows, n_in))).to(dev, torch.float32)
        f32 = tuple(torch.as_tensor(rng.normal(size=(n_in, ndisp))).to(dev, torch.float32)
                    for _ in range(2))
        ops = {"f32": f32, "bf16": tuple(m.to(torch.bfloat16) for m in f32)}
        for op, (mr, mi) in ops.items():
            outputs[f"{label} raw_u8_{op}"] = kernels.fused_recon_raw_accumulate(
                raw, pi, inv, mr, mi).cpu()
        outputs[f"{label} resident"] = kernels.fused_recon_resident(raw, pi, inv, *f32).cpu()
        if label == "flagship":
            for op, (mr, mi) in ops.items():
                t = b2b_ms(lambda: kernels.fused_recon_raw_accumulate(raw, pi, inv, mr, mi))
                print(f"{tree}: kernel 1 u8 {op} flagship, {B2B} back-to-back calls a sample: "
                      f"median {t[0]:.4f} ms (min {t[1]:.4f}, max {t[2]:.4f})", flush=True)
    torch.cuda.synchronize()
    torch.save(outputs, out)
    print(f"{tree}: {len(outputs)} outputs saved to {out}")


def compare(a: Path, b: Path) -> int:
    got, want = torch.load(a), torch.load(b)
    if got.keys() != want.keys():
        print(f"different outputs: {sorted(got.keys() ^ want.keys())}")
        return 1
    differ = [k for k in got if not torch.equal(got[k], want[k])]
    print(f"{len(got) - len(differ)} of {len(got)} outputs bit-equal"
          + (f"; differ: {differ}" if differ else ""))
    return 1 if differ else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=".", help="the checkout whose kernels run")
    ap.add_argument("--compare", action="store_true", help="compare two saved output files")
    ap.add_argument("files", nargs="+", help="OUT.pt, or A.pt B.pt with --compare")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*map(Path, args.files))
    if not torch.cuda.is_available():
        print("kernel_outputs: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 1
    save(Path(args.tree).resolve(), Path(args.files[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
