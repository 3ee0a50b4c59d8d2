#!/usr/bin/env python3
"""The group kernels' instances of one checkout (kernel 1 on u8 and u16
frames and kernel 2, each with an f32 and a bf16 operator, the resident
kernel, and kernel 3's four outputs: db, mn, mx, linear), at fixed inputs:
their outputs saved for a bit-for-bit comparison with another checkout's.
Needs a GPU; bench_sessions.py times them.

    python3 kernel_outputs.py --tree DIR OUT.pt     # DIR: a checkout (default .)
    python3 kernel_outputs.py --compare A.pt B.pt   # exit 0 when every output is equal

Each tree builds its own kernels under its own ``build/``.  The inputs, made
from a seed with numpy: u8 frames, pi and inv_background as
``chip_smoke.random_problem`` draws them, and random float32 operators (and
their bf16 rounding), at the flagship (8 × 512 × 2048 → 512 depths),
chip_smoke.py's RAGGED shape and every ``ops.kernels.EDGE_SHAPES`` entry;
Mono16 frames (12-bit counts << 4) and a float32 ratio from the same
generator; for kernel 3 ``chip_smoke.int8_random_args`` from it after them
(a floor of -30 dB, the linear image asked for).
Compare two commits in one call, in turns: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import int8_random_args     # this checkout's, before --tree enters sys.path

SHAPES = {"flagship": (8, 512, 2048, 512), "ragged": (3, 100, 300, 77)}


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
        raw16 = torch.as_tensor((rng.integers(0, 4096, (B, rows, n_in)) << 4)
                                .astype(np.uint16)).to(dev)
        yr = torch.as_tensor(rng.normal(size=(B, rows, n_in))).to(dev, torch.float32)
        for op, (mr, mi) in ops.items():
            outputs[f"{label} raw_u8_{op}"] = kernels.fused_recon_raw_accumulate(
                raw, pi, inv, mr, mi).cpu()
            outputs[f"{label} raw_u16_{op}"] = kernels.fused_recon_raw_accumulate(
                raw16, pi, inv, mr, mi).cpu()
            outputs[f"{label} yr_f32_{op}"] = kernels.fused_recon_accumulate(yr, mr, mi).cpu()
        outputs[f"{label} resident"] = kernels.fused_recon_resident(raw, pi, inv, *f32).cpu()
        i8 = int8_random_args((B, rows, n_in, ndisp), rng, dev)
        k3 = kernels.int8_bscan_display_fused(*i8, -30.0, B, with_linear=True)
        for part in k3._fields:
            outputs[f"{label} int8_{part}"] = getattr(k3, part).cpu()
    torch.cuda.synchronize()
    torch.save(outputs, str(out))
    print(f"{tree}: {len(outputs)} outputs saved to {out}")


def compare(a: Path, b: Path) -> int:
    got, want = torch.load(str(a)), torch.load(str(b))
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
