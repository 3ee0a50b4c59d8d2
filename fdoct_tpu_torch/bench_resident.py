"""The resident-operator benchmark: every reconstruction route of one
averaging group, side by side, at the flagship shape.

The port's counterpart of ``scripts/bench_resident.py``: 8 frames of 512 × 2048
u8 counts per group, NFFT 2048, 512 depths, λ 816–884 nm, compat, float32;
π = 0, background 128 (1/y_b = 1/128), frames drawn on the device from a
seeded ``torch.Generator``.  Rows, each one group's Σ_b |ratio(raw[b]) @ M|:

- ``fused_f32``: ``reconstruct(..., method="fused")`` at 'highest' (TF32 off),
  the elementwise reference of every other row;
- ``fused_default``: the same at 'default' (bf16 on CUDA, float32 on the CPU);
- ``int8``: 'int8' with its own ``Calibration`` (the int8 operator tables);
- ``int8_direct``: ``Int8DirectPlan`` + ``reconstruct_int8_direct``;
- ``bf16``: plain torch, the ratio and M rounded to bf16, float32 products
  (``fused_recon_resident_reference``, the resident kernel's plain version);
- ``yr``: ``fused_recon_accumulate`` on a float32 ratio, float32 M;
- ``raw_f32``, ``raw_bf16``: ``fused_recon_raw_accumulate``, float32 and bf16 M;
- ``resident``: ``fused_recon_resident``, the bf16 M passed in (no cast timed).

``--quick`` stops after the first four rows.  Each row is held to the
reference: max |row − fused_f32| / max |fused_f32| below 5e-2 on one group.
A row that raises stops the run; a row over its limit makes it fail after
every row has printed.

Times (CUDA only): CUDA events around each call, median, min and max of 20
calls after 3 warm-up calls, in ms per group and M A-scans/s, two ways:
*hot*, the same group every call, operator and frames in the 50 MB L2; and
*streamed*, every call the next of 32 distinct groups on the device (256 MiB,
more than the L2 holds), so each call finds its frames cold.  On the CPU the
rows are computed and checked, and no time is taken.

    python -m fdoct_tpu_torch.bench_resident [--quick] [--device cuda]
    python -m fdoct_tpu_torch.bench_resident --device cpu --small
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import statistics
import subprocess
import sys
from collections.abc import Callable, Iterator

import numpy as np
import torch

from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.int8direct import Int8DirectPlan, reconstruct_int8_direct, shift_u8_to_s8
from fdoct_tpu_torch.ops.kernels import (
    fused_recon_accumulate, fused_recon_raw_accumulate, fused_recon_resident,
    fused_recon_resident_reference,
)
from fdoct_tpu_torch.pipeline import reconstruct

FLAGSHIP = dict(height=512, width=2048, numfftpoints=2048, numdisplaypoints=512)
SMALL = dict(height=32, width=256, numfftpoints=512, numdisplaypoints=128)
BATCH = 8
RUNS = 20
WARMUP = 3
STREAM_GROUPS = 32
RTOL = 5e-2
QUICK_ROWS = 4
SEED = 0


@dataclasses.dataclass
class Row:
    name: str
    out: torch.Tensor                          # (rows, ndisp) of the hot group
    err: float                                 # max |out − ref| / max |ref|
    hot: tuple[float, float, float] | None     # ms per group: median, min, max
    streamed: tuple[float, float, float] | None


def config(shape: dict) -> PipelineConfig:
    return PipelineConfig(**shape, binvalue=1, averages=BATCH, lambdamin=816e-9,
                          lambdamax=884e-9, increasefftpointsmultiplier=1,
                          dtype="float32", compat=True)


def row_functions(cfg: PipelineConfig, device: torch.device,
                  quick: bool = False) -> dict[str, Callable[[torch.Tensor], torch.Tensor]]:
    """name → group function (B, rows, cols) uint8 → (rows, ndisp) float32."""
    shape = (cfg.height, cfg.width)
    calib = Calibration.create(cfg, device)
    bg = torch.full(shape, 128.0, device=device)
    pi = torch.zeros(shape, device=device)
    invb = torch.full(shape, 1 / 128.0, device=device)
    highest = cfg.replace(matmul_precision="highest")
    cfg8 = cfg.replace(matmul_precision="int8")
    calib8 = Calibration.create(cfg8, device)
    cfgd = cfg.replace(matmul_precision="int8_direct")
    plan = Int8DirectPlan.create(calib, cfgd, np.full(shape, 128.0), np.zeros(shape),
                                 device=device)
    rows = {
        "fused_f32": lambda fr: reconstruct(fr, bg, pi, calib, highest).sum(0),
        "fused_default": lambda fr: reconstruct(fr, bg, pi, calib, cfg).sum(0),
        "int8": lambda fr: reconstruct(fr, bg, pi, calib8, cfg8).sum(0),
        "int8_direct": lambda fr: reconstruct_int8_direct(shift_u8_to_s8(fr), plan).sum(0),
    }
    if quick:
        return rows
    op, op16 = (calib.op_re, calib.op_im), (calib.op_re_bf16, calib.op_im_bf16)
    rows.update({
        "bf16": lambda fr: fused_recon_resident_reference(fr, pi, invb, *op16),
        "yr": lambda fr: fused_recon_accumulate((fr.float() - pi) * invb, *op),
        "raw_f32": lambda fr: fused_recon_raw_accumulate(fr, pi, invb, *op),
        "raw_bf16": lambda fr: fused_recon_raw_accumulate(fr, pi, invb, *op16),
        "resident": lambda fr: fused_recon_resident(fr, pi, invb, *op16),
    })
    return rows


def cuda_ms(fn: Callable[[torch.Tensor], torch.Tensor],
            groups: Iterator[torch.Tensor]) -> tuple[float, float, float]:
    """Median, min and max ms of RUNS calls after WARMUP, each on the next
    group of ``groups`` and timed alone with CUDA events."""
    for _ in range(WARMUP):
        fn(next(groups))
    times = []
    for _ in range(RUNS):
        fr = next(groups)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(fr)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), min(times), max(times)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _times(label: str, t: tuple[float, float, float] | None, ascans: int) -> str:
    if t is None:
        return f"{label} not measured"
    return (f"{label} median {t[0]:.4f} ms (min {t[1]:.4f}, max {t[2]:.4f}) = "
            f"{ascans / t[0] / 1e3:.2f} M A-scans/s")


def run(device: torch.device | str = "cuda", *, small: bool = False, quick: bool = False,
        card: str | None = None, log: Callable[[str], None] = print) -> dict[str, Row]:
    """Every row on one group, checked against ``fused_f32``, and on CUDA
    timed hot and streamed.  Raises if a row is over its limit."""
    device = torch.device(device)
    timed = device.type == "cuda"
    if timed:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        card = card or card_line()
    cfg = config(SMALL if small else FLAGSHIP)
    fns = row_functions(cfg, device, quick)
    gen = torch.Generator(device=device).manual_seed(SEED)
    # groups[0] is the hot group; the rest are only streamed through
    groups = torch.randint(0, 255, (STREAM_GROUPS if timed else 1, BATCH, cfg.height,
                                    cfg.width), dtype=torch.uint8, generator=gen,
                           device=device)
    ascans = BATCH * cfg.height
    stream = itertools.cycle(list(groups))
    log(f"[bench_resident] {device} | {BATCH} x {cfg.height} x {cfg.width} u8 per group, "
        f"NFFT {cfg.numfftpoints}, {cfg.numdisplaypoints} depths | "
        f"{'20 timed calls after 3 warm-up, CUDA events' if timed else 'no times on the CPU'}"
        + (f" | streamed over {STREAM_GROUPS} groups "
           f"({groups.numel() / 2**20:.0f} MiB) | {card}" if timed else ""))
    out: dict[str, Row] = {}
    ref = None
    for name, fn in fns.items():
        got = fn(groups[0])
        if ref is None:
            ref = got.double()
        err = float((got.double() - ref).abs().max() / (ref.abs().max() + 1e-9))
        hot = cuda_ms(fn, itertools.repeat(groups[0])) if timed else None
        streamed = cuda_ms(fn, stream) if timed else None
        out[name] = Row(name, got, err, hot, streamed)
        ok = bool(torch.isfinite(got).all()) and err < RTOL
        log(f"[bench_resident] {name}: max rel err vs fused_f32 {err:.3e} "
            f"({'ok' if ok else 'MISMATCH'}, limit {RTOL}); {_times('hot', hot, ascans)}; "
            f"{_times('streamed', streamed, ascans)}" + (f" | {card}" if timed else ""))
    del groups, stream
    if timed:
        torch.cuda.empty_cache()
    bad = [r.name for r in out.values()
           if not (bool(torch.isfinite(r.out).all()) and r.err < RTOL)]
    if bad:
        raise RuntimeError(f"rows disagree with fused_f32 beyond {RTOL}: {bad}")
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fdoct_tpu_torch.bench_resident",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help=f"only the first {QUICK_ROWS} rows (the non-kernel routes)")
    ap.add_argument("--device", default="cuda", help="cuda (timed) or cpu (checks only)")
    ap.add_argument("--small", action="store_true",
                    help="32 x 256 frames, NFFT 512, 128 depths instead of the flagship")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_resident: no CUDA device", file=sys.stderr)
        return 1
    run(device, small=args.small, quick=args.quick,
        log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
