#!/usr/bin/env python3
"""Group-kernel times and accuracy and session times of the PyTorch/CUDA
port at the flagship shape, for one source tree, on one NVIDIA GPU.

    python3 bench_sessions.py [--tree DIR] [--kernels-only]

DIR (default: the directory of this file) is a checkout of the repository;
its ``fdoct_tpu_torch`` is imported, built and measured.  So one call can
measure two commits in turns with the same measuring code: unpack the other
commit with ``git archive <commit> | tar -x -C build/parent`` and run
parent, change, change, parent (``--tree build/parent``, no flag, no flag,
``--tree build/parent``), each in its own process.  Only entry points that
every commit of the port has are used: ``Session``, ``Calibration.create``,
``SyntheticSource`` and the three group-kernel wrappers.  The measuring
functions are chip_smoke.py's.

Flagship: 8 frames of 512 x 2048 u8 per group, 512 depths, the operator of
``Calibration.create``, synthetic frames (seed 0), TF32 off.  Measured:

- kernels: the four instances of the two group kernels (raw u8 frames or an
  f32 ratio, against a bf16 or an f32 operator), CUDA events, median of 20
  single calls ("ms") and of 20 samples of 10 back-to-back calls
  ("ms_b2b"); for the f32 operator also the worst error against the
  float64 product of the same f32 ratio and operator, as a share of
  rtol = atol/max = 1e-4 ("f64_share"), beside the same share of cuBLAS
  f32 (TF32 off) and of the TF32 control (TF32 on); and the resident
  kernel (bf16 operator) the same way, with its device time per call from
  a ``torch.profiler`` pass ("device_us", median of 20 calls);
- sessions: ``base`` (the raw kernel) and ``sim`` with ``donotnormalize``
  off (the ratio kernel), each at 'default' (bf16 operator on CUDA) and at
  'highest' (f32 operator), and ``base`` at 'int8_direct' (the int8
  kernel), by ``chip_smoke.time_session``: host-clock ms per group of
  ``process_group`` on batches of 16 frames (2 groups), then per group the
  device's busy time, its idle share, the H2D copies and the group kernel
  from a ``torch.profiler`` pass; and the SHA-256 of the outputs (uint8
  display, linear and dB B-scans) of one more batch, so that two trees'
  outputs can be compared bit for bit.  ``--kernels-only`` skips them: a
  development aid for comparing variants of a kernel's source.

Prints one JSON object per line (the card's name and power limit in each)
and exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (
    B2B, FLAGSHIP, SEED, TOL, captured_session, compare, cuda_ms, device_us, f64_product,
    tf32_control, time_session,
)

SESSIONS = [("base", "default"), ("base", "highest"), ("sim", "default"), ("sim", "highest"),
            ("base", "int8_direct")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent),
                    help="checkout whose fdoct_tpu_torch is measured")
    ap.add_argument("--kernels-only", action="store_true",
                    help="skip the sessions (to compare kernel variants)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_sessions: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 1
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import fdoct_tpu_torch
    from fdoct_tpu_torch.bench_resident import card_line
    from fdoct_tpu_torch.calibration import Calibration
    from fdoct_tpu_torch.config import PipelineConfig
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.pipeline import apodize_ratio, preprocess
    from fdoct_tpu_torch.session import Session
    from fdoct_tpu_torch.sources.synthetic import SyntheticSource
    if not Path(fdoct_tpu_torch.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {fdoct_tpu_torch.__file__}, not the one under {tree}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()

    def emit(**kw):
        print(json.dumps({"tree": str(tree), **kw, "card": card}), flush=True)

    cfg = PipelineConfig(**FLAGSHIP)
    calib = Calibration.create(cfg, dev)
    src = SyntheticSource(height=cfg.height, width=cfg.width, lambda0=cfg.lambda0,
                          dlambda=cfg.lambdabw * 2.3548 / 4.0, noise=0.02, seed=SEED)
    frames = src.frames()

    # the group kernels --------------------------------------------------
    batch = torch.as_tensor(np.stack([next(frames) for _ in range(cfg.averages)])).to(dev)
    bg = torch.as_tensor(np.maximum(src.background(), 1)).to(dev, torch.float32)
    pi = torch.as_tensor(src.pi_frame()).to(dev, torch.float32)
    inv = (1.0 / bg).contiguous()
    yr = apodize_ratio(preprocess(batch, cfg), bg, pi,
                       cfg.replace(donotnormalize=False)).contiguous()
    ratios = {"fused_recon_raw_accumulate": (batch.float() - pi) * inv,
              "fused_recon_accumulate": yr}
    ops = {"bf16": (calib.op_re_bf16, calib.op_im_bf16), "f32": (calib.op_re, calib.op_im)}
    tol = TOL["f32"]
    for op_name, op in ops.items():
        for name, fn in (("fused_recon_raw_accumulate",
                          lambda op=op: kernels.fused_recon_raw_accumulate(batch, pi, inv, *op)),
                         ("fused_recon_accumulate",
                          lambda op=op: kernels.fused_recon_accumulate(yr, *op))):
            acc = {}
            if op_name == "f32":
                x32 = ratios[name]
                want = f64_product(x32, *op)
                atol = tol * float(want.abs().max())
                readings = {"f64_share": fn(),
                            "cublas_f32_f64_share":
                                kernels.fused_recon_accumulate_reference(x32, *op),
                            "tf32_control_f64_share": tf32_control(x32, *op)}
                acc = {k: compare(v, want, tol, atol)["worst_share_of_tol"]
                       for k, v in readings.items()}
            emit(kind="kernel", name=name, operator=op_name, ms=cuda_ms(fn)[0],
                 ms_b2b=cuda_ms(fn, per=B2B)[0], **acc)

    resident = lambda: kernels.fused_recon_resident(batch, pi, inv, *ops["bf16"])   # noqa: E731
    emit(kind="kernel", name="fused_recon_resident", operator="bf16", ms=cuda_ms(resident)[0],
         ms_b2b=cuda_ms(resident, per=B2B)[0], device_us=device_us(resident))
    if args.kernels_only:
        return 0

    # the sessions -------------------------------------------------------
    for variant, precision in SESSIONS:
        scfg = cfg.replace(matmul_precision=precision, donotnormalize=variant == "base")
        s = captured_session(Session, scfg, variant, src, frames, calib, dev)
        batches = [np.stack([next(frames) for _ in range(16)]) for _ in range(4)]
        kernels.reset_launches()
        t = time_session(s, batches)
        calls = 2 * len(batches) + (t["groups"] // 2)       # warm-up, timed and profiled passes
        per_group = {k: v / (2 * calls) for k, v in kernels.LAUNCHES.items() if v}
        digest = hashlib.sha256()
        for r in s.process_group(batches[0]):
            for part in (r.bscandisp, r.bscan.cpu().numpy(), r.bscandb.cpu().numpy()):
                digest.update(part.tobytes())
        emit(kind="session", variant=variant, precision=precision,
             launches_per_group=per_group, outputs_sha256=digest.hexdigest(), **t)
    return 0


if __name__ == "__main__":
    sys.exit(main())
