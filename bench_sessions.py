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

- kernels (KERNELS): kernel 1 on the u8 frames and on the same counts << 4
  as Mono16 frames, and kernel 2 on the f32 ratio the 'sim' route forms,
  with a bf16 and an f32 operator (the f32 instances given the
  Calibration's TF32 table where the tree's wrappers take one, so that no
  timed call packs it); the resident kernel; and the
  three bf16 instances on the first frame alone (a group of one, as the
  per-frame and saveframes routes launch them).  Per instance: CUDA
  events, median of 20 single calls ("ms") and of 20 samples of 10
  back-to-back calls ("ms_b2b"); the kernel's device time from a
  ``torch.profiler`` pass ("device_us", median of 20 calls); the host time
  to enqueue one call with the device drained ("host_us", median of 50:
  the wrapper's checks, tensor maps and launch); for the f32 operator also
  the worst error against the float64 product of the same f32 ratio and
  operator, as a share of rtol = atol/max = 1e-4 ("f64_share"), beside the
  same share of cuBLAS f32 (TF32 off) and of the TF32 control (TF32 on);
  the schedule each call takes ("schedule": "wgmma" or "mma.sync", read
  from the tree's ``bf16_schedule``/``f32_schedule`` where it has them);
  and the cuBLAS product of the ratio stack by [op_re | op_im] alone in f32
  and bf16 (kind "product");
- kernel 3 (``int8_bscan_display_fused``) on the group's frames shifted to
  s8 and the folded operator of an ``Int8DirectPlan`` made from the same
  source, as phase 8 of chip_smoke.py makes them, on the group (8 frames)
  and on its first frame alone (B = 1), with the linear image: the times
  above (device time of the int8 kernel alone, not of the wrapper's fills),
  the schedule (from the tree's ``int8_schedule``, "mma.sync" in a tree
  without it) and ``outputs_sha256`` of db, mn, mx and linear, so that two
  trees' kernel 3 outputs can be compared bit for bit; and the
  ``torch._int_mm`` product of the frames by [oq_re | oq_im] alone
  (kind "product", operator "s8");
- sessions (SESSIONS): ``base`` (the raw kernel) and ``sim`` with
  ``donotnormalize`` off (the ratio kernel), each at 'default' (bf16
  operator on CUDA) and at 'highest' (f32 operator), ``base`` at
  'int8_direct' (the int8 kernel), ``base`` on 12-bit frames (uint16; the
  raw kernel's u16 instances) at 'default' and 'highest', and ``base``
  'default' with ``saveframes`` (the per-frame magnitudes: eight launches
  of kernel 1 a group, one frame each), by ``chip_smoke.time_session``:
  host-clock ms per group of ``process_group`` on batches of 16 frames (2
  groups), then per group the device's busy time, its idle share, the H2D
  copies and the group kernels from a ``torch.profiler`` pass; and the
  SHA-256 of the outputs (uint8 display, linear and dB B-scans) of one
  more batch, so that two trees' outputs can be compared bit for bit;
  ``--displays OUT.npz`` also saves that batch's uint8 displays, and
  ``--compare-displays A.npz B.npz`` prints each session's largest
  difference between two trees' displays in uint8 levels (exit 1 above 1).
  ``--kernels-only`` skips them: the way to time a variant of a kernel's
  source (a copy of the package with the ``.cu`` edited, ``--tree``).

Prints one JSON object per line (the card's name and power limit in each)
and exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import sys
from pathlib import Path

import numpy as np
import torch

from chip_smoke import (
    B2B, FLAGSHIP, SEED, TOL, captured_session, compare, cuda_ms, device_us, f64_product,
    host_enqueue_ms, product_times, tf32_control, time_session,
)

#: (variant, matmul_precision, bits a pixel of the synthetic camera, other config)
SESSIONS = [("base", "default", 8, {}), ("base", "highest", 8, {}), ("sim", "default", 8, {}),
            ("sim", "highest", 8, {}), ("base", "int8_direct", 8, {}), ("base", "default", 12, {}),
            ("base", "highest", 12, {}), ("base", "default", 8, {"saveframes": True})]


def kernel_inputs(cfg, calib, src, frames, dev) -> dict:
    """The flagship's kernel inputs: one group of u8 frames ("raw") and the
    same counts << 4 as Mono16 ("raw16"), pi, inv_background, the f32 ratio
    the 'sim' route forms ("yr"), the operators ("bf16", "f32") and the
    Calibration's TF32 table ("tf32", None in a tree without one)."""
    from fdoct_tpu_torch.pipeline import apodize_ratio, preprocess

    batch = np.stack([next(frames) for _ in range(cfg.averages)])
    raw = torch.as_tensor(batch).to(dev)
    bg = torch.as_tensor(np.maximum(src.background(), 1)).to(dev, torch.float32)
    pi = torch.as_tensor(src.pi_frame()).to(dev, torch.float32)
    yr = apodize_ratio(preprocess(raw, cfg), bg, pi, cfg.replace(donotnormalize=False))
    return {"raw": raw, "raw16": torch.as_tensor(batch.astype(np.uint16) << 4).to(dev),
            "pi": pi, "inv": (1.0 / bg).contiguous(), "yr": yr.contiguous(),
            "bf16": (calib.op_re_bf16, calib.op_im_bf16), "f32": (calib.op_re, calib.op_im),
            "tf32": getattr(calib, "op_tf32", None)}


def int8_inputs(cfg, calib, src, frames, dev) -> dict:
    """Kernel 3's flagship inputs, as chip_smoke.py phase 8 makes them: one
    group of frames shifted to s8, the plan's folded operator and tables
    ("args", the wrapper's positional arguments), the packed operator and
    the display floor."""
    from fdoct_tpu_torch.int8direct import Int8DirectPlan, shift_u8_to_s8

    i8_cfg = cfg.replace(matmul_precision="int8_direct")
    bg = np.mean([src.background().astype(np.float64) for _ in range(cfg.averages)], axis=0)
    plan = Int8DirectPlan.create(calib, i8_cfg, bg, src.pi_frame(), device=dev)
    s8 = shift_u8_to_s8(torch.as_tensor(np.stack([next(frames)
                                                  for _ in range(cfg.averages)])).to(dev))
    return {"args": [s8, plan.oq_re, plan.oq_im, plan.s_re, plan.s_im, plan.row_gain_inv,
                     plan.const_re, plan.const_im],
            "packed": plan.oq_packed, "thresh": cfg.bscanthreshold}


def table_kw(kernels, x: dict, op: str) -> dict:
    """The TF32 table keyword of an f32 call, where the tree's wrappers take
    one (a tree before them packs nothing: it reads op_re and op_im)."""
    takes = "op_tf32" in inspect.signature(kernels.fused_recon_raw_accumulate).parameters
    return {"op_tf32": x["tf32"]} if op == "f32" and takes else {}


def schedule(kernels, frames: torch.Tensor, op: str, x: dict) -> str:
    """The schedule a call takes, as the tree's rule reads it ("mma.sync"
    for an f32 operator in a tree without f32_schedule)."""
    terms = [] if frames.dtype == torch.float32 else [x["pi"], x["inv"]]
    if op == "bf16":
        ptrs = [frames, *x["bf16"], *terms]
        return kernels.bf16_schedule(frames.dtype, frames.shape[-1], x["bf16"][0].shape[1],
                                     [t.data_ptr() for t in ptrs])
    if not hasattr(kernels, "f32_schedule"):
        return "mma.sync"
    return kernels.f32_schedule(frames.dtype, frames.shape[-1], x["f32"][0].shape[1],
                                [t.data_ptr() for t in (frames, x["tf32"], *terms)])


def kernel_calls(kernels, x: dict) -> dict:
    """(wrapper, frames, operator, group size) -> (a call of it on ``x``,
    its frames)."""
    raw, yr = kernels.fused_recon_raw_accumulate, kernels.fused_recon_accumulate
    calls = {}
    for B in (8, 1):
        for op in ("bf16", "f32") if B == 8 else ("bf16",):
            m, kw = x[op], table_kw(kernels, x, op)
            for frames_type, key in (("u8", "raw"), ("u16", "raw16")):
                calls[("fused_recon_raw_accumulate", frames_type, op, B)] = (
                    lambda m=m, kw=kw, B=B, key=key: raw(x[key][:B], x["pi"], x["inv"], *m, **kw),
                    x[key][:B])
            calls[("fused_recon_accumulate", "f32", op, B)] = (
                lambda m=m, kw=kw, B=B: yr(x["yr"][:B], *m, **kw), x["yr"][:B])
    calls[("fused_recon_resident", "u8", "bf16", 8)] = (lambda: kernels.fused_recon_resident(
        x["raw"], x["pi"], x["inv"], *x["bf16"]), x["raw"])
    return calls


def compare_displays(a: Path, b: Path) -> int:
    """Each session's largest difference, in uint8 levels, between the
    displays two trees saved with ``--displays``; 1 if any exceeds 1."""
    got, want = np.load(a), np.load(b)
    if set(got.files) != set(want.files):
        print(f"different sessions: {sorted(set(got.files) ^ set(want.files))}")
        return 1
    worst = {k: int(np.abs(got[k].astype(int) - want[k].astype(int)).max()) for k in got.files}
    for k, v in worst.items():
        print(json.dumps({"session": k, "max_uint8_diff": v,
                          "pixels_differing": int((got[k] != want[k]).sum()),
                          "pixels": int(got[k].size)}))
    return 1 if max(worst.values()) > 1 else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parent),
                    help="checkout whose fdoct_tpu_torch is measured")
    ap.add_argument("--kernels-only", action="store_true",
                    help="skip the sessions (to compare kernel variants)")
    ap.add_argument("--displays", metavar="OUT.npz",
                    help="save each session's displays of its hashed batch")
    ap.add_argument("--compare-displays", nargs=2, metavar=("A.npz", "B.npz"),
                    help="compare two trees' saved displays, session by session")
    args = ap.parse_args(argv)
    if args.compare_displays:
        return compare_displays(*map(Path, args.compare_displays))
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
    sources = {bpp: SyntheticSource(height=cfg.height, width=cfg.width, lambda0=cfg.lambda0,
                                    dlambda=cfg.lambdabw * 2.3548 / 4.0, noise=0.02,
                                    seed=SEED + (bpp != 8), bpp=bpp) for bpp in (8, 12)}
    streams = {bpp: s.frames() for bpp, s in sources.items()}

    # the group kernels --------------------------------------------------
    x = kernel_inputs(cfg, calib, sources[8], streams[8], dev)
    ratios = {("fused_recon_raw_accumulate", "u8"): (x["raw"].float() - x["pi"]) * x["inv"],
              ("fused_recon_raw_accumulate", "u16"): (x["raw16"].float() - x["pi"]) * x["inv"],
              ("fused_recon_accumulate", "f32"): x["yr"]}
    tol = TOL["f32"]
    for (name, frames_type, op_name, B), (fn, frames) in kernel_calls(kernels, x).items():
        acc = {}
        if op_name == "f32":
            op = x["f32"]
            ratio = ratios[(name, frames_type)]
            want = f64_product(ratio, *op)
            atol = tol * float(want.abs().max())
            readings = {"f64_share": fn(),
                        "cublas_f32_f64_share": kernels.fused_recon_accumulate_reference(ratio, *op),
                        "tf32_control_f64_share": tf32_control(ratio, *op)}
            acc = {k: compare(v, want, tol, atol)["worst_share_of_tol"]
                   for k, v in readings.items()}
        emit(kind="kernel", name=name, frames=frames_type, operator=op_name, group=B,
             schedule=schedule(kernels, frames, op_name, x),
             ms=cuda_ms(fn)[0], ms_b2b=cuda_ms(fn, per=B2B)[0], device_us=device_us(fn),
             host_us=host_enqueue_ms(fn, runs=50) * 1e3, **acc)
    # a source of its own, so that the sessions below read the frames they read before
    i8_src = SyntheticSource(height=cfg.height, width=cfg.width, lambda0=cfg.lambda0,
                             dlambda=cfg.lambdabw * 2.3548 / 4.0, noise=0.02, seed=SEED)
    i8 = int8_inputs(cfg, calib, i8_src, i8_src.frames(), dev)
    for B in (8, 1):
        s8 = i8["args"][0][:B]
        ptrs = [s8.data_ptr(), i8["packed"].data_ptr()]

        def k3(s8=s8, B=B, with_linear=False):
            return kernels.int8_bscan_display_fused(s8, *i8["args"][1:], i8["thresh"], B,
                                                    with_linear=with_linear,
                                                    oq_packed=i8["packed"])

        emit(kind="kernel", name="int8_bscan_display_fused", frames="s8", operator="s8",
             group=B, schedule=(kernels.int8_schedule(s8.shape[-1], ptrs)
                                if hasattr(kernels, "int8_schedule") else "mma.sync"),
             ms=cuda_ms(k3)[0], ms_b2b=cuda_ms(k3, per=B2B)[0],
             device_us=device_us(k3, name="int8_bscan"),
             host_us=host_enqueue_ms(k3, runs=50) * 1e3,
             outputs_sha256=hashlib.sha256(b"".join(
                 t.cpu().numpy().tobytes() for t in k3(with_linear=True))).hexdigest())
    x2 = i8["args"][0].reshape(-1, i8["args"][0].shape[-1])
    cat = torch.cat(i8["args"][1:3], dim=1).contiguous()
    single, b2b = product_times(lambda: torch._int_mm(x2, cat))
    emit(kind="product", operator="s8", shape=[list(x2.shape), list(cat.shape)], ms=single,
         ms_b2b=b2b)
    stack = x["yr"].reshape(-1, x["yr"].shape[-1])
    for op_name in ("f32", "bf16"):
        cat = torch.cat(x[op_name], dim=1).contiguous()
        a = stack.to(cat.dtype)
        single, b2b = product_times(lambda: torch.matmul(a, cat))
        emit(kind="product", operator=op_name, shape=[list(a.shape), list(cat.shape)],
             ms=single, ms_b2b=b2b)
    if args.kernels_only:
        return 0

    # the sessions -------------------------------------------------------
    displays = {}
    for variant, precision, bpp, other in SESSIONS:
        # 12-bit frames (uint16) from a source of their own, as chip_smoke.py phase 17 makes them
        scfg = cfg.replace(matmul_precision=precision, donotnormalize=variant == "base", bpp=bpp,
                           **other)
        src, frames = sources[bpp], streams[bpp]
        s = captured_session(Session, scfg, variant, src, frames, calib, dev)
        batches = [np.stack([next(frames) for _ in range(16)]) for _ in range(4)]
        kernels.reset_launches()
        t = time_session(s, batches)
        calls = 2 * len(batches) + (t["groups"] // 2)       # warm-up, timed and profiled passes
        per_group = {k: v / (2 * calls) for k, v in kernels.LAUNCHES.items() if v}
        digest = hashlib.sha256()
        results = s.process_group(batches[0])
        for r in results:
            for part in (r.bscandisp, r.bscan.cpu().numpy(), r.bscandb.cpu().numpy()):
                digest.update(part.tobytes())
        displays[" ".join([variant, precision, str(bpp), *other])] = np.stack(
            [r.bscandisp for r in results])
        emit(kind="session", variant=variant, precision=precision, bpp=bpp, **other,
             launches_per_group=per_group, outputs_sha256=digest.hexdigest(), **t)
    if args.displays:
        np.savez(args.displays, **displays)
    return 0


if __name__ == "__main__":
    sys.exit(main())
