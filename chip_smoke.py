#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fdoct_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits non-zero:

1. device  — needs CUDA (there is no CPU branch); prints the card's name and
   power limit and turns TF32 off for matmuls and cuDNN.
2. build   — compiles csrc/fused_recon.cu and csrc/int8_bscan.cu with nvcc
   for sm_90a (one nvcc per source, in parallel) and prints ptxas's
   registers, shared memory and spills per kernel.
3. kernels — each instance of kernels 1-2 (raw u8 frames or an f32 ratio,
   against a float32 or a bfloat16 operator) against its plain PyTorch
   version on the card, at the flagship shape (8 frames of 512 x 2048 u8,
   the flagship M from Calibration.create, 512 depths), at a ragged shape
   and at the tensor-core schedule's edge shapes (ops.kernels.EDGE_SHAPES).
   Tolerance: float32 operator rtol 1e-4, atol 1e-4*max (3xTF32 against
   cuBLAS f32 with TF32 off); bfloat16 operator rtol 1e-5, atol 1e-5*max
   (TC_TOL: both round the same f32 ratio to bf16, so only the order of the
   f32 sums differs).  The float32-operator instance and cuBLAS f32 are also
   held to the float64 product of the same f32 ratio and operator at
   F64_TOL, rtol 5e-6, atol 5e-6*max, which a TF32 control (cuBLAS with
   TF32 on) must fail at every shape.  Each bf16 instance and cuBLAS f32 on
   its bf16-rounded operands (its plain version) are held to the float64
   product of those operands at BF16_F64_TOL, rtol 2e-6, atol 2e-6*max
   (4x what cuBLAS f32 reads at the flagship), so that a drift of the
   tensor cores' truncating sums shows; at the flagship the chain of k16
   steps truncated to 24 bits (truncating_chain, a model of those sums) is
   read beside them, and the same chain at 23 bits, a control, must fail
   the limit.  Prints each worst share of tolerance.
4. slice   — the port's main path at the flagship config, one Session per
   instance (SESSION_PATHS): 'base' (the raw kernel) and 'sim' with
   donotnormalize off, as `fdoct sim` sets it (the ratio kernel), each at
   'default' (bf16 operator on CUDA) and 'highest' (f32 operator).  Each
   captures 'b' and 'p', then the launch counts are set to 0 just before its
   process_group calls (4 batches of 16 frames, 8 groups, for 'base'; one,
   2 groups, for 'sim') and read just after: exactly one launch of its
   kernel per group, and no other.  Its last group is compared with the
   plain version plus form_bscan: bf16, 2e-2 dB on pixels within 40 dB of
   the peak; f32, the linear B-scan at rtol 1e-4, atol 1e-4*max, and
   against form_bscan of the float64 product at F64_TOL; uint8 within 1
   level.  Then a 'base' session at dtype="float64" runs one group on the
   card through the plain chain (pipeline.group_kernel_applies) with no
   kernel launch, held to form_bscan of the float64 product at rtol 1e-9.
5. times   — CUDA-event medians of 20 calls of each instance and its plain
   version at the flagship shape, each call timed alone ("ms", which
   includes the wrapper's host time where that is longer than the kernel)
   and as the mean of 10 back-to-back calls ("ms_b2b", where the host's
   time hides behind the device's); the cuBLAS product of the (B*rows x
   n_in) stack by the concatenated (n_in x 2*ndisp) operator, f32 (TF32
   off) and bf16 ("product_ms": the product alone, not the function); and
   per session time_session: the host-clock time per group of
   process_group, then a torch.profiler pass (device busy time, idle share,
   H2D and group-kernel time per group).  bench_sessions.py times the
   kernels and the sessions of another checkout with these functions.
6. int8 kernels — int8_bscan_display_fused against its plain version
   (torch._int_mm + torch epilogue) on the card, with and without the linear
   output, at the flagship shape (8 s8 frames of 512 x 2048 and the plan
   folded from the synthetic background and pi) and at a ragged shape.
   Tolerance: dB and the min/max partials rtol 1e-5, atol 1e-4; linear rtol
   1e-5.
7. int8 slice — the int8-direct display mode at the flagship config: a 'base'
   Session with matmul_precision 'int8_direct' captures 'b' and 'p' from the
   synthetic source, prints the plan's rank-1 residual, then process_group
   on 4 batches of 16 frames (8 groups, one int8 kernel launch each).  Launch
   counts are reset just before and read just after.  One group is held to
   form_bscan(reconstruct_int8_direct(...).sum(0)) (dB rtol 1e-5, atol 1e-4;
   uint8 within 1) and, on pixels within 30 dB of the peak, to a 'bf16'
   session on the same captures within 0.35 dB.
8. int8 times — the kernel (with the plan's packed operator, as the
   session calls it) against its plain version, hot (the same group every
   call) and streamed (each call the next of 32 distinct groups, 256 MiB,
   more than the L2 holds), timed both ways as in phase 5, and the int8
   session by time_session.
9. resident kernels — fused_recon_resident (wgmma + TMA) against its plain
   version (the raw-input plain version with the operator rounded to bf16)
   and against kernel 1's bf16 instance, at the flagship shape, the ragged
   shape, a shape ragged in every tile of the wgmma schedule
   (RESIDENT_RAGGED) and every EDGE_SHAPES entry, with a float32 and a
   bfloat16 operator passed in (the wrapper casts to bf16), printing the
   schedule each shape takes (the flagship and RESIDENT_RAGGED must take
   "wgmma").  Tolerance rtol 1e-5, atol 1e-5*max: all three round the same
   f32 ratio, so only the order of the f32 sums differs.  Each shape also
   against the float64 product at BF16_F64_TOL, as in phase 3.  Times, both
   ways as in phase 5: the kernel and its plain version hot and streamed
   over 32 groups, and kernel 1 bf16 on the same sum.
10. resident bench — fdoct_tpu_torch.bench_resident at the flagship: every
   reconstruction route of one group (f32, default, int8, int8_direct, plain
   bf16, kernels 1, 2 and the resident kernel), each within 5e-2 of the f32
   route, timed hot and streamed over 32 distinct groups.  Launch counts are
   reset just before and read just after; the resident kernel must launch.
11. stream  — the streaming ingest (fdoct_tpu_torch.streaming): a flagship
   'base' 'default' Session behind run_streaming, step = process_group, one
   averaging group (8 frames) per batch, the seeded synthetic frames (a
   cycle of STREAM_POOL, each copy stamped with its index so every frame
   differs, made before the stream as a camera's ring holds them) paced at
   500 fps, lossless, the step keeping each group's uint8 display (as a
   live viewer does), for STREAM_GROUPS_RUN groups after
   a stream of STREAM_WARMUP_GROUPS that pays the start-up (its first
   group's latency is printed).  Prints groups done, dropped (must be 0),
   sustained fps and the frame->display latency p50 / p99 (host clock: from
   the moment the source yields a group's last frame to the moment
   process_group has its uint8 display in host memory, both read by
   wrapping the iterator and the step here); launch counts reset just before and read just after: exactly one
   fused_recon_raw_accumulate launch per group; every display byte-equal to
   a direct process_group on the same frames and captures.  Then the
   profiler's breakdown (device busy, idle share, H2D and the part of it
   beside kernels, group kernel; as time_session reports them) of 16 of
   those groups streamed again, paced and unpaced (from a list, so the next
   batch is queued when a step starts and its copy is issued before the
   step), and fdoct_tpu_torch.bench_ingest at the flagship (phases 1-4:
   pageable and pinned H2D bandwidth, the host copy into a pinned slot,
   ingest-inclusive A-scans/s, the 500 fps FLIR emulation, the bandwidth
   500 fps needs).
12. stepwise — Session(method="gather") and Session(method="hilbert"), one
   flagship 'base' group each on the card, in float32 and float64, with no
   kernel launch (counts reset around each): gather against the
   method="fused_exact" session's linear B-scan at rtol = atol/max 1e-4
   (float32) and GATHER_F64_TOL = 1e-8 (float64); hilbert's peak depth
   equal to gather's on every A-scan; each method's group time
   (time_session).

The line before the last is {"kernels": [...]}, one entry per instance
(kernels 1-2 each with a bf16 and an f32 operator, kernel 3, the resident
kernel): every time in it was measured in this run; "ms"/"plain_ms" are
single calls and "ms_b2b"/"plain_ms_b2b" back-to-back calls (phase 5);
"launches" is the count from the instance's session path (for the
resident kernel, which no session runs, the count from phase 10's
bench_resident run, with the counts set to 0 just before it; its entry adds
its schedule, streamed times and kernel 1 bf16's times); kernel 1 bf16's
entry adds "streamed_session_launches", phase 11's count;
"bound_ms" is the larger of the bytes (each input read and each output
written once, at 3.35 TB/s) and the product's operations at the dense peak
of the operator type (bf16 989 TFLOP/s, s8 1,979 TOPS; an f32 operator as
three TF32 products at 495 TFLOP/s), computed from this run's inputs;
"library_ms" is null (no single PyTorch call computes sum_b |x_b @ M|) and
"product_ms" times the operator product alone; "mma" names the
tensor-core instruction; the float32-operator entries add their worst
shares of F64_TOL and those of cuBLAS f32 and of the TF32 control, the
bf16 entries theirs of BF16_F64_TOL and cuBLAS f32's (kernels 1-2 also the
24- and 23-bit chains' at the flagship).  The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import itertools
import json
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
FLAGSHIP = dict(width=2048, height=512, binvalue=1, averages=8,
                numfftpoints=2048, numdisplaypoints=512,
                lambdamin=816e-9, lambdamax=884e-9,
                increasefftpointsmultiplier=1, dtype="float32", compat=True)
RAGGED = (3, 100, 300, 77)         # B, rows, n_in, ndisp
#: ragged in every tile of the resident kernel's wgmma schedule (rows % 16,
#: n_in % 64, ndisp % 128) at strides TMA takes
RESIDENT_RAGGED = (8, 70, 1040, 200)
TOL = {"f32": 1e-4, "bf16": 2e-2}
REPLACES = {
    "fused_recon_raw_accumulate": "fdoct_tpu/ops/pallas_kernels.py:147",
    "fused_recon_accumulate": "fdoct_tpu/ops/pallas_kernels.py:297",
    "int8_bscan_display_fused": "fdoct_tpu/ops/pallas_kernels.py:244",
    "fused_recon_resident": "fdoct_tpu/ops/pallas_kernels.py:109",
}
SOURCE = "fdoct_tpu_torch/csrc/fused_recon.cu"
INT8_SOURCE = "fdoct_tpu_torch/csrc/int8_bscan.cu"
INT8_TOL = (1e-5, 1e-4)            # rtol, atol of dB and of the min/max partials
RESIDENT_TOL = 1e-5                # rtol = atol/max of the resident kernel
#: rtol = atol/max of the bf16 tensor-core instances: they round the same f32
#: ratio to bf16 as their plain versions, so only the order of the f32 sums
#: differs (the f32 instances keep TOL["f32"])
TC_TOL = {("fused_recon_raw_accumulate", "bf16"): 1e-5, ("fused_recon_accumulate", "bf16"): 1e-5}
#: rtol = atol/max of the f32 instances and of cuBLAS f32 against the float64
#: product of the same f32 ratio and operator: float32-grade products pass
#: it, one TF32 product per multiply-add (~3 decimal digits) does not, nor
#: do 3xTF32 products chained in one tensor-core accumulator
F64_TOL = 5e-6
#: rtol = atol/max of every bf16 instance (kernels 1-2, the resident kernel)
#: and of cuBLAS f32 against the float64 product of the same bf16-rounded
#: ratio and operator.  At the flagship cuBLAS f32 reads at most 5.2e-7 and
#: the tensor cores' truncating f32 sums 1.6e-6 (NVIDIA H100 80GB HBM3,
#: 700 W); the limit is 4x cuBLAS f32's reading, so a drift of the
#: tensor-core sums by another 1.3x fails it, as the 23-bit truncating_chain
#: control does
BF16_F64_TOL = 2e-6
#: rtol = atol/max of the float64 session's B-scan against form_bscan of
#: the float64 product: both run float64 products, in another order
F64_SESSION_TOL = 1e-9
MMA_BF16 = "mma.sync.m16n8k16.f32.bf16.bf16.f32"
MMA_RESIDENT = "wgmma.mma_async.m64n256k16.f32.bf16.bf16 (A from registers, B by TMA)"
MMA_TF32X3 = ("mma.sync.m16n8k8.f32.tf32.tf32.f32 (3xTF32: lo.hi + hi.lo + hi.hi, each "
              "stage's sums added in round-to-nearest f32)")
MMA = {("fused_recon_raw_accumulate", "bf16"): MMA_BF16,
       ("fused_recon_raw_accumulate", "f32"): MMA_TF32X3,
       ("fused_recon_accumulate", "bf16"): MMA_BF16,
       ("fused_recon_accumulate", "f32"): MMA_TF32X3,
       "int8_bscan_display_fused": "mma.sync.m16n8k32.s32.s8.s8.s32"}
#: the session paths of phase 4: (variant, matmul_precision, kernel, operator,
#: batches of 16 frames = 2 groups each)
SESSION_PATHS = [("base", "default", "fused_recon_raw_accumulate", "bf16", 4),
                 ("base", "highest", "fused_recon_raw_accumulate", "f32", 4),
                 ("sim", "default", "fused_recon_accumulate", "bf16", 1),
                 ("sim", "highest", "fused_recon_accumulate", "f32", 1)]
#: dense peaks of one H100 SXM at 700 W (operations per second) and the
#: operations each multiply-add of the operator product costs there: an f32
#: operator runs as three TF32 products
PEAK = {"bf16": 989e12, "f32": 495e12, "s8": 1979e12}
OPS_PER_MAC = {"bf16": 2, "f32": 6, "s8": 2}
HBM_BYTES_PER_S = 3.35e12
B2B = 10                           # back-to-back calls per sample of the *_b2b times
STREAM_GROUPS = 32
SESSION_CALLS = 20                 # timed process_group calls per session, after one pass
STREAM_FPS = 500                   # the source rate of the streamed session (PERF.md §2)
STREAM_GROUPS_RUN = 128            # groups of the streamed session's latency run
STREAM_WARMUP_GROUPS = 8           # groups of the stream before it
STREAM_GROUPS_PROFILED = 16        # groups of each profiled streamed pass
STREAM_POOL = 64                   # distinct synthetic frames the stream cycles through
#: rtol = atol/max of the float64 gather session against the float64
#: fused_exact session (PARITY.md layer 3)
GATHER_F64_TOL = 1e-8


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str, text: str) -> None:
    print(f"[{name}] {text}", flush=True)


def compare(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> dict:
    """Max abs error and the worst error as a share of rtol·|want| + atol."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    return {"max_abs_err": float(err.max()),
            "worst_share_of_tol": float((err / (rtol * want.abs() + atol)).max()),
            "finite": bool(torch.isfinite(got).all())}


def random_problem(shape, seed: int, dev: torch.device) -> dict:
    """Random u8 frames, pi, inv_background, an f32 ratio and an operator
    (f32 and its bf16 rounding) of shape (B, rows, n_in, ndisp)."""
    B, rows, n_in, ndisp = shape
    rng = np.random.default_rng(seed)
    inp = {
        "raw": torch.as_tensor(rng.integers(0, 255, (B, rows, n_in), dtype=np.uint8)).to(dev),
        "pi": torch.as_tensor(rng.uniform(0, 50, (rows, n_in))).to(dev, torch.float32),
        "inv": torch.as_tensor(1.0 / rng.uniform(50, 200, (rows, n_in))).to(dev, torch.float32),
        "yr": torch.as_tensor(rng.normal(size=(B, rows, n_in))).to(dev, torch.float32),
    }
    mr, mi = (torch.as_tensor(rng.normal(size=(n_in, ndisp))).to(dev, torch.float32)
              for _ in range(2))
    inp["f32"], inp["bf16"] = (mr, mi), (mr.to(torch.bfloat16), mi.to(torch.bfloat16))
    return inp


def captured_session(session_cls, cfg, variant: str, src, frames, calib, dev):
    """A session with its 'b' and 'p' captures done: 'base' from 8 background
    frames and the pi frame + 7 frames, 'sim' from its source, then one
    group."""
    s = session_cls(cfg, device=dev, variant=variant, calib=calib,
                    **({"source": src} if variant == "sim" else {}))
    s.key("b")
    if variant == "base":
        for _ in range(cfg.averages):                 # S(k) from 8 background frames
            s.process(src.background())
    s.key("p")
    first = [src.pi_frame()] if variant == "base" else []
    for f in first + [next(frames) for _ in range(cfg.averages - len(first))]:
        s.process(f)
    check(s.indextemp == 0 and not s._pending, f"{variant} captures left it mid-group")
    return s


def bound_keys(op: str, macs: int, inputs, outputs) -> dict:
    """The least time of the card for the work: the larger of each input read
    and each output written once at the HBM rate, and the product's
    operations at the dense peak of the operator type."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in list(inputs) + list(outputs if isinstance(outputs, (list, tuple))
                                              else [outputs]))
    ops_ms = macs * OPS_PER_MAC[op] / PEAK[op] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms}


def bf16_f64_keys(shares: dict) -> dict:
    """The kernels line's float64 keys of a bf16 instance, from its
    {shape: bf16_f64_shares} readings."""
    return {"bf16_f64_tol": BF16_F64_TOL,
            "worst_share_of_bf16_f64_tol": worst_shares({k: v["kernel"] for k, v in shares.items()}),
            "cublas_f32_share_of_bf16_f64_tol": max(v["cuBLAS f32"] for v in shares.values()),
            **{f"{k.replace(' ', '_')}_share_of_bf16_f64_tol": v
               for k, v in shares["flagship"].items() if k.startswith("chain")}}


def worst_shares(shares: dict) -> dict:
    """Worst share of tolerance at the flagship, the ragged shape and over
    the edge shapes."""
    return {"flagship": shares["flagship"], "ragged": shares["ragged"],
            "edges": max(v for k, v in shares.items() if k.startswith("edge"))}


def product_times(fn) -> tuple[float, float]:
    """Median ms of single calls and of back-to-back calls of one product."""
    return cuda_ms(fn)[0], cuda_ms(fn, per=B2B)[0]


def f64_product(x32: torch.Tensor, op_re: torch.Tensor, op_im: torch.Tensor) -> torch.Tensor:
    """Σ_b |x32[b] @ (op_re + i·op_im)| in float64, from the float32 ratio
    and operator that the kernels take."""
    x = x32.double()
    return torch.hypot(x @ op_re.double(), x @ op_im.double()).sum(0)


def bf16_f64_product(x32: torch.Tensor, op_re: torch.Tensor, op_im: torch.Tensor) -> torch.Tensor:
    """Σ_b |bf16(x32[b]) @ (op_re + i·op_im)| in float64, from the float32
    ratio and the bf16 operator of a bf16 instance."""
    return f64_product(x32.to(torch.bfloat16).float(), op_re.float(), op_im.float())


def bf16_f64_shares(kernel: torch.Tensor, cublas: torch.Tensor, want: torch.Tensor,
                    **more: torch.Tensor) -> dict:
    """Worst shares of BF16_F64_TOL of a bf16 instance, of cuBLAS f32 on
    the same rounded operands (its plain version) and of ``more``, against
    ``want``."""
    atol = BF16_F64_TOL * float(want.abs().max())
    return {k: compare(v, want, BF16_F64_TOL, atol)["worst_share_of_tol"]
            for k, v in {"kernel": kernel, "cuBLAS f32": cublas, **more}.items()}


def truncating_chain(x32: torch.Tensor, op_re: torch.Tensor, op_im: torch.Tensor,
                     bits: int) -> torch.Tensor:
    """Σ_b |bf16(x32[b]) @ (op_re + i·op_im)| with re and im each summed as a
    chain of 16-sample steps (one wgmma or mma.sync k16 step each): every
    step's partial sum exact (float64), the running sum truncated toward
    zero to ``bits`` significant bits after each step.  At 24 bits it models
    the tensor cores' truncating f32 sums; at fewer, a drift that
    BF16_F64_TOL must reject."""
    x = x32.to(torch.bfloat16).double()
    op = torch.cat([op_re, op_im], 1).double()
    mask = -(1 << (53 - bits))               # sign, exponent and ``bits`` - 1 stored bits
    acc = torch.zeros((*x.shape[:-1], op.shape[1]), dtype=torch.float64, device=x.device)
    for k in range(0, x.shape[-1], 16):
        acc = ((acc + x[..., k:k + 16] @ op[k:k + 16]).view(torch.int64) & mask).view(torch.float64)
    re, im = acc.split(op_re.shape[1], -1)
    return torch.hypot(re, im).sum(0)


def tf32_control(x32: torch.Tensor, op_re: torch.Tensor, op_im: torch.Tensor) -> torch.Tensor:
    """The same sum with one TF32 product per multiply-add (cuBLAS with TF32
    on): what F64_TOL must reject."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.hypot(x32 @ op_re, x32 @ op_im).sum(0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profiled(fn) -> tuple[list, float, dict]:
    """One call of ``fn`` under ``torch.profiler``: the device events of the
    trace, the call's host-clock ms, and the CUDA streams that ran its H2D
    copies ("h2d") and its other device work ("other")."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    streams = {"h2d": set(), "other": set()}
    for k in prof.profiler.kineto_results.events():
        if k.device_type() == cuda:
            streams["h2d" if "HtoD" in k.name() else "other"].add(k.device_resource_id())
    return [e for e in prof.events() if e.device_type == cuda], wall_ms, streams


def device_us(fn, calls: int = 20) -> float:
    """Median device time (us) of the kernels that ``calls`` calls of ``fn``
    launch, after one call outside the trace."""
    fn()
    dev, _, _ = profiled(lambda: [fn() for _ in range(calls)])
    return statistics.median(e.time_range.elapsed_us() for e in dev)


def time_session(session, batches, groups_per_call: int = 2) -> dict:
    """Host-clock ms per group of ``process_group`` (which ends in the D2H of
    the displays): one warm-up pass over ``batches``, then SESSION_CALLS
    timed calls; then ``torch.profiler`` over one more pass: per group the
    device's busy time (the union of its kernel and copy intervals), its
    idle share of the profiled host time, the H2D copies and the group
    kernels (every fused_recon* and int8_bscan* kernel)."""
    for b in batches:
        session.process_group(b)
    ms = []
    for i in range(SESSION_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.process_group(batches[i % len(batches)])
        ms.append((time.perf_counter() - t0) / groups_per_call * 1e3)
    out = {"group_ms": statistics.median(ms), "group_ms_min": min(ms),
           "group_ms_max": max(ms), "groups": groups_per_call * len(ms)}
    return {**out, **device_breakdown(lambda: [session.process_group(b) for b in batches],
                                      groups_per_call * len(batches))}


def device_breakdown(fn, groups: int) -> dict:
    """One call of ``fn`` under ``torch.profiler``, per group: the host-clock
    ms, the device's busy time (the union of its kernel and copy intervals),
    its idle share of the host time, the H2D copies, the group kernels
    (every fused_recon* and int8_bscan* kernel) and the part of the H2D
    copies that ran while a kernel ran (``h2d_overlap_ms``: copy and
    compute on two streams at once), and the streams of each."""
    dev, wall_ms, streams = profiled(fn)
    if not dev:
        return {"profiled": "not measured: no device events in the trace"}
    span = [(e.time_range.start, e.time_range.end) for e in dev]
    busy = union_us(span) / 1e3
    copies = [(e.time_range.start, e.time_range.end) for e in dev if "HtoD" in e.name]
    compute = [(e.time_range.start, e.time_range.end) for e in dev if "Memcpy" not in e.name
               and "Memset" not in e.name]
    kern = sum(e.time_range.elapsed_us() for e in dev
               if "fused_recon" in e.name or "int8_bscan" in e.name) / 1e3
    return {"profiled_group_ms": wall_ms / groups, "device_busy_ms": busy / groups,
            "idle_share": 1.0 - busy / wall_ms,
            "h2d_ms": sum(e - s for s, e in copies) / 1e3 / groups,
            "group_kernel_ms": kern / groups,
            "h2d_overlap_ms": (union_us(copies) + union_us(compute) - union_us(copies + compute))
            / 1e3 / groups,
            "h2d_streams": sorted(streams["h2d"]), "other_streams": sorted(streams["other"])}


def describe_session(t: dict) -> str:
    head = (f"median {t['group_ms']:.3f} ms (min {t['group_ms_min']:.3f}, max "
            f"{t['group_ms_max']:.3f}; {t['groups']} groups after one warm-up pass; host clock)")
    return f"{head}; {describe_breakdown(t)}"


def describe_breakdown(t: dict) -> str:
    if "profiled_group_ms" not in t:
        return f"profiler {t['profiled']}"
    return (f"profiled pass {t['profiled_group_ms']:.3f} ms/group: device busy "
            f"{t['device_busy_ms']:.3f} ms (idle share {t['idle_share']:.3f}), H2D "
            f"{t['h2d_ms']:.3f} ms ({t['h2d_overlap_ms']:.3f} ms of it beside kernels; H2D on "
            f"streams {t['h2d_streams']}, the rest on {t['other_streams']}), group kernel "
            f"{t['group_kernel_ms']:.3f} ms")


def cuda_ms(fn, runs: int = 20, warmup: int = 3, per: int = 1) -> tuple[float, float, float]:
    """Median, min and max milliseconds per call over ``runs`` samples, each
    timed with CUDA events around ``per`` back-to-back calls.  One call
    between two events also times the wrapper's host work when the kernel
    is shorter than it; with ``per`` > 1 that work overlaps the device's
    work on the call before."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times), min(times), max(times)


def timed_pair(kernel, plain) -> dict:
    """cuda_ms of a kernel and of its plain version, single and back-to-back
    calls."""
    return {"kernel": cuda_ms(kernel), "plain": cuda_ms(plain),
            "kernel_b2b": cuda_ms(kernel, per=B2B), "plain_b2b": cuda_ms(plain, per=B2B)}


def describe(t: dict) -> str:
    return "; ".join(f"{what} median {m:.4f} ms (min {lo:.4f}, max {hi:.4f})"
                     for what, (m, lo, hi) in t.items()) + \
        f"; 20 samples, CUDA events, *_b2b = {B2B} back-to-back calls per sample"


def time_keys(t: dict, prefix: str = "") -> dict:
    """The kernels line's times of a timed_pair: ms, plain_ms, ms_b2b,
    plain_ms_b2b (after ``prefix``)."""
    return {f"{prefix}ms": t["kernel"][0], f"{prefix}plain_ms": t["plain"][0],
            f"{prefix}ms_b2b": t["kernel_b2b"][0], f"{prefix}plain_ms_b2b": t["plain_b2b"][0]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fdoct_tpu_torch.bench_resident import card_line as card
    from fdoct_tpu_torch.calibration import Calibration
    from fdoct_tpu_torch.config import PipelineConfig
    from fdoct_tpu_torch.ops import _build, kernels
    from fdoct_tpu_torch.ops.kernels import (
        EDGE_SHAPES, LAUNCHES, fused_recon_accumulate, fused_recon_accumulate_reference,
        fused_recon_raw_accumulate, fused_recon_raw_accumulate_reference,
    )
    from fdoct_tpu_torch.pipeline import apodize_ratio, form_bscan, preprocess, use_bf16
    from fdoct_tpu_torch.session import Session
    from fdoct_tpu_torch.sources.synthetic import SyntheticSource
    check("jax" not in sys.modules, "the port imported jax")

    # 1. device ---------------------------------------------------------
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = card()
    phase("device", f"{card_line} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    print(card_line, flush=True)

    # 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.library_path().with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln or "entry function" in ln]
    phase("build", f"{build_s:.1f} s -> {_build.library_path().name}")
    for ln in ptxas:
        phase("build", ln)

    # 3. kernels against their plain versions ---------------------------
    cfg = PipelineConfig(**FLAGSHIP)
    t0 = time.perf_counter()
    calib = Calibration.create(cfg, dev)
    phase("calib", f"flagship M {tuple(calib.op_re.shape)} built in "
          f"{time.perf_counter() - t0:.1f} s")
    src = SyntheticSource(height=cfg.height, width=cfg.width, lambda0=cfg.lambda0,
                          dlambda=cfg.lambdabw * 2.3548 / 4.0, noise=0.02, seed=SEED)
    frames = src.frames()
    batch = np.stack([next(frames) for _ in range(cfg.averages)])
    bg = torch.as_tensor(np.maximum(src.background(), 1)).to(dev, torch.float32)
    pi = torch.as_tensor(src.pi_frame()).to(dev, torch.float32)
    flag_in = {
        "raw": torch.as_tensor(batch).to(dev), "pi": pi, "inv": (1.0 / bg).contiguous(),
        "yr": apodize_ratio(preprocess(torch.as_tensor(batch).to(dev), cfg), bg, pi,
                            cfg.replace(donotnormalize=False)).contiguous(),
        "f32": (calib.op_re, calib.op_im), "bf16": (calib.op_re_bf16, calib.op_im_bf16),
    }
    rag_in = random_problem(RAGGED, SEED, dev)

    def run_raw(inp, op, kernel=True):
        fn = fused_recon_raw_accumulate if kernel else fused_recon_raw_accumulate_reference
        return fn(inp["raw"], inp["pi"], inp["inv"], *inp[op])

    def run_yr(inp, op, kernel=True):
        fn = fused_recon_accumulate if kernel else fused_recon_accumulate_reference
        return fn(inp["yr"], *inp[op])

    def ratio32(inp, name):
        """The f32 ratio each kernel takes or forms (rounded as it forms it)."""
        if name == "fused_recon_raw_accumulate":
            return (inp["raw"].float() - inp["pi"]) * inp["inv"]
        return inp["yr"]

    runners = {"fused_recon_raw_accumulate": run_raw, "fused_recon_accumulate": run_yr}
    shares = {}                                      # (name, op) -> {shape: worst share of tol}
    f64_shares = {}                                  # name -> {shape: {reading: worst share}}
    bf16_f64 = {}                                    # the same for the bf16 instances
    errors = {}
    problems = [("flagship", flag_in), ("ragged", rag_in)] + [
        (f"edge {label}", random_problem(shape, SEED + 2, dev))
        for label, shape in EDGE_SHAPES.items()]
    for shape_name, inp in problems:
        for name, run in runners.items():
            for op in ("f32", "bf16"):
                got = run(inp, op)
                torch.cuda.synchronize()
                want = run(inp, op, kernel=False)             # rtol = atol/max = tol
                tol = TC_TOL.get((name, op), TOL[op])
                res = compare(got, want, tol, tol * float(want.abs().max()))
                errors[(name, shape_name, op)] = res
                shares.setdefault((name, op), {})[shape_name] = res["worst_share_of_tol"]
                phase("kernels", f"{name} {shape_name} {tuple(inp['raw'].shape)}->"
                      f"{tuple(got.shape)} op={op}: max_abs_err {res['max_abs_err']:.3e}, "
                      f"worst {res['worst_share_of_tol']:.3e} of tol (rtol=atol/max={tol})")
                check(res["finite"] and res["worst_share_of_tol"] <= 1.0,
                      f"{name} {shape_name} {op} disagrees with its plain version")
            # the f32 instance and cuBLAS f32 against the float64 product, and
            # the TF32 control that the limit must reject
            x32, ops32 = ratio32(inp, name), inp["f32"]
            want = f64_product(x32, *ops32)
            atol = F64_TOL * float(want.abs().max())
            readings = {"kernel": run(inp, "f32"), "cuBLAS f32": run(inp, "f32", kernel=False),
                        "TF32 control": tf32_control(x32, *ops32)}
            got = {k: compare(v, want, F64_TOL, atol)["worst_share_of_tol"]
                   for k, v in readings.items()}
            f64_shares.setdefault(name, {})[shape_name] = got
            phase("kernels", f"{name} {shape_name} op=f32 against the float64 product: " +
                  ", ".join(f"{k} worst {v:.3e}" for k, v in got.items()) +
                  f" of tol (rtol=atol/max={F64_TOL}; the TF32 control must exceed 1)")
            check(got["kernel"] <= 1.0 and got["cuBLAS f32"] <= 1.0,
                  f"{name} {shape_name} f32 is not float32-grade against float64")
            check(got["TF32 control"] > 1.0,
                  f"{name} {shape_name}: the float64 limit passes one TF32 product")
            # the bf16 instance and cuBLAS f32 on its rounded operands against
            # the float64 product of those operands; at the flagship also the
            # chain of k16 steps with truncating sums, at 24 bits and at 23
            # (the control that the limit must reject)
            chains = ({f"chain {bits} bits": truncating_chain(x32, *inp["bf16"], bits)
                       for bits in (24, 23)} if shape_name == "flagship" else {})
            got = bf16_f64_shares(run(inp, "bf16"), run(inp, "bf16", kernel=False),
                                  bf16_f64_product(x32, *inp["bf16"]), **chains)
            bf16_f64.setdefault(name, {})[shape_name] = got
            phase("kernels", f"{name} {shape_name} op=bf16 against the float64 product of the "
                  "bf16-rounded operands: " + ", ".join(f"{k} worst {v:.3e}" for k, v in got.items())
                  + f" of tol (rtol=atol/max={BF16_F64_TOL}"
                  + ("; the 23-bit chain must exceed 1)" if chains else ")"))
            check(got["kernel"] <= 1.0 and got["cuBLAS f32"] <= 1.0,
                  f"{name} {shape_name} bf16 sums drift from the float64 product")
            check(got.get("chain 23 bits", 2.0) > 1.0,
                  f"{name} {shape_name}: the bf16 float64 limit passes a 23-bit truncating chain")

    # 4. the sessions: one per instance, counts at 0 just before each ------
    batches = [np.stack([next(frames) for _ in range(16)]) for _ in range(4)]
    sessions, launches = {}, {}
    for variant, precision, name, op, nbatches in SESSION_PATHS:
        scfg = cfg.replace(matmul_precision=precision, donotnormalize=variant == "base")
        s = captured_session(Session, scfg, variant, src, frames, calib, dev)
        kernels.reset_launches()
        results = [r for b in batches[:nbatches] for r in s.process_group(b)]
        torch.cuda.synchronize()
        ran = {k: v for k, v in LAUNCHES.items() if v}
        groups = 2 * nbatches
        check(len(results) == groups, f"{variant} {precision} gave {len(results)} B-scans")
        for r in results:
            check(r.bscandisp.dtype == np.uint8 and r.bscandisp.shape == (512, 512),
                  f"bscandisp {r.bscandisp.dtype} {r.bscandisp.shape}")
            check(bool(torch.isfinite(r.bscandb).all()), "non-finite bscandb")
        check(ran == {name: groups},
              f"{variant} {precision}: launches {ran} for {groups} groups, not {name}: {groups}")
        sessions[(variant, precision)] = s
        launches[(name, op)] = ran[name]
        phase("slice", f"{variant} '{precision}': {groups} B-scans "
              f"{results[0].bscandisp.shape} uint8 through {name} op={op}; launches this "
              f"path {ran}")

        # the last group against the plain versions + form_bscan
        last = torch.as_tensor(batches[nbatches - 1][-cfg.averages:]).to(dev)
        check(use_bf16(precision, torch.float32, dev) == (op == "bf16"),
              f"'{precision}' does not take the {op} operator on CUDA")
        ops = flag_in[op]
        if variant == "base":
            mag = fused_recon_raw_accumulate_reference(
                last, s.data_yp, (1.0 / s.data_yb).contiguous(), *ops)
        else:
            mag = fused_recon_accumulate_reference(
                apodize_ratio(preprocess(last, scfg), s.data_yb, s.data_yp, scfg), *ops)
        want = form_bscan(mag, scfg, cfg.averages, bscanthreshold=s.bscanthreshold)
        got = results[-1]
        u8_err = int(np.abs(got.bscandisp.astype(int)
                            - want.bscandisp.cpu().numpy().astype(int)).max())
        if op == "bf16":
            near = want.bscandb >= want.bscandb.max() - 40.0
            db_err = float((got.bscandb - want.bscandb).abs()[near].max())
            phase("slice", f"{variant} '{precision}' group vs plain pipeline: max |dB err| "
                  f"{db_err:.3e} on {int(near.sum())} px within 40 dB of peak (limit 2e-2); "
                  f"max uint8 diff {u8_err} (limit 1)")
            ok = db_err <= 2e-2
        else:
            tol = TOL["f32"]
            res = compare(got.bscan, want.bscan, tol, tol * float(want.bscan.abs().max()))
            x32 = ((last.float() - s.data_yp) * (1.0 / s.data_yb) if variant == "base" else
                   apodize_ratio(preprocess(last, scfg), s.data_yb, s.data_yp, scfg))
            want64 = form_bscan(f64_product(x32, *ops).float(), scfg, cfg.averages,
                                bscanthreshold=s.bscanthreshold).bscan
            res64 = compare(got.bscan, want64, F64_TOL, F64_TOL * float(want64.abs().max()))
            phase("slice", f"{variant} '{precision}' group vs plain pipeline: linear max_abs_err "
                  f"{res['max_abs_err']:.3e}, worst {res['worst_share_of_tol']:.3e} of tol "
                  f"(rtol=atol/max={tol}); vs the float64 product: worst "
                  f"{res64['worst_share_of_tol']:.3e} of tol (rtol=atol/max={F64_TOL}); max "
                  f"uint8 diff {u8_err} (limit 1)")
            ok = res["worst_share_of_tol"] <= 1.0 and res64["worst_share_of_tol"] <= 1.0
        check(ok and u8_err <= 1, f"{variant} '{precision}' slice disagrees with plain pipeline")

    # the float64 config: the plain chain on the card, no kernel launch
    calib64 = Calibration.create(cfg.replace(dtype="float64"), dev)
    f64_session_phase(cfg, calib64, src, frames, batches[0][:cfg.averages], dev)

    # 5. times --------------------------------------------------------------
    times = {}
    for name, run in runners.items():
        for op_name in ("bf16", "f32"):
            times[(name, op_name)] = t = timed_pair(lambda: run(flag_in, op_name),
                                                    lambda: run(flag_in, op_name, kernel=False))
            phase("times", f"{name} flagship op={op_name}: {describe(t)} | {card_line}")
    n_in = flag_in["yr"].shape[-1]
    stack = {"f32": flag_in["yr"].reshape(-1, n_in)}
    stack["bf16"] = stack["f32"].to(torch.bfloat16)
    products = {}
    for op_name in ("bf16", "f32"):
        cat = torch.cat(flag_in[op_name], dim=1).contiguous()
        products[op_name] = product_times(lambda: torch.matmul(stack[op_name], cat))
        phase("times", f"product {tuple(stack[op_name].shape)} @ {tuple(cat.shape)} "
              f"{op_name} (cuBLAS, TF32 off): median {products[op_name][0]:.4f} ms single, "
              f"{products[op_name][1]:.4f} ms b2b | {card_line}")
    h2d = cuda_ms(lambda: torch.as_tensor(batches[0]).to(dev))
    mag = fused_recon_raw_accumulate(flag_in["raw"], flag_in["pi"], flag_in["inv"],
                                     *flag_in["bf16"])
    base = sessions[("base", "default")]
    display = cuda_ms(lambda: form_bscan(mag, cfg, cfg.averages,
                                         bscanthreshold=base.bscanthreshold).bscandisp.cpu())
    phase("times", f"breakdown: H2D of 16 pageable frames (16 MiB) median {h2d[0]:.4f} ms "
          f"(min {h2d[1]:.4f}, max {h2d[2]:.4f}); form_bscan + D2H of one uint8 display "
          f"median {display[0]:.4f} ms (min {display[1]:.4f}, max {display[2]:.4f}); "
          f"20 single calls, CUDA events | {card_line}")
    for (variant, precision), s in sessions.items():
        phase("times", f"Session.process_group per group, {variant} '{precision}' (8 frames "
              f"512x2048 u8 from host memory to uint8 display on host): "
              f"{describe_session(time_session(s, batches))} | {card_line}")

    int8_entry = int8_phases(cfg, calib, src, frames, card_line, dev)
    resident_entry = resident_phases(flag_in, rag_in, products["bf16"], card_line, dev)
    stream_launches = streaming_phases(cfg, calib, src, frames, card_line, dev)
    stepwise_phase(cfg, calib, calib64, sessions[("base", "default")], frames, card_line, dev)

    entries = []
    for name in runners:
        for op in ("bf16", "f32"):
            ins = ([flag_in["raw"], flag_in["pi"], flag_in["inv"]]
                   if name == "fused_recon_raw_accumulate" else [flag_in["yr"]])
            x = ins[0]
            flag64 = f64_shares[name]["flagship"]
            f64 = ({"f64_tol": F64_TOL,
                    "worst_share_of_f64_tol": worst_shares(
                        {k: v["kernel"] for k, v in f64_shares[name].items()}),
                    "cublas_f32_share_of_f64_tol": flag64["cuBLAS f32"],
                    "tf32_control_share_of_f64_tol": flag64["TF32 control"]}
                   if op == "f32" else bf16_f64_keys(bf16_f64[name]))
            entries.append({
                "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
                "launches": launches[(name, op)], "operator": op, "mma": MMA[(name, op)],
                "max_abs_err": errors[(name, "flagship", op)]["max_abs_err"],
                "worst_share_of_tol": worst_shares(shares[(name, op)]), **f64,
                **time_keys(times[(name, op)]),
                **bound_keys(op, 2 * x.numel() * calib.op_re.shape[1],
                             ins + list(flag_in[op]), mag),
                "library_ms": None, "product_ms": products[op][0],
                "product_ms_b2b": products[op][1]})
            if (name, op) == ("fused_recon_raw_accumulate", "bf16"):
                entries[-1]["streamed_session_launches"] = stream_launches
    print(json.dumps({"kernels": entries + [int8_entry, resident_entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def f64_session_phase(cfg, calib64, src, frames, group: np.ndarray, dev: torch.device) -> None:
    """Phase 4's float64 case: a 'base' session at dtype="float64" runs one
    group on the card through the plain chain (pipeline.group_kernel_applies
    refuses a float64 operator) with no kernel launch; its B-scan is held to
    form_bscan of the float64 product written out here (rtol = atol/max
    F64_SESSION_TOL; uint8 within 1)."""
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.ops.kernels import LAUNCHES
    from fdoct_tpu_torch.pipeline import form_bscan, group_kernel_applies
    from fdoct_tpu_torch.session import Session

    cfg64 = cfg.replace(dtype="float64")
    check(calib64.op_re.dtype == torch.float64 and not group_kernel_applies(calib64.op_re.dtype),
          "a float64 config's operator is taken by the group kernels")
    s = captured_session(Session, cfg64, "base", src, frames, calib64, dev)
    kernels.reset_launches()
    got = s.process_group(group)
    torch.cuda.synchronize()
    ran = {k: v for k, v in LAUNCHES.items() if v}
    check(len(got) == 1 and ran == {}, f"float64 session: {len(got)} B-scans, launches {ran}")
    x = (torch.as_tensor(group).to(dev).double() - s.data_yp) / s.data_yb
    want = form_bscan(torch.hypot(x @ calib64.op_re, x @ calib64.op_im).sum(0), cfg64,
                      cfg.averages, bscanthreshold=s.bscanthreshold)
    res = compare(got[0].bscan, want.bscan, F64_SESSION_TOL,
                  F64_SESSION_TOL * float(want.bscan.abs().max()))
    u8_err = int(np.abs(got[0].bscandisp.astype(int)
                        - want.bscandisp.cpu().numpy().astype(int)).max())
    phase("slice", f"base dtype=float64: 1 B-scan {got[0].bscandisp.shape} uint8 through the "
          f"plain chain, launches this path {ran}; linear B-scan vs form_bscan of the float64 "
          f"product: max_abs_err {res['max_abs_err']:.3e}, worst {res['worst_share_of_tol']:.3e} "
          f"of tol (rtol=atol/max={F64_SESSION_TOL}); max uint8 diff {u8_err} (limit 1)")
    check(got[0].bscan.dtype == torch.float64 and res["finite"]
          and res["worst_share_of_tol"] <= 1.0 and u8_err <= 1,
          "the float64 session disagrees with its float64 plain chain")


def int8_phases(cfg, calib, src, frames, card_line: str, dev: torch.device) -> dict:
    """Phases 6-8: the int8-direct kernel, slice and times; returns the
    kernel's entry of the {"kernels": [...]} line."""
    from fdoct_tpu_torch.int8direct import (
        Int8DirectPlan, reconstruct_int8_direct, shift_u8_to_s8,
    )
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.ops.kernels import (
        LAUNCHES, int8_bscan_display_fused, int8_bscan_display_fused_reference,
    )
    from fdoct_tpu_torch.pipeline import form_bscan
    from fdoct_tpu_torch.session import Session

    name = "int8_bscan_display_fused"
    rtol, atol = INT8_TOL
    i8_cfg = cfg.replace(matmul_precision="int8_direct")

    # 6. the kernel against its plain version --------------------------------
    bg = np.mean([src.background().astype(np.float64) for _ in range(cfg.averages)], axis=0)
    t0 = time.perf_counter()
    plan = Int8DirectPlan.create(calib, i8_cfg, bg, src.pi_frame(), device=dev)
    phase("int8 kernels", f"flagship Int8DirectPlan.create (host float64 fold + quantize, "
          f"tables to the card) {time.perf_counter() - t0:.3f} s; host clock")
    s8 = shift_u8_to_s8(torch.as_tensor(np.stack([next(frames)
                                                  for _ in range(cfg.averages)])).to(dev))
    flag_args = [s8, plan.oq_re, plan.oq_im, plan.s_re, plan.s_im, plan.row_gain_inv,
                 plan.const_re, plan.const_im]
    B, rows, n_in, ndisp = RAGGED
    rng = np.random.default_rng(SEED + 1)
    rag_args = [torch.as_tensor(a).to(dev) for a in (
        rng.integers(-128, 128, (B, rows, n_in)).astype(np.int8),
        rng.integers(-127, 128, (n_in, ndisp)).astype(np.int8),
        rng.integers(-127, 128, (n_in, ndisp)).astype(np.int8),
        rng.uniform(1e-4, 2e-4, ndisp).astype(np.float32),
        rng.uniform(1e-4, 2e-4, ndisp).astype(np.float32),
        rng.uniform(0.5, 2.0, (rows, 1)).astype(np.float32),
        rng.normal(0, 0.5, (rows, ndisp)).astype(np.float32),
        rng.normal(0, 0.5, (rows, ndisp)).astype(np.float32))]
    thresh = cfg.bscanthreshold
    flag_err = None
    for shape_name, args in (("flagship", flag_args), ("ragged", rag_args)):
        n = args[0].shape[0]
        for with_linear in (False, True):
            got = int8_bscan_display_fused(*args, thresh, n, with_linear=with_linear)
            torch.cuda.synchronize()
            want = int8_bscan_display_fused_reference(*args, thresh, n, with_linear=with_linear)
            res = {part: compare(getattr(got, part), getattr(want, part), rtol, atol)
                   for part in ("db", "mn", "mx")}
            if with_linear:
                res["linear"] = compare(got.linear, want.linear, rtol, 0.0)
            else:
                check(got.linear is None, "linear output written with a null pointer")
            if shape_name == "flagship" and not with_linear:
                flag_err = res["db"]["max_abs_err"]
            phase("int8 kernels", f"{name} {shape_name} {tuple(got.db.shape)} linear="
                  f"{with_linear}: " + "; ".join(
                      f"{part} max_abs_err {r['max_abs_err']:.3e} worst "
                      f"{r['worst_share_of_tol']:.3e} of tol" for part, r in res.items())
                  + f" (rtol {rtol}, atol {atol}; linear atol 0)")
            check(all(r["finite"] and r["worst_share_of_tol"] <= 1.0 for r in res.values()),
                  f"{name} {shape_name} linear={with_linear} disagrees with its plain version")

    # 7. the int8-direct slice -------------------------------------------------
    kernels.reset_launches()
    t_slice = time.perf_counter()
    i8 = Session(i8_cfg, device=dev, variant="base", calib=calib)
    i8.key("b")
    for _ in range(cfg.averages):                   # S(k) from 8 background frames
        i8.process(src.background())
    i8.key("p")
    for f in [src.pi_frame()] + [next(frames) for _ in range(cfg.averages - 1)]:
        i8.process(f)
    check(i8.indextemp == 0 and not i8._pending, "captures left the int8 session mid-group")
    batches = [np.stack([next(frames) for _ in range(16)]) for _ in range(4)]
    results = [r for b in batches for r in i8.process_group(b)]
    torch.cuda.synchronize()
    launches = LAUNCHES[name]
    slice_s = time.perf_counter() - t_slice
    plan = i8._i8plan
    check(plan is not None, "the int8 session refused its plan")
    resid = float(plan.bg_rank1_resid)
    check(len(results) == 8, f"int8 session gave {len(results)} B-scans, not 8")
    for r in results:
        check(r.bscandisp.dtype == np.uint8 and r.bscandisp.shape == (512, 512),
              f"bscandisp {r.bscandisp.dtype} {r.bscandisp.shape}")
        check(bool(torch.isfinite(r.bscandb).all()), "non-finite bscandb")
    check(launches >= 8, f"{name} launched {launches} times for 8 groups")
    phase("int8 slice", f"base int8_direct: plan rank-1 residual {resid:.3e} (gate "
          f"{Session.INT8_RESID_ACT}); 8 B-scans {results[0].bscandisp.shape} uint8 through "
          f"{name} (+{launches} launches); launches this run {dict(LAUNCHES)}; {slice_s:.2f} s")

    last = shift_u8_to_s8(torch.as_tensor(batches[-1][-cfg.averages:]).to(dev))
    plain = form_bscan(reconstruct_int8_direct(last, plan).sum(0), i8_cfg, cfg.averages,
                       bscanthreshold=i8.bscanthreshold)
    got = results[-1]
    db_res = compare(got.bscandb, plain.bscandb, rtol, atol)
    lin_res = compare(got.bscan, plain.bscan, rtol, 0.0)
    u8_err = int(np.abs(got.bscandisp.astype(int)
                        - plain.bscandisp.cpu().numpy().astype(int)).max())
    phase("int8 slice", f"group vs form_bscan(reconstruct_int8_direct(...).sum(0)): dB "
          f"max_abs_err {db_res['max_abs_err']:.3e} (worst {db_res['worst_share_of_tol']:.3e} "
          f"of rtol {rtol} + atol {atol}); linear worst {lin_res['worst_share_of_tol']:.3e} "
          f"of rtol {rtol}; max uint8 diff {u8_err} (limit 1)")
    check(db_res["worst_share_of_tol"] <= 1.0 and lin_res["worst_share_of_tol"] <= 1.0
          and u8_err <= 1, "int8 slice disagrees with its plain chain")

    bf16 = Session(cfg.replace(matmul_precision="bf16"), device=dev, variant="base",
                   calib=calib)
    bf16.data_yb, bf16.data_yp = i8.data_yb, i8.data_yp
    ref = bf16.process_group(batches[-1])[-1].bscandb
    near = ref >= ref.max() - 30.0
    db_gap = float((got.bscandb - ref).abs()[near].max())
    phase("int8 slice", f"group vs the bf16 session on the same captures: max |dB diff| "
          f"{db_gap:.4f} on {int(near.sum())} px within 30 dB of the peak (limit 0.35)")
    check(db_gap <= 0.35, "int8 display is not within 0.35 dB of the bf16 session")

    # 8. times -------------------------------------------------------------------
    packed = plan.oq_packed
    hot = timed_pair(lambda: int8_bscan_display_fused(*flag_args, thresh, cfg.averages,
                                                      oq_packed=packed),
                     lambda: int8_bscan_display_fused_reference(*flag_args, thresh,
                                                                cfg.averages))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    groups = torch.randint(-128, 128, (STREAM_GROUPS, *s8.shape), dtype=torch.int8,
                           generator=gen, device=dev)
    stream = itertools.cycle(list(groups))
    streamed = timed_pair(
        lambda: int8_bscan_display_fused(next(stream), *flag_args[1:], thresh, cfg.averages,
                                         oq_packed=packed),
        lambda: int8_bscan_display_fused_reference(next(stream), *flag_args[1:], thresh,
                                                   cfg.averages))
    del groups, stream
    phase("int8 times", f"{name} flagship on {MMA[name]}, plain = torch._int_mm + torch "
          f"epilogue; hot: {describe(hot)} | {card_line}")
    phase("int8 times", f"{name} flagship streamed over {STREAM_GROUPS} groups: "
          f"{describe(streamed)} | {card_line}")
    phase("int8 times", f"int8_direct Session.process_group per group (8 frames 512x2048 u8 "
          f"from host memory to uint8 display on host): "
          f"{describe_session(time_session(i8, batches))} | {card_line}")
    x2 = s8.reshape(-1, s8.shape[-1])
    cat = torch.cat([plan.oq_re, plan.oq_im], dim=1).contiguous()
    product = product_times(lambda: torch._int_mm(x2, cat))
    phase("int8 times", f"product {tuple(x2.shape)} @ {tuple(cat.shape)} s8 (torch._int_mm): "
          f"median {product[0]:.4f} ms single, {product[1]:.4f} ms b2b | {card_line}")
    out = int8_bscan_display_fused(*flag_args, thresh, cfg.averages, oq_packed=packed)
    return {"name": name, "route": "cuda", "source": INT8_SOURCE, "replaces": REPLACES[name],
            "launches": launches, "operator": "s8", "mma": MMA[name], "max_abs_err": flag_err,
            **time_keys(hot), **time_keys(streamed, "streamed_"),
            **bound_keys("s8", 2 * s8.numel() * plan.oq_re.shape[1],
                         [s8, packed] + flag_args[3:], [out.db, out.mn, out.mx]),
            "library_ms": None, "product_ms": product[0], "product_ms_b2b": product[1]}


def resident_phases(flag_in: dict, rag_in: dict, product: tuple, card_line: str,
                    dev: torch.device) -> dict:
    """Phases 9-10: the resident kernel against its plain version, kernel 1
    and the float64 product, its schedules and times, then the resident
    bench; returns the kernel's entry of the {"kernels": [...]} line."""
    from fdoct_tpu_torch import bench_resident
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.ops.kernels import (
        EDGE_SHAPES, LAUNCHES, RESIDENT_TILE, fused_recon_raw_accumulate, fused_recon_resident,
        fused_recon_resident_reference, resident_schedule,
    )

    name = "fused_recon_resident"
    tol = RESIDENT_TOL

    # 9. the kernel against its plain version, kernel 1 and float64 -----------
    pairs, depths = RESIDENT_TILE
    phase("resident kernels", f"wgmma schedule: blocks of {pairs} (row, frame) pairs x {depths} "
          f"depths, {MMA_RESIDENT}; shapes TMA cannot address run kernel 1 bf16's mma.sync")
    problems = [("flagship", flag_in), ("ragged", rag_in),
                ("ragged wgmma", random_problem(RESIDENT_RAGGED, SEED + 3, dev))] + [
        (f"edge {label}", random_problem(shape, SEED + 4, dev))
        for label, shape in EDGE_SHAPES.items()]
    flag_err, shares, f64 = None, {}, {}
    for shape_name, inp in problems:
        x = (inp["raw"], inp["pi"], inp["inv"])
        sched = resident_schedule(*inp["raw"].shape, inp["bf16"][0].shape[1],
                                  [t.data_ptr() for t in x + inp["bf16"]])
        check(sched == "wgmma" or shape_name not in ("flagship", "ragged wgmma"),
              f"{name} {shape_name} takes the {sched} schedule, not wgmma")
        k1 = fused_recon_raw_accumulate(*x, *inp["bf16"])
        for op in ("f32", "bf16"):
            got = fused_recon_resident(*x, *inp[op])
            torch.cuda.synchronize()
            want = fused_recon_resident_reference(*x, *inp[op])
            res = {"plain": compare(got, want, tol, tol * float(want.abs().max())),
                   "kernel 1": compare(got, k1, tol, tol * float(k1.abs().max()))}
            if shape_name == "flagship" and op == "bf16":
                flag_err = res["plain"]["max_abs_err"]
            shares[(shape_name, op)] = max(r["worst_share_of_tol"] for r in res.values())
            phase("resident kernels", f"{name} {shape_name} {tuple(inp['raw'].shape)}->"
                  f"{tuple(got.shape)} schedule {sched} op={op} passed in: " +
                  "; ".join(f"vs {k} max_abs_err {r['max_abs_err']:.3e}, worst "
                            f"{r['worst_share_of_tol']:.3e} of tol" for k, r in res.items())
                  + f" (rtol=atol/max={tol})")
            check(all(r["finite"] and r["worst_share_of_tol"] <= 1.0 for r in res.values()),
                  f"{name} {shape_name} {op} disagrees with its plain version or kernel 1")
        x32 = (inp["raw"].float() - inp["pi"]) * inp["inv"]
        f64[shape_name] = got64 = bf16_f64_shares(
            fused_recon_resident(*x, *inp["bf16"]), fused_recon_resident_reference(*x, *inp["bf16"]),
            bf16_f64_product(x32, *inp["bf16"]))
        phase("resident kernels", f"{name} {shape_name} against the float64 product of the "
              "bf16-rounded operands: " + ", ".join(f"{k} worst {v:.3e}" for k, v in got64.items())
              + f" of tol (rtol=atol/max={BF16_F64_TOL})")
        check(got64["kernel"] <= 1.0 and got64["cuBLAS f32"] <= 1.0,
              f"{name} {shape_name} drifts from the float64 product")

    # times: hot and streamed, beside kernel 1 bf16 and the cuBLAS product
    x16 = (flag_in["raw"], flag_in["pi"], flag_in["inv"], *flag_in["bf16"])
    hot = timed_pair(lambda: fused_recon_resident(*x16),
                     lambda: fused_recon_resident_reference(*x16))
    k1_hot = product_times(lambda: fused_recon_raw_accumulate(*x16))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    groups = torch.randint(0, 255, (STREAM_GROUPS, *x16[0].shape), dtype=torch.uint8,
                           generator=gen, device=dev)
    stream = itertools.cycle(list(groups))
    streamed = timed_pair(lambda: fused_recon_resident(next(stream), *x16[1:]),
                          lambda: fused_recon_resident_reference(next(stream), *x16[1:]))
    k1_streamed = product_times(lambda: fused_recon_raw_accumulate(next(stream), *x16[1:]))
    del groups, stream
    phase("resident kernels", f"{name} flagship op=bf16 hot: {describe(hot)} | {card_line}")
    phase("resident kernels", f"{name} flagship streamed over {STREAM_GROUPS} groups: "
          f"{describe(streamed)} | {card_line}")
    phase("resident kernels", f"kernel 1 bf16 on the same sum: hot median {k1_hot[0]:.4f} ms "
          f"single, {k1_hot[1]:.4f} ms b2b; streamed {k1_streamed[0]:.4f} / "
          f"{k1_streamed[1]:.4f} | {card_line}")
    phase("resident kernels", f"product {tuple(flag_in['yr'].reshape(-1, x16[0].shape[-1]).shape)}"
          f" @ (n_in x 2 ndisp) bf16 (cuBLAS): median {product[0]:.4f} ms single, "
          f"{product[1]:.4f} ms b2b | {card_line}")

    # 10. the resident bench -----------------------------------------------------
    kernels.reset_launches()
    t0 = time.perf_counter()
    rows = bench_resident.run(dev, card=card_line,
                              log=lambda s: phase("resident bench", s))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    phase("resident bench", f"{len(rows)} rows in {time.perf_counter() - t0:.1f} s; "
          f"launches this run {launches}")
    check(launches[name] > 0, f"{name} was not launched by the resident bench")
    out = fused_recon_resident(*x16)
    return {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "operator": "bf16", "mma": MMA_RESIDENT,
            "schedule": resident_schedule(*x16[0].shape, x16[3].shape[1],
                                          [t.data_ptr() for t in x16]),
            "max_abs_err": flag_err,
            "worst_share_of_tol": worst_shares({k: v for (k, op), v in shares.items()
                                                if op == "bf16"}),
            **bf16_f64_keys(f64), **time_keys(hot), **time_keys(streamed, "streamed_"),
            "kernel1_bf16_ms": list(k1_hot), "kernel1_bf16_streamed_ms": list(k1_streamed),
            **bound_keys("bf16", 2 * x16[0].numel() * out.shape[1], x16, out),
            "library_ms": None, "product_ms": product[0], "product_ms_b2b": product[1]}


def stamped_frames(pool: np.ndarray, n: int) -> list[np.ndarray]:
    """``n`` frames cycling through ``pool``, each a copy with its index
    written into its first four pixels, so that every frame differs; made
    before a stream, as a camera's ring holds them."""
    out = []
    for i in range(n):
        f = pool[i % len(pool)].copy()
        f[0, :4] = np.frombuffer(i.to_bytes(4, "little"), np.uint8)
        out.append(f)
    return out


def yield_timed(frames: list, yielded: list):
    """``frames`` one by one, keeping the host-clock moment each is yielded."""
    for f in frames:
        yielded.append(time.perf_counter())
        yield f


def streaming_phases(cfg, calib, src, frames, card_line: str, dev: torch.device) -> int:
    """Phase 11: a flagship 'base' 'default' session behind run_streaming
    (one averaging group per batch, lossless, the source paced at
    STREAM_FPS) for STREAM_GROUPS_RUN groups, after a stream of
    STREAM_WARMUP_GROUPS that pays the start-up: groups done, dropped (must be
    0), sustained fps, frame→display latency p50/p99 (from the moment the
    source yields a group's last frame to the moment its uint8 display is
    in host memory), exactly one kernel 1 launch per group (counts set to 0
    just before, read just after) and every display byte-equal to a direct
    process_group on the same frames and captures.  Then the profiler's
    breakdown of 16 of those groups streamed again, paced and unpaced, and
    fdoct_tpu_torch.bench_ingest at the flagship (phases 1-4).  Returns the streamed run's launch count."""
    from fdoct_tpu_torch import bench_ingest
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.ops.kernels import LAUNCHES
    from fdoct_tpu_torch.session import Session
    from fdoct_tpu_torch.streaming import run_streaming

    name = "fused_recon_raw_accumulate"
    scfg = cfg.replace(matmul_precision="default", donotnormalize=True)
    s = captured_session(Session, scfg, "base", src, frames, calib, dev)
    pool = np.stack([next(frames) for _ in range(STREAM_POOL)])
    made = stamped_frames(pool, STREAM_GROUPS_RUN * cfg.averages)
    yielded, done = [], []

    def step(batch):
        # a live viewer shows each display and lets the group's device
        # B-scans go; so does this run (holding 128 groups of them would
        # grow the device allocator under the stream)
        out = [r.bscandisp for r in s.process_group(batch)]
        done.append(time.perf_counter())
        return out

    def stream(groups: int):
        yielded.clear()
        done.clear()
        return run_streaming(yield_timed(made, yielded), step, cfg.averages, groups,
                             device=dev, rate_fps=STREAM_FPS)

    # a first stream pays the process's start-up (pinned host memory, the
    # copy stream's first device buffers): its first group is the start-up
    # latency, and the latency run that follows reads the steady state
    stream(STREAM_WARMUP_GROUPS)
    startup = (done[0] - yielded[cfg.averages - 1]) * 1e3
    kernels.reset_launches()
    results, stats = stream(STREAM_GROUPS_RUN)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    fps_stats = stats.fps
    groups = len(results)
    check(groups == STREAM_GROUPS_RUN and all(len(r) == 1 for r in results),
          f"streamed session gave {groups} batches of {[len(r) for r in results][:4]} B-scans")
    check(stats.dropped == 0, f"the lossless stream dropped {stats.dropped} frames")
    check(launches == {name: groups}, f"streamed session: launches {launches} for {groups} groups")
    last = [yielded[cfg.averages * (g + 1) - 1] for g in range(groups)]
    lat = np.array(done[:groups]) - np.array(last)
    sustained = groups * cfg.averages / (done[groups - 1] - yielded[0])
    phase("stream", f"base 'default' behind run_streaming at {STREAM_FPS} fps, lossless, "
          f"{cfg.averages}-frame batches: {groups} groups, dropped {stats.dropped}, launches "
          f"{launches}; sustained {sustained:.1f} fps (first yield to last display; "
          f"StreamStats.fps {fps_stats:.1f}); frame->display latency p50 "
          f"{np.percentile(lat, 50) * 1e3:.3f} ms, p99 {np.percentile(lat, 99) * 1e3:.3f} ms, "
          f"max {lat.max() * 1e3:.3f} ms (host clock, yield of a group's last frame to its "
          f"uint8 display on the host, after a stream of {STREAM_WARMUP_GROUPS} groups whose "
          f"first took {startup:.3f} ms) | {card_line}")

    twin = Session(scfg, device=dev, calib=calib)
    twin.data_yb, twin.data_yp = s.data_yb, s.data_yp
    unequal = [g for g in range(groups) if not np.array_equal(
        results[g][0],
        twin.process_group(np.stack(made[cfg.averages * g:cfg.averages * (g + 1)]))[0].bscandisp)]
    phase("stream", f"{groups} streamed displays against a direct process_group on the same "
          f"frames and captures: {groups - len(unequal)} byte-equal")
    check(not unequal, f"streamed displays differ from direct process_group: groups {unequal}")

    # the same frames again, paced, then from a list as fast as the
    # producer queues them (the next batch is then queued when a step starts,
    # so its copy is issued before the step, on the side stream)
    frames_run = made[:STREAM_GROUPS_PROFILED * cfg.averages]
    for rate in (STREAM_FPS, None):
        t = device_breakdown(lambda: run_streaming(
            iter(frames_run), s.process_group, cfg.averages, STREAM_GROUPS_PROFILED, device=dev,
            rate_fps=rate), STREAM_GROUPS_PROFILED)
        phase("stream", f"{STREAM_GROUPS_PROFILED} groups streamed "
              f"{f'at {rate} fps' if rate else 'from a list, unpaced'}: "
              f"{describe_breakdown(t)} | {card_line}")

    kernels.reset_launches()
    t0 = time.perf_counter()
    bench_ingest.run(dev, card=card_line, log=lambda line: phase("bench_ingest", line))
    torch.cuda.synchronize()
    phase("bench_ingest", f"phases 1-4 in {time.perf_counter() - t0:.1f} s; launches this run "
          f"{ {k: v for k, v in LAUNCHES.items() if v} }")
    return launches[name]


def stepwise_phase(cfg, calib, calib64, captured, frames, card_line: str,
                   dev: torch.device) -> None:
    """Phase 12: one flagship 'base' group through Session(method="gather")
    and Session(method="hilbert") on the card with zero launches (counts set
    to 0 just before each, read just after), on the captures of ``captured``.
    Gather is held to the method="fused_exact" session's linear B-scan in
    float32 (rtol = atol/max TOL["f32"]) and in float64 (GATHER_F64_TOL);
    hilbert to gather on the depth of each A-scan's peak.  Then each
    method's group time (time_session)."""
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.ops.kernels import LAUNCHES
    from fdoct_tpu_torch.session import Session

    group = np.stack([next(frames) for _ in range(cfg.averages)])
    batches = [np.stack([next(frames) for _ in range(16)]) for _ in range(4)]
    sessions = {}
    for dtype, cal in (("float32", calib), ("float64", calib64)):
        scfg = cfg.replace(dtype=dtype, donotnormalize=True)
        out = {}
        for method in ("fused_exact", "gather", "hilbert"):
            s = sessions[(dtype, method)] = Session(scfg, device=dev, calib=cal, method=method)
            s.data_yb = captured.data_yb.to(getattr(torch, dtype))
            s.data_yp = captured.data_yp.to(getattr(torch, dtype))
            kernels.reset_launches()
            (out[method],) = s.process_group(group)
            torch.cuda.synchronize()
            ran = {k: v for k, v in LAUNCHES.items() if v}
            check(method == "fused_exact" or ran == {},
                  f"{method} {dtype} session launched {ran}")
            check(out[method].bscan.dtype == getattr(torch, dtype)
                  and bool(torch.isfinite(out[method].bscan).all()),
                  f"{method} {dtype}: {out[method].bscan.dtype} or non-finite")
            if method != "fused_exact":
                phase("stepwise", f"base {dtype} method={method}: 1 B-scan "
                      f"{out[method].bscandisp.shape} uint8, launches this path {ran}")
        tol = TOL["f32"] if dtype == "float32" else GATHER_F64_TOL
        want = out["fused_exact"].bscan
        res = compare(out["gather"].bscan, want, tol, tol * float(want.abs().max()))
        peaks = {m: out[m].bscan[2:].argmax(0) for m in ("gather", "hilbert")}
        same = int((peaks["gather"] == peaks["hilbert"]).sum())
        phase("stepwise", f"{dtype}: gather vs the fused_exact session, linear max_abs_err "
              f"{res['max_abs_err']:.3e}, worst {res['worst_share_of_tol']:.3e} of tol "
              f"(rtol=atol/max={tol}); hilbert's peak depth equals gather's on {same} of "
              f"{peaks['gather'].numel()} A-scans")
        check(res["finite"] and res["worst_share_of_tol"] <= 1.0,
              f"gather {dtype} disagrees with the fused_exact session")
        check(same == peaks["gather"].numel(), f"hilbert {dtype} peaks differ from gather's")
    for method in ("gather", "hilbert", "fused_exact"):
        phase("stepwise", f"Session.process_group per group, base float32 method={method} "
              f"(8 frames 512x2048 u8 from host memory to uint8 display on host): "
              f"{describe_session(time_session(sessions[('float32', method)], batches))} | "
              f"{card_line}")


if __name__ == "__main__":
    sys.exit(main())
