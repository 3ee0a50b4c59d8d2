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
3. kernels — each kernel against its plain PyTorch version on the card, for
   a float32 and a bfloat16 operator, at the flagship shape (8 frames of
   512 x 2048 u8, the flagship M from Calibration.create, 512 depths) and at
   a ragged shape.  Tolerance: float32 rtol 1e-4, atol 1e-4*max; bfloat16
   rtol 2e-2, atol 2e-2*max, except kernel 1's bfloat16 instance (the bf16
   tensor cores), held at rtol 1e-5, atol 1e-5*max: it rounds the same f32
   ratio to bf16 as its plain version, so only the order of the f32 sums
   differs.
4. slice   — the port's main path at the flagship config: Session
   (variant 'base', matmul_precision 'default' = bf16 on CUDA) captures
   'b' and 'p' from synthetic frames per frame, then process_group on 4
   batches of 16 frames (8 groups, kernel 1); a 'sim' session
   (donotnormalize=False, as `fdoct sim` sets it) runs its groups through
   kernel 2.  Launch counts are reset just before and read just after.
   One group of each is compared with the plain versions plus form_bscan:
   2e-2 dB on pixels within 40 dB of the peak, uint8 within 1 level.
5. times   — CUDA-event medians of 20 calls of each kernel and its plain
   version at the flagship shape, each call timed alone ("ms", which
   includes the wrapper's host time where that is longer than the kernel)
   and as the mean of 10 back-to-back calls ("ms_b2b", where the host's
   time hides behind the device's), and the wall time per group of
   Session.process_group.
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
   session's wall time per group.
9. resident kernels — fused_recon_resident against its plain version (the
   raw-input plain version with the operator rounded to bf16) and against
   kernel 1's bf16 instance, at the flagship shape and at the ragged shape,
   with a float32 and a bfloat16 operator passed in (the wrapper casts to
   bf16).  Tolerance rtol 1e-5, atol 1e-5*max: all three round the same f32
   ratio, so only the order of the f32 sums differs.  Prints the block tile
   and the kernel's and the plain version's times, both ways as in phase 5.
10. resident bench — fdoct_tpu_torch.bench_resident at the flagship: every
   reconstruction route of one group (f32, default, int8, int8_direct, plain
   bf16, kernels 1, 2 and the resident kernel), each within 5e-2 of the f32
   route, timed hot and streamed over 32 distinct groups.  Launch counts are
   reset just before and read just after; the resident kernel must launch.

The line before the last is {"kernels": [...]}: every number in it was
measured in this run; "ms"/"plain_ms" are single calls and "ms_b2b"/
"plain_ms_b2b" back-to-back calls (phase 5); "mma" names the tensor-core
instruction of kernels 1 (bf16) and 3.  The last line is
{"ok": true, "device": {...}}.
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
TC_TOL = {("fused_recon_raw_accumulate", "bf16"): 1e-5}   # rtol = atol/max, tensor cores
MMA = {"fused_recon_raw_accumulate": "mma.sync.m16n8k16.f32.bf16.bf16.f32",
       "int8_bscan_display_fused": "mma.sync.m16n8k32.s32.s8.s8.s32"}
B2B = 10                           # back-to-back calls per sample of the *_b2b times
STREAM_GROUPS = 32


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


def session_group_ms(session, batches, per_call: int) -> list[float]:
    """Host-clock ms per group of ``process_group`` (``per_call`` groups per
    batch): one warm-up pass over ``batches``, then 4 timed passes."""
    ms = []
    for _ in range(5):
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            session.process_group(b)                 # ends in the D2H of the displays
            ms.append((time.perf_counter() - t0) / per_call * 1e3)
    return ms[len(batches):]


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
        LAUNCHES, fused_recon_accumulate, fused_recon_accumulate_reference,
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
    B, rows, n_in, ndisp = RAGGED
    rng = np.random.default_rng(SEED)
    rag_in = {
        "raw": torch.as_tensor(rng.integers(0, 255, (B, rows, n_in), dtype=np.uint8)).to(dev),
        "pi": torch.as_tensor(rng.uniform(0, 50, (rows, n_in))).to(dev, torch.float32),
        "inv": torch.as_tensor(1.0 / rng.uniform(50, 200, (rows, n_in))).to(dev, torch.float32),
        "yr": torch.as_tensor(rng.normal(size=(B, rows, n_in))).to(dev, torch.float32),
    }
    mr, mi = (torch.as_tensor(rng.normal(size=(n_in, ndisp))).to(dev, torch.float32)
              for _ in range(2))
    rag_in["f32"], rag_in["bf16"] = (mr, mi), (mr.to(torch.bfloat16), mi.to(torch.bfloat16))

    def run_raw(inp, op, kernel=True):
        fn = fused_recon_raw_accumulate if kernel else fused_recon_raw_accumulate_reference
        return fn(inp["raw"], inp["pi"], inp["inv"], *inp[op])

    def run_yr(inp, op, kernel=True):
        fn = fused_recon_accumulate if kernel else fused_recon_accumulate_reference
        return fn(inp["yr"], *inp[op])

    runners = {"fused_recon_raw_accumulate": run_raw, "fused_recon_accumulate": run_yr}
    errors = {}
    for name, run in runners.items():
        for shape_name, inp in (("flagship", flag_in), ("ragged", rag_in)):
            for op in ("f32", "bf16"):
                got = run(inp, op)
                torch.cuda.synchronize()
                want = run(inp, op, kernel=False)             # rtol = atol/max = tol
                tol = TC_TOL.get((name, op), TOL[op])
                res = compare(got, want, tol, tol * float(want.abs().max()))
                errors[(name, shape_name, op)] = res
                phase("kernels", f"{name} {shape_name} {tuple(got.shape)} op={op}: "
                      f"max_abs_err {res['max_abs_err']:.3e}, worst "
                      f"{res['worst_share_of_tol']:.3e} of tol (rtol=atol/max={tol})")
                check(res["finite"] and res["worst_share_of_tol"] <= 1.0,
                      f"{name} {shape_name} {op} disagrees with its plain version")

    # 4. the slice --------------------------------------------------------
    kernels.reset_launches()
    t_slice = time.perf_counter()
    base = Session(cfg, device=dev, variant="base", calib=calib)
    base.key("b")
    for _ in range(cfg.averages):                   # S(k) from 8 background frames
        base.process(src.background())
    base.key("p")
    for f in [src.pi_frame()] + [next(frames) for _ in range(cfg.averages - 1)]:
        base.process(f)
    check(base.indextemp == 0 and not base._pending, "captures left the session mid-group")
    raw_before = LAUNCHES["fused_recon_raw_accumulate"]
    batches = [np.stack([next(frames) for _ in range(16)]) for _ in range(4)]
    results = [r for b in batches for r in base.process_group(b)]
    raw_grew = LAUNCHES["fused_recon_raw_accumulate"] - raw_before

    sim_cfg = cfg.replace(donotnormalize=False)     # as `fdoct sim` configures it
    sim = Session(sim_cfg, device=dev, variant="sim", source=src, calib=calib)
    sim.key("b")
    sim.key("p")
    for _ in range(sim_cfg.averages):
        sim.process(next(frames))
    yr_before = LAUNCHES["fused_recon_accumulate"]
    sim_batch = np.stack([next(frames) for _ in range(16)])
    sim_results = sim.process_group(sim_batch)
    torch.cuda.synchronize()
    yr_grew = LAUNCHES["fused_recon_accumulate"] - yr_before
    launches = dict(LAUNCHES)
    slice_s = time.perf_counter() - t_slice

    check(len(results) == 8, f"base session gave {len(results)} B-scans, not 8")
    for r in results + sim_results:
        check(r.bscandisp.dtype == np.uint8 and r.bscandisp.shape == (512, 512),
              f"bscandisp {r.bscandisp.dtype} {r.bscandisp.shape}")
        check(bool(torch.isfinite(r.bscandb).all()), "non-finite bscandb")
    check(len(sim_results) == 2, f"sim session gave {len(sim_results)} B-scans, not 2")
    check(raw_grew >= 8, f"kernel 1 launched {raw_grew} times for 8 groups")
    check(yr_grew >= 2, f"kernel 2 launched {yr_grew} times for 2 sim groups")
    phase("slice", f"base: 8 B-scans {results[0].bscandisp.shape} uint8 through "
          f"fused_recon_raw_accumulate (+{raw_grew} launches); sim: 2 B-scans through "
          f"fused_recon_accumulate (+{yr_grew} launches); launches this run {launches}; "
          f"{slice_s:.2f} s")

    # one group of each against the plain versions + form_bscan
    last = torch.as_tensor(batches[-1][-cfg.averages:]).to(dev)
    check(use_bf16(cfg.matmul_precision, torch.float32, dev), "'default' is not bf16 on CUDA")
    op = (calib.op_re_bf16, calib.op_im_bf16)
    plain_base = form_bscan(fused_recon_raw_accumulate_reference(
        last, base.data_yp, (1.0 / base.data_yb).contiguous(), *op),
        cfg, cfg.averages, bscanthreshold=base.bscanthreshold)
    sim_last = torch.as_tensor(sim_batch[-cfg.averages:]).to(dev)
    plain_sim = form_bscan(fused_recon_accumulate_reference(
        apodize_ratio(preprocess(sim_last, sim_cfg), sim.data_yb, sim.data_yp, sim_cfg), *op),
        sim_cfg, cfg.averages, bscanthreshold=sim.bscanthreshold)
    for label, got, want in (("base", results[-1], plain_base),
                             ("sim", sim_results[-1], plain_sim)):
        near = want.bscandb >= want.bscandb.max() - 40.0
        db_err = float((got.bscandb - want.bscandb).abs()[near].max())
        u8_err = int(np.abs(got.bscandisp.astype(int)
                            - want.bscandisp.cpu().numpy().astype(int)).max())
        phase("slice", f"{label} group vs plain pipeline: max |dB err| {db_err:.3e} on "
              f"{int(near.sum())} px within 40 dB of peak (limit 2e-2); "
              f"max uint8 diff {u8_err} (limit 1)")
        check(db_err <= 2e-2 and u8_err <= 1, f"{label} slice disagrees with plain pipeline")

    # 5. times --------------------------------------------------------------
    times = {}
    for name, run in runners.items():
        for op_name in ("bf16", "f32"):
            times[(name, op_name)] = t = timed_pair(lambda: run(flag_in, op_name),
                                                    lambda: run(flag_in, op_name, kernel=False))
            phase("times", f"{name} flagship op={op_name}: {describe(t)} | {card_line}")
    h2d = cuda_ms(lambda: torch.as_tensor(batches[0]).to(dev))
    mag = fused_recon_raw_accumulate(flag_in["raw"], flag_in["pi"], flag_in["inv"],
                                     *flag_in["bf16"])
    display = cuda_ms(lambda: form_bscan(mag, cfg, cfg.averages,
                                         bscanthreshold=base.bscanthreshold).bscandisp.cpu())
    phase("times", f"breakdown: H2D of 16 pageable frames (16 MiB) median {h2d[0]:.4f} ms "
          f"(min {h2d[1]:.4f}, max {h2d[2]:.4f}); form_bscan + D2H of one uint8 display "
          f"median {display[0]:.4f} ms (min {display[1]:.4f}, max {display[2]:.4f}); "
          f"20 single calls, CUDA events | {card_line}")
    steady = session_group_ms(base, batches, per_call=2)
    phase("times", f"Session.process_group per group (8 frames 512x2048 u8 from host "
          f"memory to uint8 display on host): median {statistics.median(steady):.3f} ms "
          f"(min {min(steady):.3f}, max {max(steady):.3f}; {len(steady)} groups "
          f"after 4 warm-up groups; host clock) | {card_line}")

    int8_entry = int8_phases(cfg, calib, src, frames, card_line, dev)
    resident_entry = resident_phases(flag_in, rag_in, card_line, dev)

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "operator": "bf16", "mma": MMA.get(name, "none (SIMT)"),
         "max_abs_err": errors[(name, "flagship", "bf16")]["max_abs_err"],
         **time_keys(times[(name, "bf16")])}
        for name in runners] + [int8_entry, resident_entry]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


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
    steady = session_group_ms(i8, batches, per_call=2)
    phase("int8 times", f"int8_direct Session.process_group per group (8 frames 512x2048 u8 "
          f"from host memory to uint8 display on host): median {statistics.median(steady):.3f}"
          f" ms (min {min(steady):.3f}, max {max(steady):.3f}; {len(steady)} groups after 4 "
          f"warm-up groups; host clock) | {card_line}")
    return {"name": name, "route": "cuda", "source": INT8_SOURCE, "replaces": REPLACES[name],
            "launches": launches, "operator": "s8", "mma": MMA[name], "max_abs_err": flag_err,
            **time_keys(hot), **time_keys(streamed, "streamed_")}


def resident_phases(flag_in: dict, rag_in: dict, card_line: str, dev: torch.device) -> dict:
    """Phases 9-10: the resident kernel against its plain version and kernel
    1, then the resident bench; returns the kernel's entry of the
    {"kernels": [...]} line."""
    from fdoct_tpu_torch import bench_resident
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.ops.kernels import (
        LAUNCHES, RESIDENT_TILE, fused_recon_raw_accumulate, fused_recon_resident,
        fused_recon_resident_reference, resident_rows_per_block,
    )

    name = "fused_recon_resident"
    tol = RESIDENT_TOL

    # 9. the kernel against its plain version and kernel 1 ----------------------
    pairs, depths = RESIDENT_TILE
    B = flag_in["raw"].shape[0]
    phase("resident kernels", f"block tile: {pairs} (frame, row) pairs x {depths} depths = "
          f"{resident_rows_per_block(B)} rows x {min(B, pairs)} frames at B={B}")
    flag_err = None
    for shape_name, inp in (("flagship", flag_in), ("ragged", rag_in)):
        x = (inp["raw"], inp["pi"], inp["inv"])
        bf16_op = inp["bf16"]
        for op in ("f32", "bf16"):
            got = fused_recon_resident(*x, *inp[op])
            torch.cuda.synchronize()
            want = fused_recon_resident_reference(*x, *inp[op])
            k1 = fused_recon_raw_accumulate(*x, *bf16_op)
            res = {"plain": compare(got, want, tol, tol * float(want.abs().max())),
                   "kernel 1": compare(got, k1, tol, tol * float(k1.abs().max()))}
            if shape_name == "flagship" and op == "bf16":
                flag_err = res["plain"]["max_abs_err"]
            phase("resident kernels", f"{name} {shape_name} {tuple(got.shape)} op={op} passed "
                  "in: " + "; ".join(f"vs {k} max_abs_err {r['max_abs_err']:.3e}, worst "
                                     f"{r['worst_share_of_tol']:.3e} of tol"
                                     for k, r in res.items())
                  + f" (rtol=atol/max={tol})")
            check(all(r["finite"] and r["worst_share_of_tol"] <= 1.0 for r in res.values()),
                  f"{name} {shape_name} {op} disagrees with its plain version or kernel 1")
    x16 = (flag_in["raw"], flag_in["pi"], flag_in["inv"], *flag_in["bf16"])
    t = timed_pair(lambda: fused_recon_resident(*x16),
                   lambda: fused_recon_resident_reference(*x16))
    phase("resident kernels", f"{name} flagship op=bf16: {describe(t)} | {card_line}")

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
    return {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "operator": "bf16", "max_abs_err": flag_err,
            **time_keys(t)}


if __name__ == "__main__":
    sys.exit(main())
