#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fdoct_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printed on its own line; any failure raises and exits non-zero:

1. device  — needs CUDA (there is no CPU branch); prints the card's name and
   power limit and turns TF32 off for matmuls and cuDNN.
2. build   — compiles csrc/fused_recon.cu with nvcc for sm_90a.
3. kernels — each kernel against its plain PyTorch version on the card, for
   a float32 and a bfloat16 operator, at the flagship shape (8 frames of
   512 x 2048 u8, the flagship M from Calibration.create, 512 depths) and at
   a ragged shape.  Tolerance: float32 rtol 1e-4, atol 1e-4*max; bfloat16
   rtol 2e-2, atol 2e-2*max.
4. slice   — the port's main path at the flagship config: Session
   (variant 'base', matmul_precision 'default' = bf16 on CUDA) captures
   'b' and 'p' from synthetic frames per frame, then process_group on 4
   batches of 16 frames (8 groups, kernel 1); a 'sim' session
   (donotnormalize=False, as `fdoct sim` sets it) runs its groups through
   kernel 2.  Launch counts are reset just before and read just after.
   One group of each is compared with the plain versions plus form_bscan:
   2e-2 dB on pixels within 40 dB of the peak, uint8 within 1 level.
5. times   — CUDA-event medians of 20 launches of each kernel and its plain
   version at the flagship shape, and the wall time per group of
   Session.process_group.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import statistics
import subprocess
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
}
SOURCE = "fdoct_tpu_torch/csrc/fused_recon.cu"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str, text: str) -> None:
    print(f"[{name}] {text}", flush=True)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def compare(got: torch.Tensor, want: torch.Tensor, tol: float) -> dict:
    """Max abs error and the worst error as a share of rtol·|want| + atol·max."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    limit = tol * want.abs() + tol * want.abs().max()
    return {"max_abs_err": float(err.max()), "worst_share_of_tol": float((err / limit).max()),
            "finite": bool(torch.isfinite(got).all())}


def cuda_ms(fn, runs: int = 20, warmup: int = 3) -> tuple[float, float, float]:
    """Median, min and max milliseconds of ``runs`` calls, each timed with
    CUDA events around one call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), min(times), max(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
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
             .splitlines() if "registers" in ln or "spill" in ln]
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
                res = compare(got, run(inp, op, kernel=False), TOL[op])
                errors[(name, shape_name, op)] = res
                phase("kernels", f"{name} {shape_name} {tuple(got.shape)} op={op}: "
                      f"max_abs_err {res['max_abs_err']:.3e}, worst "
                      f"{res['worst_share_of_tol']:.3e} of tol (rtol=atol/max={TOL[op]})")
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
            k = cuda_ms(lambda: run(flag_in, op_name))
            p = cuda_ms(lambda: run(flag_in, op_name, kernel=False))
            times[(name, op_name)] = (k, p)
            phase("times", f"{name} flagship op={op_name}: kernel median {k[0]:.4f} ms "
                  f"(min {k[1]:.4f}, max {k[2]:.4f}); plain median {p[0]:.4f} ms "
                  f"(min {p[1]:.4f}, max {p[2]:.4f}); 20 runs, CUDA events | {card_line}")
    h2d = cuda_ms(lambda: torch.as_tensor(batches[0]).to(dev))
    mag = fused_recon_raw_accumulate(flag_in["raw"], flag_in["pi"], flag_in["inv"],
                                     *flag_in["bf16"])
    display = cuda_ms(lambda: form_bscan(mag, cfg, cfg.averages,
                                         bscanthreshold=base.bscanthreshold).bscandisp.cpu())
    phase("times", f"breakdown: H2D of 16 pageable frames (16 MiB) median {h2d[0]:.4f} ms "
          f"(min {h2d[1]:.4f}, max {h2d[2]:.4f}); form_bscan + D2H of one uint8 display "
          f"median {display[0]:.4f} ms (min {display[1]:.4f}, max {display[2]:.4f}); "
          f"20 runs, CUDA events | {card_line}")
    group_s = []
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        base.process_group(b)                       # ends in the D2H of the displays
        group_s.append((time.perf_counter() - t0) / 2)
    for _ in range(4):
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            base.process_group(b)
            group_s.append((time.perf_counter() - t0) / 2)
    steady = group_s[4:]
    phase("times", f"Session.process_group per group (8 frames 512x2048 u8 from host "
          f"memory to uint8 display on host): median {statistics.median(steady) * 1e3:.3f} ms "
          f"(min {min(steady) * 1e3:.3f}, max {max(steady) * 1e3:.3f}; {len(steady)} groups "
          f"after 4 warm-up groups; host clock) | {card_line}")

    report = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
         "launches": launches[name], "operator": "bf16",
         "max_abs_err": errors[(name, "flagship", "bf16")]["max_abs_err"],
         "ms": times[(name, "bf16")][0][0], "plain_ms": times[(name, "bf16")][1][0]}
        for name in runners]}
    print(json.dumps(report), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
