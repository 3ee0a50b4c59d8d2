"""Host→device ingest benchmark of the port, the counterpart of
``scripts/bench_ingest.py`` (phases 1-4; its phase 5, the ring→device copy,
needs the camera ring reader, which is not ported yet).

1. H2D bandwidth of flagship batches (8 frames of 512 × 2048 u8, 8 MiB):
   a copy from pageable memory (``torch.as_tensor(...).to(dev)``, what the
   session did before its pinned staging) against one from a page-locked
   buffer (``non_blocking``), and the host copy of a batch into a pinned
   buffer (``np.copyto``, host clock), the pinned route's cost on the host;
2. ingest-inclusive A-scans/s through :func:`fdoct_tpu_torch.streaming.
   run_streaming`, whose step is what the JAX script's step computes,
   ``form_bscan(Σ mags)``, here through :func:`pipeline.reconstruct_bscan`
   (one group-kernel launch per batch): 40 batches of 8 frames, the source a
   cycle of 32 distinct seeded frames, as fast as it can be pulled;
3. the 500 fps triggered-capture emulation at the FLIR shape (480 × 720 u8,
   ``numfftpoints`` 720, 360 depths; BscanFFTspinjnt.ini) through the same
   pipeline: sustained fps against the 500 fps target, with the bandwidth
   500 fps needs and the rate the measured pinned link allows;
4. the bandwidth the flagship workload needs at 500 fps, beside the link.

Every streamed display is checked against a direct ``reconstruct_bscan`` of
the same frames, byte for byte (a pinned slot refilled too early would show
here).  Times (CUDA only) are CUDA-event medians and minima of 20 copies, and
host-clock spans of whole streamed runs; on the CPU everything is computed
and checked, and no time is taken.  Prints one JSON object per phase.

    python -m fdoct_tpu_torch.bench_ingest [--device cuda]
    python -m fdoct_tpu_torch.bench_ingest --device cpu --small
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from collections.abc import Callable

import numpy as np
import torch

from fdoct_tpu_torch.bench_resident import card_line
from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.pipeline import reconstruct_bscan
from fdoct_tpu_torch.streaming import run_streaming

FLAGSHIP = dict(height=512, width=2048, numfftpoints=2048, numdisplaypoints=512)
FLIR = dict(height=480, width=720, numfftpoints=720, numdisplaypoints=360)
SMALL = dict(height=32, width=256, numfftpoints=512, numdisplaypoints=128)
SMALL_FLIR = dict(height=30, width=90, numfftpoints=90, numdisplaypoints=45)
BATCH = 8
POOL = 32                  # distinct frames the source cycles through
N_BATCHES = 40
COPIES = 20                # timed copies per route in phase 1, after 3 warm-up
TARGET_FPS = 500
SEED = 0


def config(shape: dict) -> PipelineConfig:
    return PipelineConfig(**shape, binvalue=1, averages=BATCH, lambdamin=816e-9,
                          lambdamax=884e-9, dtype="float32", compat=True)


def h2d_ms(copy: Callable[[], torch.Tensor]) -> tuple[float, float]:
    """Median and min ms of COPIES copies, each between two CUDA events."""
    for _ in range(3):
        copy()
    times = []
    for _ in range(COPIES):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        copy()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), min(times)


def bandwidth(device: torch.device, shape: dict) -> dict:
    """Phase 1: pageable against pinned H2D of one batch."""
    rng = np.random.default_rng(SEED)
    pool = rng.integers(0, 255, (4, BATCH, shape["height"], shape["width"]), dtype=np.uint8)
    nbytes = pool[0].nbytes
    out = {"metric": "h2d_bandwidth", "batch_bytes": nbytes, "unit": "MB/s"}
    if device.type != "cuda":
        return {**out, "pageable": "not measured", "pinned": "not measured"}
    pinned = torch.from_numpy(pool).pin_memory()
    i = iter(range(1 << 30))
    routes = {"pageable": lambda: torch.as_tensor(pool[next(i) % 4]).to(device),
              "pinned": lambda: pinned[next(i) % 4].to(device, non_blocking=True)}
    for name, copy in routes.items():
        med, best = h2d_ms(copy)
        out[name] = {"median_ms": med, "min_ms": best, "MBps_at_median": nbytes / med / 1e3,
                     "MBps_best": nbytes / best / 1e3}
    # the host's share of the pinned route: one batch written into a pinned
    # slot, as run_streaming and the session's staging write it
    slot = pinned[0].numpy()
    times = []
    for k in range(3 + COPIES):
        t0 = time.perf_counter()
        np.copyto(slot, pool[1 + k % 3])
        times.append((time.perf_counter() - t0) * 1e3)
    med, best = statistics.median(times[3:]), min(times[3:])
    out["host_copy_into_pinned"] = {"median_ms": med, "min_ms": best,
                                    "MBps_at_median": nbytes / med / 1e3, "clock": "host"}
    return out


def streamed(device: torch.device, shape: dict) -> dict:
    """Phases 2-3: N_BATCHES batches through run_streaming, each display
    checked against a direct reconstruct_bscan of the same frames."""
    cfg = config(shape)
    calib = Calibration.create(cfg, device)
    rows, cols = cfg.height, cfg.width
    bg = torch.full((rows, cols), 128.0, device=device)
    pi = torch.zeros((rows, cols), device=device)
    rng = np.random.default_rng(SEED + 1)
    pool = rng.integers(0, 255, (POOL, rows, cols), dtype=np.uint8)

    def step(frames: torch.Tensor) -> torch.Tensor:
        return reconstruct_bscan(frames, bg, pi, calib, cfg).bscandisp

    def source():
        i = 0
        while True:
            yield pool[i % POOL]
            i += 1

    step(torch.as_tensor(pool[:BATCH]).to(device))           # build and warm the kernel
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    results, stats = run_streaming(source(), step, batch=BATCH, n_batches=N_BATCHES,
                                   device=device)
    dt = time.perf_counter() - t0
    bad = []
    for j, got in enumerate(results):
        idx = [(j * BATCH + k) % POOL for k in range(BATCH)]
        if not torch.equal(got, step(torch.as_tensor(pool[idx]).to(device))):
            bad.append(j)
    if bad:
        raise RuntimeError(f"streamed displays differ from direct reconstruct_bscan: {bad}")
    frames = len(results) * BATCH
    out = {"batches": len(results), "frames": frames, "dropped": stats.dropped,
           "displays_equal_direct": True, "shape": [rows, cols],
           "numfftpoints": cfg.numfftpoints, "numdisplaypoints": cfg.numdisplaypoints}
    if device.type != "cuda":
        return {**out, "seconds": "not measured"}
    return {**out, "seconds": dt, "fps": frames / dt, "ascans_per_s": frames * rows / dt}


def run(device: torch.device | str = "cuda", *, small: bool = False, card: str | None = None,
        log: Callable[[str], None] = print) -> None:
    """Phases 1-4 on ``device``, one JSON object each to ``log``.  Raises if
    a streamed display differs from its direct twin."""
    device = torch.device(device)
    timed = device.type == "cuda"
    if timed:
        card = card or card_line()
    flag, flir = (SMALL, SMALL_FLIR) if small else (FLAGSHIP, FLIR)

    def emit(obj: dict) -> None:
        log(json.dumps({**obj, "card": card} if timed else obj))

    bw = bandwidth(device, flag)
    emit(bw)
    s2 = streamed(device, flag)
    emit({"metric": "ingest_inclusive_ascans_per_sec", **s2})
    s3 = streamed(device, flir)
    link = bw["pinned"]["MBps_best"] if timed else None
    frame_mb = flir["height"] * flir["width"] / 1e6
    emit({"metric": "triggered_capture_emulation_fps", **s3, "target": TARGET_FPS,
          "bandwidth_needed_at_500fps_MBps": TARGET_FPS * frame_mb,
          "measured_pinned_link_MBps": link if timed else "not measured",
          "link_bound_fps": link / frame_mb if timed else "not measured"})
    need = TARGET_FPS * flag["height"] * flag["width"] / 1e6
    emit({"metric": "flagship_500fps_bandwidth_needed", "value": need, "unit": "MB/s",
          "shape": [flag["height"], flag["width"]],
          "share_of_pinned_link": need / link if timed else "not measured",
          "share_of_pageable_link": need / bw["pageable"]["MBps_best"] if timed
          else "not measured"})


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m fdoct_tpu_torch.bench_ingest",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (timed) or cpu (checks only)")
    ap.add_argument("--small", action="store_true",
                    help="32 x 256 and 30 x 90 frames instead of the flagship and FLIR shapes")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("bench_ingest: no CUDA device", file=sys.stderr)
        return 1
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    run(device, small=args.small, log=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
