#!/usr/bin/env python3
"""Per-group host times of a flagship session fed at 500 fps, on one NVIDIA
GPU: where the frame→display latency of the streamed session goes.

    python3 bench_stream.py [--mode pinned|pageable|loop] [--calls N] [--groups G]
                            [--keep all|display]

A 'base' 'default' session (kernel 1, bf16 operator) after its 'b' and 'p'
captures, fed G groups of 8 synthetic frames (seed 0, made before the run,
as a camera ring holds them) at 500 frames/s, N times in this process,
each step's result keeping every output of ``process_group`` (``all``:
its two device B-scans too, 2 MiB a group) or only the uint8 display on
the host (``display``, what a live viewer keeps):

- ``pinned``: ``streaming.run_streaming`` as the port ships it (the pinned
  ring and the side copy stream);
- ``pageable``: ``run_streaming`` with ``put`` a pageable copy on the
  compute stream (the producer thread, no ring, no side stream);
- ``loop``: one thread, no ``run_streaming``: sleep until a group is due,
  then ``process_group`` on it.

Each call prints one JSON line: latency p50 / p99 / max over its groups
(host clock, from the moment the last frame of a group is due or yielded
to the moment its uint8 display is on the host), the delay of the first
yield after the call, the host time of each ``process_group`` and of its
``to_uint8`` (the display chain's last four launches), and how many steps
took over 10 ms.  The card's name and power limit are in each line.
Exits non-zero without CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from chip_smoke import FLAGSHIP, SEED, captured_session, stamped_frames

FPS = 500


def stats(ms: list[float]) -> dict:
    a = np.asarray(ms)
    return {"p50": float(np.percentile(a, 50)), "p99": float(np.percentile(a, 99)),
            "max": float(a.max())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("pinned", "pageable", "loop"), default="pinned")
    ap.add_argument("--calls", type=int, default=1, help="streamed runs in this process")
    ap.add_argument("--groups", type=int, default=128, help="groups of 8 frames per run")
    ap.add_argument("--keep", choices=("all", "display"), default="all",
                    help="what each step's result keeps: every output of process_group "
                         "(its device B-scans too) or only the uint8 display on the host")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_stream: torch.cuda.is_available() is false; this needs a GPU",
              file=sys.stderr)
        return 1
    from fdoct_tpu_torch import pipeline
    from fdoct_tpu_torch.bench_resident import card_line
    from fdoct_tpu_torch.calibration import Calibration
    from fdoct_tpu_torch.config import PipelineConfig
    from fdoct_tpu_torch.session import Session
    from fdoct_tpu_torch.sources.synthetic import SyntheticSource
    from fdoct_tpu_torch.streaming import run_streaming

    dev = torch.device("cuda")
    card = card_line()
    cfg = PipelineConfig(**FLAGSHIP).replace(donotnormalize=True)
    calib = Calibration.create(cfg, dev)
    src = SyntheticSource(height=cfg.height, width=cfg.width, lambda0=cfg.lambda0,
                          dlambda=cfg.lambdabw * 2.3548 / 4.0, noise=0.02, seed=SEED)
    frames = src.frames()
    s = captured_session(Session, cfg, "base", src, frames, calib, dev)
    pool = np.stack([next(frames) for _ in range(64)])
    n = cfg.averages * args.groups
    frames_all = stamped_frames(pool, n)

    u8_ms: list[float] = []
    to_uint8 = pipeline.to_uint8

    def timed_to_uint8(x):
        t0 = time.perf_counter()
        out = to_uint8(x)
        u8_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    pipeline.to_uint8 = timed_to_uint8
    for call in range(args.calls):
        u8_ms.clear()
        ready, steps, done = [], [], []

        def step(batch):
            t0 = time.perf_counter()
            out = s.process_group(batch)
            done.append(time.perf_counter())
            steps.append((done[-1] - t0) * 1e3)
            return out if args.keep == "all" else [r.bscandisp for r in out]

        def paced():
            for f in frames_all:
                ready.append(time.perf_counter())
                yield f

        t_call = time.perf_counter()
        if args.mode == "loop":
            due = t_call
            for g in range(args.groups):
                due += cfg.averages / FPS
                if due > time.perf_counter():
                    time.sleep(due - time.perf_counter())
                ready.extend([due] * cfg.averages)
                step(torch.as_tensor(np.stack(frames_all[g * cfg.averages:
                                                         (g + 1) * cfg.averages])).to(dev))
        else:
            put = (lambda h: torch.as_tensor(h).to(dev)) if args.mode == "pageable" else None
            run_streaming(paced(), step, cfg.averages, args.groups, device=dev, rate_fps=FPS,
                          put=put)
        last = np.asarray(ready[cfg.averages - 1::cfg.averages][:len(done)])
        lat = (np.asarray(done) - last) * 1e3
        print(json.dumps({"mode": args.mode, "keep": args.keep, "call": call,
                          "groups": len(done),
                          "first_frame_after_ms": (ready[0] - t_call) * 1e3
                          if args.mode != "loop" else None,
                          "latency_ms": stats(lat), "step_ms": stats(steps),
                          "to_uint8_ms": stats(u8_ms),
                          "steps_over_10_ms": int((np.asarray(steps) > 10).sum()),
                          "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
