"""The ``cscan`` traffic kind: C-scan volumes one after another, one in
flight, each doing what the ``cscan`` command does on one card from the
stacked host frames to every array it writes (the PNG encodes and the disk
writes left out).

A mix of this kind gives ``frames`` (a volume's), ``host_volumes`` (the
seeded volumes the frames cycle through in host memory),
``warmup_volumes`` and ``traced_volumes``.  The comparison takes the
float32 volume and its views (8 dB frames as uint8, the en-face MIP as
uint8, the surface map) of a seeded volume of the window and of the last
one.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from oct_bench import bounds, frames
from oct_bench.devtrace import Profiler
from oct_bench.generator import TRACE_AT, Reservoir, Run, mark, memory_peak
from oct_bench.judge import F64, level_gap, on_device
from oct_bench.reference import cscan_views, volume as ref_volume


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> Run:
    """C-scan volumes back to back; the window runs from the end of the
    warm-up volumes to the end of the last volume started inside
    ``seconds``."""
    from fdoct_tpu_torch.calibration import Calibration
    from fdoct_tpu_torch.int8direct import Int8DirectPlan, int8_direct_supported
    from fdoct_tpu_torch.ops import normalize_minmax, to_db, to_uint8
    from fdoct_tpu_torch.parallel import sharded
    from fdoct_tpu_torch.pipeline import preprocess
    from fdoct_tpu_torch.utils import to_host
    from fdoct_tpu_torch.volume import enface_projection, surface_map

    mix = cell.traffic
    cfg = cell.pipeline()
    n = mix["frames"]
    g = frames.generator(seed, device)
    vols = [frames.sample_frames(cfg, n, g, device).cpu().numpy()
            for _ in range(mix["host_volumes"])]
    bg_raw = frames.background_frames(cfg, 1, g, device)[0].cpu().numpy()
    mark(t_start, "frames made")
    calib = Calibration.create(cfg, device)
    mark(t_start, "calibration built")
    # the command's calibration frames: S(k) floored at 1, a zero π
    bg = torch.clamp_min(preprocess(torch.as_tensor(bg_raw).to(device), cfg), 1.0)
    pi = torch.zeros_like(bg)
    plan = None
    if (cfg.matmul_precision == "int8_direct" and vols[0].dtype == np.uint8
            and int8_direct_supported(cfg)[0]):
        plan = Int8DirectPlan.create(calib, cfg, bg, pi, device=device)

    def volume(v: int) -> dict:
        fr = torch.as_tensor(vols[v]).to(device)
        if plan is not None:
            vol = sharded.sharded_cscan_volume_int8(fr, plan, cfg, None, gather_full=True)
        else:
            vol = sharded.sharded_cscan_volume(fr, bg, pi, calib, cfg, None, method="fused",
                                               gather_full=True)
        out = {"volume": to_host(vol)}
        db = to_db(vol + 1e-5, eps=0.0, compat=cfg.compat)
        out["frames"] = np.stack([to_host(to_uint8(normalize_minmax(db[i])))
                                  for i in range(0, vol.shape[0], max(1, vol.shape[0] // 8))])
        out["mip"] = to_host(to_uint8(normalize_minmax(enface_projection(db, "max"))))
        surf = surface_map(vol)
        out["surface"] = to_host(surf)
        out["surface_u8"] = to_host(to_uint8(normalize_minmax(surf.to(torch.float32))))
        return out

    for k in range(mix["warmup_volumes"]):
        volume(k % len(vols))           # each ends in host copies, which wait for the device
    mark(t_start, "warm-up volumes done")
    sample = Reservoir(1, seed)
    prof = Profiler("volume", device) if trace else None
    if prof is not None:
        prof.warm(device)
    times, last, traced = [], None, 0
    t0 = t1 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < seconds:
        v = k % len(vols)
        if prof is not None and prof.summary is None and not prof.on \
                and time.perf_counter() >= t0 + TRACE_AT * seconds:
            prof.start()
        ta = time.perf_counter()
        if prof is not None and prof.on:
            with prof.span():
                out = volume(v)
            traced += 1
        else:
            out = volume(v)
        t1 = time.perf_counter()
        times.append(t1 - ta)
        if prof is not None and prof.on and traced >= mix["traced_volumes"]:
            prof.stop()
        last = (k, v, out)
        sample.offer(last)
        k += 1
    if prof is not None and prof.on:
        prof.stop()
    peak = memory_peak(device)
    checked = list(sample.items)
    if last is not None and all(c[0] != last[0] for c in checked):
        checked.append(last)
    window = t1 - t0
    if times:
        q = np.percentile(np.array(times) * 1e3, [0, 25, 50, 75, 100]).round(1).tolist()
        mark(t_start, f"volume ms min/q1/median/q3/max {q}")
    return Run(
        attempted=k * n, failed=0,
        e2e={"cscan_frames_per_s": k * n / window,
             "cscan_volume_ms_p90": float(np.percentile(np.array(times) * 1e3, 90)),
             "setup_s": t0 - t_start},
        layer={"kind": "cscan", "trace": prof.summary if prof is not None else None,
               "bound_s": bounds.volume_bound(cfg, n)[0]},
        check={"volumes": vols, "background": bg_raw,
               "outputs": [(v, out) for _, v, out in checked]},
        memory_peak_bytes=peak)


def readings(check: dict, rc, device) -> dict[str, float]:
    """Each checked volume and its views against the reference's, from the
    volume's frames, S(k) (the background frame floored at 1) and a zero π,
    as the ``cscan`` command calibrates."""
    bg = torch.clamp_min(on_device(check["background"], device).to(F64), 1.0)
    pi = torch.zeros_like(bg)
    out: dict[str, list[float]] = {k: [] for k in ("volume_rel_gap", "volume_max_gap",
                                                   "frames_mean_gap", "mip_mean_gap",
                                                   "surface_mismatch")}
    for v, got in check["outputs"]:
        ref = ref_volume(on_device(check["volumes"][v], device), bg, pi, rc)
        if tuple(got["volume"].shape) != tuple(ref.shape):
            return {k: math.inf for k in out}
        p = torch.as_tensor(got["volume"]).to(device).to(F64)
        diff = (p - ref).flatten(1)
        r = ref.flatten(1)
        out["volume_rel_gap"].append(float((diff.norm(dim=1) / r.norm(dim=1)).max()))
        out["volume_max_gap"].append(float((diff.abs().amax(1) / r.abs().amax(1)).max()))
        del p, diff, r
        views = cscan_views(ref, rc.compat)
        out["frames_mean_gap"].append(float(level_gap(got["frames"], views["frames"])
                                            .flatten(1).mean(1).max()))
        out["mip_mean_gap"].append(float(level_gap(got["mip"], views["mip"]).mean()))
        surf = views["surface"]
        out["surface_mismatch"].append(
            float((torch.as_tensor(got["surface"]).to(device) != surf).double().mean())
            if tuple(got["surface"].shape) == tuple(surf.shape) else math.inf)
        del ref, views
    res = {k: max(v) for k, v in out.items() if v}
    res["volumes_checked"] = float(len(check["outputs"]))
    return res
