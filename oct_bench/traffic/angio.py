"""The ``angio`` traffic kind: OCT-angiography volumes one after another, one
in flight, each doing what ``cscan --angio`` does on one card from the
stacked host frames to every array it writes (the PNG encodes and the disk
writes left out).

A mix of this kind gives ``frames`` (a volume's camera frames, whole groups
of the configuration's repeats), ``host_volumes`` (the seeded volumes the
frames cycle through in host memory), ``warmup_volumes``,
``traced_volumes`` and ``flow_share``.  Frames come position-major in
repeat groups: at each position every repeat keeps each static scatterer's
depth and reflectivity, a seeded ``flow_share`` of the scatterers (the
vessels) is drawn anew for each repeat, and every frame has noise of its
own.  The comparison takes the structure and decorrelation volumes, the
en-face angiogram and the structural dB MIP of a seeded volume of the window and of the last one
against :mod:`oct_bench.reference.ssada_ref`.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from oct_bench import angio_bounds, frames
from oct_bench.devtrace import Profiler
from oct_bench.generator import TRACE_AT, Reservoir, Run, mark, memory_peak
from oct_bench.judge import F64, level_gap, on_device
from oct_bench.reference import ssada_ref

CHECKS = ("structure_rel_gap", "structure_max_gap", "decorr_max_gap", "decorr_mean_gap",
          "mask_mismatch", "angio_mip_mean_gap", "structure_mip_mean_gap")


def _intensity(z, r, lam, s, peak):
    phase = (4 * np.pi) * z / lam                            # (p, h, J, w)
    re = 1.0 + (r * torch.cos(phase)).sum(2)
    im = (r * torch.sin(phase)).sum(2)
    return s * (re * re + im * im) / peak * 0.9


def repeat_frames(cfg, positions: int, repeats: int, flow_share: float,
                  g: torch.Generator, device: torch.device) -> torch.Tensor:
    """(positions·repeats, height, width) position-major frames of
    :mod:`oct_bench.frames`' interferogram, in blocks of positions."""
    lam = frames.wavelengths(cfg, device).to(torch.float32)
    s = frames.spectrum(lam, cfg).to(torch.float32)
    zlo, zhi = frames.depth_range(cfg)
    lo, hi = frames.REFLECTIVITY
    peak = (1.0 + frames.SCATTERERS * hi) ** 2
    h, w = cfg.height, cfg.width
    block = max(1, frames.BLOCK_ELEMENTS // (h * frames.SCATTERERS * w))
    out = torch.empty((positions, repeats, h, w), dtype=frames._dtype(cfg.bpp), device=device)
    for a in range(0, positions, block):
        b = min(positions, a + block)
        shape = (b - a, h, frames.SCATTERERS, 1)

        def draw():
            return (zlo + (zhi - zlo) * torch.rand(shape, generator=g, device=device),
                    lo + (hi - lo) * torch.rand(shape, generator=g, device=device))

        z, r = draw()
        flow = torch.rand(shape, generator=g, device=device) < flow_share
        for n in range(repeats):
            if n:
                zn, rn = draw()
                z, r = torch.where(flow, zn, z), torch.where(flow, rn, r)
            noise = frames.NOISE * torch.randn((b - a, h, w), generator=g, device=device)
            out[a:b, n] = frames._quantize(_intensity(z, r, lam, s, peak), noise, cfg.bpp)
    return out.reshape(positions * repeats, h, w)


def run(cell, seed: int, seconds: float, trace: bool, device: torch.device,
        t_start: float) -> Run:
    """Angiography volumes back to back; the window runs from the end of
    the warm-up volumes to the end of the last volume started inside
    ``seconds``."""
    # first, so that a program without the angiography path fails at once
    from fdoct_tpu_torch import angio
    from fdoct_tpu_torch.parallel import sharded
    from fdoct_tpu_torch.pipeline import preprocess
    from fdoct_tpu_torch.utils import to_host

    mix = cell.traffic
    cfg = cell.pipeline()
    acfg = angio.AngioConfig.from_dict(cell.config["angio"])
    n = mix["frames"]
    angio.check_repeats(n, acfg.repeats)
    g = frames.generator(seed, device)
    vols = [repeat_frames(cfg, n // acfg.repeats, acfg.repeats, mix["flow_share"], g,
                          device).cpu().numpy()
            for _ in range(mix["host_volumes"])]
    bg_raw = frames.background_frames(cfg, 1, g, device)[0].cpu().numpy()
    mark(t_start, "frames made")
    op = angio.SplitSpectrumOperator.create(cfg, acfg, device)
    mark(t_start, "split-spectrum operator built")
    # the command's calibration frames: S(k) floored at 1, a zero π
    bg = torch.clamp_min(preprocess(torch.as_tensor(bg_raw).to(device), cfg), 1.0)
    pi = torch.zeros_like(bg)

    def volume(v: int) -> dict:
        fr = torch.as_tensor(vols[v]).to(device)
        vol = sharded.sharded_angio_volume(fr, bg, pi, op, cfg, None, acfg, gather_full=True)
        out = {"structure": to_host(vol[0]), "decorr": to_host(vol[1])}
        out.update({k: to_host(x)
                    for k, x in angio.angio_views(vol[0], vol[1], cfg.compat).items()})
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
        layer={"kind": "angio", "trace": prof.summary if prof is not None else None,
               "bound_s": angio_bounds.volume_bound(cfg, n, acfg.repeats, acfg.bands)[0]},
        check={"volumes": vols, "background": bg_raw, "angio": cell.config["angio"],
               "outputs": [(v, out) for _, v, out in checked]},
        memory_peak_bytes=peak)


def readings(check: dict, rc, device) -> dict[str, float]:
    """Each checked volume's structure, decorrelation, en-face angiogram and
    structural dB MIP against the reference's, from the volume's frames,
    S(k) (the background frame floored at 1) and a zero π, as the ``cscan``
    command calibrates.  The decorrelation is compared where the reference's
    structure is above the floor; the masks, voxel by voxel."""
    bg = torch.clamp_min(on_device(check["background"], device).to(F64), 1.0)
    pi = torch.zeros_like(bg)
    ra = ssada_ref.RefAngio.from_config(check["angio"])
    out: dict[str, list[float]] = {k: [] for k in CHECKS}
    for v, got in check["outputs"]:
        rs, rd = ssada_ref.angio_volume(on_device(check["volumes"][v], device), bg, pi, rc, ra)
        if tuple(got["structure"].shape) != tuple(rs.shape) or \
                tuple(got["decorr"].shape) != tuple(rd.shape):
            return {k: math.inf for k in out}
        p = torch.as_tensor(got["structure"]).to(device).to(F64)
        diff = (p - rs).flatten(1)
        r = rs.flatten(1)
        out["structure_rel_gap"].append(float((diff.norm(dim=1) / r.norm(dim=1)).max()))
        out["structure_max_gap"].append(float((diff.abs().amax(1) / r.abs().amax(1)).max()))
        del diff, r
        want = ssada_ref.mask(rs)
        have = ssada_ref.mask(p)
        out["mask_mismatch"].append(float((want != have).double().mean()))
        gap = (torch.as_tensor(got["decorr"]).to(device).to(F64) - rd).abs()[want]
        out["decorr_max_gap"].append(float(gap.max()) if gap.numel() else math.inf)
        out["decorr_mean_gap"].append(float(gap.mean()) if gap.numel() else math.inf)
        del p, have, gap
        views = ssada_ref.angio_views(rs, rd, rc.compat)
        for key, name in (("angio_mip_mean_gap", "angio_enface"),
                          ("structure_mip_mean_gap", "structure_mip")):
            out[key].append(float(level_gap(got[name], views[name]).mean()))
        del rs, rd, want, views
    res = {k: max(v) for k, v in out.items() if v}
    res["volumes_checked"] = float(len(check["outputs"]))
    return res
