"""The throughput benchmark: A-scans/s/chip of the per-group pipeline on
2048-px spectra, measured on the card.

The port of the JAX package's ``bench.py`` (``fdoct bench``), run as
``fdoct-torch bench`` (``python -m fdoct_tpu_torch bench``).  The shape is
bench.py's flagship (:data:`FLAGSHIP`): groups of 8 frames of 512 × 2048
uint8 counts, NFFT 2048, 512 depths, λ 816–884 nm, compat, float32;
background 128 and π 0 on the device.  Frames are drawn on the device from
a ``torch.Generator`` seeded with 0, u8 in [0, 255), so no host-to-device
copy enters a timed run.  The rows, named as in bench.py:

- headline, scan-chained (bench.py:102-126): per group the port's session
  route, ``pipeline.reconstruct_group`` (kernel 1, ``fused_recon_raw_accumulate``,
  one launch a group, bf16 operator at 'default' on the card) and
  ``form_bscan(..., averages=8).bscandisp``; each display's sum is added
  into a device scalar, as bench.py's ``scan`` carries it, so every group's
  display is computed;
- the bare-matmul reference (bench.py:129-146): the frames as bf16 times the
  bf16 operator pair, ``torch.mm(..., out_dtype=torch.float32)``, timed
  interleaved with each row in the same repeat loop; a row's ``*_ref_ratio``
  is its time over the reference's (a load-normalised yardstick, a library
  product on purpose);
- batched (bench.py:148-159): ``pipeline.reconstruct`` over every frame of
  16 and 64 groups at once, the sum over each group's frames, ``form_bscan``
  for each group;
- int8_direct, scan-chained and batched (bench.py:270-323): the plan folded
  from bench.py's synthetic background (``default_rng(1)``),
  ``reconstruct_int8_direct(shift_u8_to_s8(frames), plan)`` (two s8
  ``_int_mm`` products, as the JAX code's two XLA products), ``form_bscan``;
- host-inclusive (info, stderr only; bench.py:327-345): 8 groups of numpy
  frames copied into the headline chain's input and the chain run, on the
  host clock, after one untimed run on those 8 groups that captures it.

Timing keeps bench.py's definition: the median of ``repeats`` runs at g1 and
at g2 groups, per group = (t(g2) − t(g1)) / (g2 − g1).  The clock is a pair
of CUDA events around each chained run (the host clock on the CPU, which
only the tests use; ``"timer"`` says which).  On the card each chained run
is one replay of the chain's captured CUDA graph
(:class:`fdoct_tpu_torch.graphs.CapturedStep`), the counterpart of
bench.py's ``jax.jit`` of a ``lax.scan``: the graph reads the frames tensor
itself and is captured at the first run on those frames, the warm-up run
that ``measure`` leaves out of its samples (that run executes the chain
eagerly), so one event pair surrounds one replay and no capture.  An alongside row is published
only if the three checks of bench.py's ``per_group_paired`` pass (the
medians difference positively, the reference's spread is at most 0.5, the
ratio lies in [0.2, 3]); where bench.py leaves a failed row's keys out, the
port names the row and the check's words in ``"dropped"``.  An inconsistent
headline exits 1, as bench.py does.

``vs_baseline`` divides by the single-core C++ loop of
``native/cpu_baseline.cpp``, built with ``g++ -O3 -march=native`` into
``build/fdoct_tpu_torch/`` and run there, its result cached per host CPU
model.  Where the build or the run fails, ``vs_baseline`` is null and
``"baseline_error"`` says why: no constant measured on another machine
stands in for it.

The output, one JSON line on stdout: every key of bench.py's, plus
``"device"`` (the card's name and power limit, as ``nvidia-smi`` reports
them; the CPU's model on the CPU), ``"timer"``, ``"dropped"``, each row's
``*_spread``, ``"headline_groups"`` and ``"headline_launches"`` (the groups
the headline's timed runs took and the kernel 1 launches they made: equal on
the card, 0 launches on the CPU) and ``"baseline_error"`` when set.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import platform
import statistics
import subprocess
import sys
import time
from collections.abc import Callable
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.graphs import CapturedStep
from fdoct_tpu_torch.int8direct import Int8DirectPlan, reconstruct_int8_direct, shift_u8_to_s8
from fdoct_tpu_torch.ops import kernels
from fdoct_tpu_torch.ops._build import BUILD_DIR, PACKAGE_ROOT
from fdoct_tpu_torch.pipeline import form_bscan, reconstruct, reconstruct_group

METRIC = "ascans_per_sec_per_chip_2048px"
BASELINE_SOURCE = PACKAGE_ROOT.parent / "native" / "cpu_baseline.cpp"
BASELINE_SECONDS = 3           # the C++ loop's run time (bench.py:67)
SEED = 0
#: groups of numpy frames in the host-inclusive info row
HOST_GROUPS = 8
#: the publication checks of an alongside row (bench.py:209-226)
MAX_REF_SPREAD = 0.5
RATIO_BAND = (0.2, 3.0)


class Shape(NamedTuple):
    """Frames of ``rows`` × ``cols`` uint8 counts, ``batch`` a group, the
    calibration's NFFT and depths; the scan lengths of the differenced
    timing (g1, g2; batched_g1, batched_g2 for the batched rows) and the
    samples per median."""
    rows: int = 512
    cols: int = 2048
    nfft: int = 2048
    ndisp: int = 512
    batch: int = 8
    g1: int = 64
    g2: int = 256
    batched_g1: int = 16
    batched_g2: int = 64
    repeats: int = 6


#: bench.py's shape (bench.py:47-50, 90-96, 148-159)
FLAGSHIP = Shape()

#: every key of bench.py's JSON line (bench.py:347-378), with its meaning
BENCH_PY_KEYS = ("metric", "value", "unit", "vs_baseline", "headline_ref_ratio",
                 "headline_spread", "batched_ascans_per_sec", "batched_ref_ratio",
                 "int8_direct_ascans_per_sec", "int8_ref_ratio", "int8_batched_ascans_per_sec",
                 "int8_batched_ref_ratio")

#: the keys each alongside row adds to the output (bench.py:347-378); a row
#: that fails a publication check is named in "dropped" instead
ROW_KEYS = {"headline_ref": ("headline_ref_ratio",),
            "batched": ("batched_ascans_per_sec", "batched_ref_ratio"),
            "int8_direct": ("int8_direct_ascans_per_sec", "int8_ref_ratio"),
            "int8_batched": ("int8_batched_ascans_per_sec", "int8_batched_ref_ratio")}


class Dropped(RuntimeError):
    """An alongside row that failed a publication check; the message is the
    check's words."""


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------------------
# the C++ baseline


def _cpu_model() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def cpp_baseline_ascans_per_sec(shape: Shape = FLAGSHIP,
                                build_dir: Path | None = None) -> tuple[float | None, str | None]:
    """(A-scans/s, None) of the single-core C++ loop at ``shape``, built and
    run as bench.py's ``cpp_baseline_ascans_per_sec`` does, or (None, why)
    where the build or the run fails.  The binary and the cached result live
    in ``build_dir`` (default :data:`BUILD_DIR`), keyed by the host CPU model
    and the source; each is written under a temporary name and renamed, so
    a concurrent run never reads a partial file."""
    build_dir = BUILD_DIR if build_dir is None else build_dir
    key = hashlib.sha256(_cpu_model().encode() + b"\0" + BASELINE_SOURCE.read_bytes())
    tag = key.hexdigest()[:12]
    cache = build_dir / f"cpu_baseline-{tag}-{shape.rows}x{shape.cols}x{shape.nfft}x{shape.ndisp}.json"
    if cache.exists():
        return float(json.loads(cache.read_text())["ascans_per_sec"]), None
    exe = build_dir / f"cpu_baseline-{tag}"
    try:
        build_dir.mkdir(parents=True, exist_ok=True)
        if not exe.exists():
            tmp = exe.with_name(f"{exe.name}.{os.getpid()}.tmp")
            subprocess.run(["g++", "-O3", "-march=native", "-o", str(tmp), str(BASELINE_SOURCE)],
                           check=True, capture_output=True, timeout=120)
            os.replace(tmp, exe)
        out = subprocess.run([str(exe), str(shape.rows), str(shape.cols), str(shape.nfft),
                              str(shape.ndisp), str(BASELINE_SECONDS)],
                             check=True, capture_output=True, timeout=120, text=True)
        val = float(out.stdout.strip().split("=")[1])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError) as e:
        detail = getattr(e, "stderr", None)
        if isinstance(detail, bytes):
            detail = detail.decode(errors="replace")
        why = f"{type(e).__name__}: {e}" + (f" ({detail.strip()[-300:]})" if detail else "")
        _log(f"baseline compile/run failed: {why}")
        return None, why
    tmp = cache.with_name(f"{cache.name}.{os.getpid()}.tmp")
    tmp.write_text(json.dumps({"ascans_per_sec": val, "rows": shape.rows, "cols": shape.cols,
                               "cpu": _cpu_model()}))
    os.replace(tmp, cache)
    return val, None


# ---------------------------------------------------------------------------
# the rows


def config(shape: Shape) -> PipelineConfig:
    """bench.py's config (bench.py:90-96) at ``shape``."""
    return PipelineConfig(width=shape.cols, height=shape.rows, binvalue=1, averages=shape.batch,
                          numfftpoints=shape.nfft, numdisplaypoints=shape.ndisp,
                          lambdamin=816e-9, lambdamax=884e-9, dtype="float32", compat=True)


def synthetic_background(shape: Shape) -> np.ndarray:
    """The int8 rows' background (bench.py:277-283): a Gaussian spectrum with
    a row gain and 0.3 % noise from ``default_rng(1)``, float64."""
    rng = np.random.default_rng(1)
    lam = np.linspace(0, 1, shape.cols)
    spec = np.exp(-(((lam - 0.5) / 0.18) ** 2)) * 180.0 + 12.0
    gain = 1.0 + 0.05 * np.sin(np.linspace(0, 3, shape.rows))
    return gain[:, None] * spec[None, :] * (
        1 + 0.003 * rng.standard_normal((shape.rows, shape.cols)))


def gen_frames(shape: Shape, groups: int, device: torch.device) -> torch.Tensor:
    """(groups, batch, rows, cols) uint8 in [0, 255), drawn on ``device``
    from a generator seeded with :data:`SEED`."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    return torch.randint(0, 255, (groups, shape.batch, shape.rows, shape.cols),
                         dtype=torch.uint8, generator=gen, device=device)


def _bf16_product_f32(z: torch.Tensor, op: torch.Tensor) -> torch.Tensor:
    """z @ op of two bf16 matrices with float32 sums kept (JAX's
    ``preferred_element_type=float32``): cuBLAS's bf16 product with a
    float32 output on the card; on the CPU, which has no such product, the
    same exact bf16 products summed in float32."""
    if z.is_cuda:
        return torch.mm(z, op, out_dtype=torch.float32)
    return torch.mm(z.float(), op.float())


@dataclasses.dataclass
class Harness:
    """What the rows run on, made once per benchmark on one device."""
    shape: Shape
    cfg: PipelineConfig
    calib: Calibration
    background: torch.Tensor        # (rows, cols) float32, 128
    pi_frame: torch.Tensor          # (rows, cols) float32, 0
    plan: Int8DirectPlan            # the int8 rows' plan
    #: the chains' CUDA graphs, one per chain and frames tensor
    graphs: CapturedStep = dataclasses.field(default_factory=CapturedStep)

    @classmethod
    def create(cls, shape: Shape, device: torch.device | str) -> "Harness":
        device = torch.device(device)
        cfg = config(shape)
        calib = Calibration.create(cfg, device)
        size = (shape.rows, shape.cols)
        plan = Int8DirectPlan.create(calib, cfg.replace(matmul_precision="int8_direct"),
                                     synthetic_background(shape), np.zeros(size), device=device)
        return cls(shape, cfg, calib, torch.full(size, 128.0, device=device),
                   torch.zeros(size, device=device), plan)

    def group_step(self, frames: torch.Tensor) -> torch.Tensor:
        """One group's uint8 display (ndisp, rows) by the session's route:
        kernel 1 and the display chain (bench.py:102-106)."""
        mag = reconstruct_group(frames, self.background, self.pi_frame, self.calib, self.cfg)
        return form_bscan(mag, self.cfg, averages=self.shape.batch).bscandisp

    def int8_step(self, frames: torch.Tensor) -> torch.Tensor:
        """One group's uint8 display through int8_direct (bench.py:287-296)."""
        mags = reconstruct_int8_direct(shift_u8_to_s8(frames), self.plan)
        return form_bscan(mags.sum(0), self.cfg, averages=self.shape.batch).bscandisp

    def _replayed(self, chain: Callable[[torch.Tensor], torch.Tensor],
                  all_frames: torch.Tensor) -> torch.Tensor:
        """``chain(all_frames)``: called on the CPU; on the card the replay of
        its CUDA graph, whose input is ``all_frames`` itself, captured at the
        first call on those frames (which runs the chain eagerly)."""
        if all_frames.device.type != "cuda":
            return chain(all_frames)
        key, state = (chain.__name__, tuple(all_frames.shape)), (all_frames,)
        captured = self.graphs.lookup(key, state)
        if captured is None:
            return self.graphs.capture(key, state, chain, state)
        return captured.replay()

    def _chained(self, step: Callable[[torch.Tensor], torch.Tensor],
                 all_frames: torch.Tensor) -> torch.Tensor:
        """Σ over the groups of the sum of each group's display, carried in a
        device scalar as bench.py's ``scan`` carries it."""
        carry = torch.zeros((), dtype=torch.float32, device=all_frames.device)
        for frames in all_frames:
            carry = carry + step(frames).sum()
        return carry

    def _scan_chain(self, all_frames: torch.Tensor) -> torch.Tensor:
        return self._chained(self.group_step, all_frames)

    def _int8_chain(self, all_frames: torch.Tensor) -> torch.Tensor:
        return self._chained(self.int8_step, all_frames)

    def _ref_chain(self, all_frames: torch.Tensor) -> torch.Tensor:
        op_re, op_im = self.calib.op_re_bf16, self.calib.op_im_bf16
        carry = torch.zeros((), dtype=torch.float32, device=all_frames.device)
        for frames in all_frames:
            z = frames.to(torch.bfloat16).reshape(-1, frames.shape[-1])
            carry = carry + _bf16_product_f32(z, op_re).sum() + _bf16_product_f32(z, op_im).sum()
        return carry

    def _batched_chain(self, all_frames: torch.Tensor) -> torch.Tensor:
        return self.batched_displays(all_frames).sum()

    def _int8_batched_chain(self, all_frames: torch.Tensor) -> torch.Tensor:
        return self.int8_batched_displays(all_frames).sum()

    def scan_groups(self, all_frames: torch.Tensor) -> torch.Tensor:
        """The headline: every group through :meth:`group_step`."""
        return self._replayed(self._scan_chain, all_frames)

    def int8_groups(self, all_frames: torch.Tensor) -> torch.Tensor:
        return self._replayed(self._int8_chain, all_frames)

    def ref_groups(self, all_frames: torch.Tensor) -> torch.Tensor:
        """The bare-matmul reference (bench.py:129-146): each group's frames
        as bf16 times the bf16 operator pair, float32 sums."""
        return self._replayed(self._ref_chain, all_frames)

    def _displays(self, msum: torch.Tensor) -> torch.Tensor:
        return torch.stack([form_bscan(m, self.cfg, averages=self.shape.batch).bscandisp
                            for m in msum])

    def batched_displays(self, all_frames: torch.Tensor) -> torch.Tensor:
        """(groups, ndisp, rows) uint8: one ``reconstruct`` over every frame
        of every group, the sum over each group, then its display
        (bench.py:148-159)."""
        mags = reconstruct(all_frames, self.background, self.pi_frame, self.calib, self.cfg)
        return self._displays(mags.sum(1))

    def int8_batched_displays(self, all_frames: torch.Tensor) -> torch.Tensor:
        """The same through int8_direct (bench.py:306-318)."""
        mags = reconstruct_int8_direct(shift_u8_to_s8(all_frames), self.plan)
        return self._displays(mags.sum(1))

    def batched_groups(self, all_frames: torch.Tensor) -> torch.Tensor:
        return self._replayed(self._batched_chain, all_frames)

    def int8_batched(self, all_frames: torch.Tensor) -> torch.Tensor:
        return self._replayed(self._int8_batched_chain, all_frames)

    def release_graphs(self, row: str) -> None:
        """Logs the captured graphs' pools (stderr) and frees them with the
        frames they hold."""
        for (chain, shape), c in self.graphs.items():
            _log(f"info: {row} graph {chain} on {shape[0]} groups: pool "
                 f"{c.pool_bytes / 2**20:.1f} MiB, launches a replay {c.launches}")
        self.graphs.clear()


# ---------------------------------------------------------------------------
# timing


def run_seconds(fn: Callable[[torch.Tensor], torch.Tensor], frames: torch.Tensor) -> float:
    """Seconds of one chained run ``fn(frames)``, its end waited for: CUDA
    events around it on the card, the host clock on the CPU."""
    if frames.device.type != "cuda":
        t0 = time.perf_counter()
        fn(frames)
        return time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn(frames)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _median_spread(samples: list[float]) -> tuple[float, float]:
    med = statistics.median(samples)
    return med, (max(samples) - min(samples)) / med if med > 0 else float("inf")


def measure(fn, frames: torch.Tensor, repeats: int, pair_with=None):
    """Median of ``repeats`` runs of ``fn(frames)`` and its spread ((max −
    min) / median), after one warm-up run (bench.py's ``measure``).  With
    ``pair_with`` a second function is timed alternately in the same loop,
    one sample each per sweep, so both see the same load window; returns
    ((med, spread), (med_pair, spread_pair))."""
    run_seconds(fn, frames)
    if pair_with is not None:
        run_seconds(pair_with, frames)
    samples, psamples = [], []
    for _ in range(repeats):
        samples.append(run_seconds(fn, frames))
        if pair_with is not None:
            psamples.append(run_seconds(pair_with, frames))
    if pair_with is None:
        return _median_spread(samples)
    return _median_spread(samples), _median_spread(psamples)


def per_group_paired(name: str, fn, ref, frames1: torch.Tensor, frames2: torch.Tensor,
                     repeats: int) -> tuple[float, float, float]:
    """(per-group seconds, ratio to the reference, worst spread) of an
    alongside row timed interleaved with the reference at the two scan
    lengths ``len(frames1)`` < ``len(frames2)``.  Raises :class:`Dropped`
    where a check of bench.py's ``per_group_paired`` fails: the medians must
    difference positively, the reference's spread stay within
    :data:`MAX_REF_SPREAD` and the ratio within :data:`RATIO_BAND`."""
    g1, g2 = len(frames1), len(frames2)
    (t1, s1), (r1, rs1) = measure(fn, frames1, repeats, pair_with=ref)
    (t2, s2), (r2, rs2) = measure(fn, frames2, repeats, pair_with=ref)
    if not t2 > t1 > 0:
        raise Dropped(f"inconsistent {name} timings t({g1})={t1:.4f}s t({g2})={t2:.4f}s")
    per = (t2 - t1) / (g2 - g1)
    if not r2 > r1 > 0 or max(rs1, rs2) > MAX_REF_SPREAD:
        raise Dropped(f"{name} ref timings untrustworthy (t({g1})={r1:.4f}s t({g2})={r2:.4f}s, "
                      f"spreads {rs1 * 100:.0f}%/{rs2 * 100:.0f}%)")
    ratio = per / ((r2 - r1) / (g2 - g1))
    if not RATIO_BAND[0] <= ratio <= RATIO_BAND[1]:
        raise Dropped(f"{name} ratio {ratio:.2f} outside the physical "
                      f"[{RATIO_BAND[0]}, {RATIO_BAND[1]}] band")
    _log(f"info: {name} per-group {per * 1e3:.3f} ms (median of {repeats}; spread "
         f"{s1 * 100:.1f}%/{s2 * 100:.1f}%; ref ratio {ratio:.3f})")
    return per, ratio, max(s1, s2)


def device_info(device: torch.device) -> dict:
    """The card's name and power limit as ``nvidia-smi`` reports them (it
    must be there: no value is made up), or the CPU's model."""
    if device.type != "cuda":
        return {"name": _cpu_model(), "power_limit_w": None}
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    name, limit = (f.strip() for f in out.stdout.strip().splitlines()[0].rsplit(",", 1))
    return {"name": name, "power_limit_w": float(limit.split()[0])}


# ---------------------------------------------------------------------------


def _alongside(out: dict, dropped: dict, row: str, fn, harness: Harness, g1: int, g2: int,
               device: torch.device) -> float | None:
    """One alongside row into ``out`` (its ascans/s, ratio and spread), or
    its reason into ``dropped``; returns its per-group seconds."""
    shape = harness.shape
    try:
        per, ratio, spread = per_group_paired(row, fn, harness.ref_groups,
                                              gen_frames(shape, g1, device),
                                              gen_frames(shape, g2, device), shape.repeats)
    except Dropped as e:
        _log(f"warn: {e} — row dropped")
        dropped[row] = str(e)
        return None
    finally:
        harness.release_graphs(row)
    rate_key, ratio_key = ROW_KEYS[row]
    out[rate_key] = round(shape.batch * shape.rows / per, 1)
    out[ratio_key] = round(ratio, 3)
    out[f"{row}_spread"] = round(spread, 3)
    return per


def main(device: torch.device | str = "cuda", shape: Shape | None = None) -> int:
    """Runs every row, prints the JSON line and returns 0; exits 1 when the
    headline's timings are inconsistent."""
    device = torch.device(device)
    shape = FLAGSHIP if shape is None else shape
    harness = Harness.create(shape, device)

    # the headline, interleaved with the bare-matmul reference
    frames1, frames2 = gen_frames(shape, shape.g1, device), gen_frames(shape, shape.g2, device)
    launched = kernels.LAUNCHES["fused_recon_raw_accumulate"]
    (h1, hs1), (r1, rs1) = measure(harness.scan_groups, frames1, shape.repeats,
                                   pair_with=harness.ref_groups)
    (h2, hs2), (r2, rs2) = measure(harness.scan_groups, frames2, shape.repeats,
                                   pair_with=harness.ref_groups)
    headline_launches = kernels.LAUNCHES["fused_recon_raw_accumulate"] - launched
    harness.release_graphs("headline")
    del frames1, frames2
    if not h2 > h1 > 0:
        _log(f"FATAL: inconsistent scan (HEADLINE) timings t({shape.g1})={h1:.4f}s "
             f"t({shape.g2})={h2:.4f}s — refusing to report a nonsense metric")
        raise SystemExit(1)
    per_group = (h2 - h1) / (shape.g2 - shape.g1)
    ascans = shape.batch * shape.rows / per_group
    _log(f"info: scan (HEADLINE) per-group {per_group * 1e3:.3f} ms (median of "
         f"{shape.repeats}; spread {hs1 * 100:.1f}%/{hs2 * 100:.1f}%)")
    out = {"metric": METRIC, "value": round(ascans, 1), "unit": "ascans/s", "vs_baseline": None}
    dropped: dict[str, str] = {}
    if r2 > r1 > 0:
        per_ref = (r2 - r1) / (shape.g2 - shape.g1)
        out["headline_ref_ratio"] = round(per_group / per_ref, 3)
        _log(f"info: ref bare-matmul per-group {per_ref * 1e3:.3f} ms; load-normalized "
             f"headline/ref = {per_group / per_ref:.3f}")
    else:
        dropped["headline_ref"] = (f"ref kernel timings inconsistent (t({shape.g1})={r1:.4f}s "
                                   f"t({shape.g2})={r2:.4f}s); ratio skipped")
        _log(f"info: {dropped['headline_ref']}")
    out["headline_spread"] = round(max(hs1, hs2), 3)
    out["headline_ref_spread"] = round(max(rs1, rs2), 3)

    _alongside(out, dropped, "batched", harness.batched_groups, harness,
               shape.batched_g1, shape.batched_g2, device)
    _alongside(out, dropped, "int8_direct", harness.int8_groups, harness,
               shape.g1, shape.g2, device)
    _alongside(out, dropped, "int8_batched", harness.int8_batched, harness,
               shape.batched_g1, shape.batched_g2, device)

    # informational: frames from host memory through the headline chain
    host = np.random.default_rng(0).integers(0, 255, (HOST_GROUPS, shape.batch, shape.rows,
                                                      shape.cols)).astype(np.uint8)
    frames = gen_frames(shape, HOST_GROUPS, device)
    float(harness.scan_groups(frames))                     # on the card, the capture
    t0 = time.perf_counter()
    frames.copy_(torch.from_numpy(host))
    float(harness.scan_groups(frames))
    dt = time.perf_counter() - t0
    harness.release_graphs("host-inclusive")
    _log(f"info: per-group {per_group * 1e3:.3f} ms on-device (scan shape, the headline); "
         f"host-inclusive streaming = {HOST_GROUPS * shape.batch * shape.rows / dt:.0f} "
         f"ascans/s ({HOST_GROUPS} groups of numpy frames copied to {device.type} and "
         "chained, host clock)")

    base, why = cpp_baseline_ascans_per_sec(shape)
    if base is not None:
        out["vs_baseline"] = round(ascans / base, 2)
    else:
        out["baseline_error"] = why
    out.update(device=device_info(device),
               timer="cuda_events" if device.type == "cuda" else "host_clock", dropped=dropped,
               headline_groups=(1 + shape.repeats) * (shape.g1 + shape.g2),
               headline_launches=headline_launches)
    print(json.dumps(out), flush=True)
    return 0
