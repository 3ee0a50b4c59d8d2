"""The frame→B-scan reconstruction pipeline on tensors.

The port of ``fdoct_tpu/pipeline.py``'s fused path (the reference hot loop,
BscanFFT.cpp:946-1925):

    raw frame → [median] → bin → float → [moving average]      (preprocess)
    → (y - data_yp)/data_yb                                    (apodize_ratio)
    → |yr @ M|, M the fused operator of calibration.py         (ascan_mags)
    → Σ over frames → ÷N → dB → display chain                  (form_bscan)

:func:`reconstruct_group` is the group step: apodize, magnitudes and the sum
over frames in one hand-written kernel (:mod:`fdoct_tpu_torch.ops.kernels`).
:func:`reconstruct` and :func:`ascan_mags` keep the per-frame magnitudes with
plain ``torch.matmul``, as the JAX package leaves them to XLA.

Two more ``method``s compute the magnitudes step by step, as the JAX package
does, with no kernel: ``"gather"`` (DC removal, window, zero-pad, gather
k-resample, then |IFFT|, the reference's loops; its parity path) and
``"hilbert"`` (the analytic-signal estimator on the same k-linear rows).
Their group step is the plain chain ``ascan_mags(...).sum(0)``.

Precision (``cfg.matmul_precision``): 'bf16' rounds the ratio and M to
bfloat16 and accumulates in float32; 'highest' multiplies in float32 (TF32
must be off: ``torch.backends.cuda.matmul.allow_tf32 = False``); 'default' is
'bf16' on CUDA, as the JAX package's 'default' is bf16 on its accelerator, and
float32 on the CPU, as JAX's is there.  The bf16 branch applies to float32
data only (float64 data keeps float64, as in the JAX package).  'int8'
quantizes each ratio row dynamically against the calibration's int8 tables
(plain torch ops; the JAX package has no kernel for it).  'int8_direct' is
honoured only by the session, which carries an
:class:`fdoct_tpu_torch.int8direct.Int8DirectPlan`; through these generic
entry points it is the bf16 branch on every device, as in the JAX package.

Frames are (..., oph, opw): rows are lateral A-scans, columns wavelength
samples; B-scans come out (depth, lateral).
"""

from __future__ import annotations

import functools
import inspect
from typing import NamedTuple

import numpy as np
import torch

from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.ops import (
    bin_area, median_blur, minmax_pair, normalize_minmax, normalize_rows,
    smooth_moving_average, threshold_floor, to_db, to_uint8,
)
from fdoct_tpu_torch.ops.fft import ifft_mag_rows, zeropad_rowwise
from fdoct_tpu_torch.ops.hilbert import hilbert_reconstruct
from fdoct_tpu_torch.ops.kernels import (
    RAW_ENTRY, fused_recon_accumulate, fused_recon_raw_accumulate, int8_matmul,
)
from fdoct_tpu_torch.ops.resample import resample_klinear
from fdoct_tpu_torch.ops.scale import clamp_pixel


class BscanOutputs(NamedTuple):
    """One displayed B-scan, all (depth=ndisp, lateral=oph)."""
    bscan: torch.Tensor      # linear magnitudes ÷N + eps
    bscandb: torch.Tensor    # dB, DC rows masked (BscanFFT.cpp:1235-1240)
    bscandisp: torch.Tensor  # uint8 display after threshold + normalize


#: the methods whose magnitudes are computed step by step, with no kernel
STEPWISE_METHODS = ("gather", "hilbert")


def _check_method(method: str) -> None:
    if method not in ("fused", "fused_exact") + STEPWISE_METHODS:
        raise ValueError(f"unknown method {method!r}")


def _check_precision(precision: str) -> None:
    if precision not in ("default", "highest", "bf16", "int8", "int8_direct"):
        raise ValueError(f"unknown matmul_precision {precision!r}")


def use_bf16(precision: str, dtype: torch.dtype, device: torch.device) -> bool:
    """Whether the operator products run on bfloat16 operands: 'bf16', and
    'int8'/'int8_direct' where no int8 tables apply, on float32 data; and
    'default' on CUDA."""
    if dtype != torch.float32:
        return False
    return (precision in ("bf16", "int8", "int8_direct")
            or (precision == "default" and device.type == "cuda"))


def _int8_tables_apply(precision: str, calib: Calibration) -> bool:
    return precision in ("int8", "int8_direct") and calib.op_re_q is not None


# ---------------------------------------------------------------------------


def as_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from itself or from anything numpy names a dtype by
    ("float64", np.float64), as ``jnp.dtype`` reads the JAX package's
    ``dtype`` arguments."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def preprocess(raw: torch.Tensor, cfg, dtype=None) -> torch.Tensor:
    """Raw integer frames → binned float spectra (BscanFFT.cpp:952-991:
    medianBlur, INTER_AREA resize, convertTo CV_64F, smoothmovavg).
    ``dtype`` (a torch dtype or its name; default ``cfg.dtype``) is the type
    of the spectra."""
    dtype = as_torch_dtype(dtype or cfg.dtype)
    x = raw
    if cfg.mediann > 0:
        x = median_blur(x, cfg.mediann)
    x = bin_area(x, max(cfg.binvalue, cfg.binvaluex), max(cfg.binvalue, cfg.binvaluey))
    y = x.to(dtype)
    if cfg.movavgn > 0:
        y = smooth_moving_average(y, cfg.movavgn)
    return y


def apodize_ratio(y: torch.Tensor, background: torch.Tensor,
                  pi_frame: torch.Tensor, cfg, ascan_axis=None) -> torch.Tensor:
    """(y - data_yp) / data_yb with the optional input normalizations
    (BscanFFT.cpp:1123-1132).  Each frame is min-max normalized by its own
    range, never jointly across a batch.

    ``ascan_axis``: where a rank holds only some rows of each frame (the
    mesh steps of :mod:`fdoct_tpu_torch.parallel.sharded`), the process
    group of the mesh's 'ascan' axis (``mesh.get_group("ascan")``; in JAX,
    the axis name).  Each frame's min and max then complete over the group
    in one all-reduce, so every frame sees its full-row range."""
    if cfg.rowwisenormalize:
        y = normalize_rows(y, 0.0, 1.0)
    if not cfg.donotnormalize:
        axes = (-2, -1) if y.ndim >= 2 else (-1,)
        if ascan_axis is None:
            y = normalize_minmax(y, 0.0, 1.0, axis=axes)
        else:
            from fdoct_tpu_torch.parallel.mesh import all_reduce_minmax
            lo, hi = all_reduce_minmax(torch.amin(y, dim=axes, keepdim=True),
                                       torch.amax(y, dim=axes, keepdim=True), ascan_axis)
            rng = hi - lo
            # cv::normalize NORM_MINMAX: a constant frame maps to the low bound
            y = torch.where(rng == 0, 0.0, (y - lo) / torch.where(rng == 0, 1.0, rng))
    return (y - pi_frame) / background


def _operator(calib: Calibration,
              bf16: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """(op_re, op_im, op_tf32) of the operator the precision takes: the
    bfloat16 pair with no table, or M with the calibration's TF32 table
    (None unless M is float32), which the group kernels' wrappers take."""
    if bf16:
        return calib.op_re_bf16, calib.op_im_bf16, None
    return calib.op_re, calib.op_im, calib.op_tf32


def _op_matmul_pair(yr: torch.Tensor, calib: Calibration,
                    precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    """The (re, im) operator products with one precision policy for every
    consumer, so |ascan_complex(yr)| equals ascan_mags_fused(yr).

    ``calib`` is the calibration (its M) or another operator with the same
    tables (``angio.SplitSpectrumOperator``)."""
    _check_precision(precision)
    if _int8_tables_apply(precision, calib):
        return _op_matmul_pair_int8(yr, calib)
    bf16 = use_bf16(precision, yr.dtype, yr.device)
    op_re, op_im, _ = _operator(calib, bf16)
    if bf16:
        yr, op_re, op_im = yr.to(torch.bfloat16).float(), op_re.float(), op_im.float()
    if op_re.dtype != yr.dtype:
        # a ratio in another type than M (an explicit ``dtype``): multiply in
        # the promoted type and return the ratio's, as jnp.matmul with
        # preferred_element_type=yr.dtype does
        dt = torch.promote_types(yr.dtype, op_re.dtype)
        return (torch.matmul(yr.to(dt), op_re.to(dt)).to(yr.dtype),
                torch.matmul(yr.to(dt), op_im.to(dt)).to(yr.dtype))
    return torch.matmul(yr, op_re), torch.matmul(yr, op_im)


def _op_matmul_pair_int8(yr: torch.Tensor,
                         calib: Calibration) -> tuple[torch.Tensor, torch.Tensor]:
    """s8 × s8 → s32 products against the calibration's int8 tables.  Each
    ratio row is centred first (M's first factor removes the row mean, so
    yr @ M == (yr − mean) @ M) and quantized with its own symmetric scale."""
    f32 = torch.float32
    y0 = yr.to(f32)
    y0 = y0 - y0.mean(dim=-1, keepdim=True)
    s_in = y0.abs().amax(dim=-1, keepdim=True) / 127.0
    s_in = torch.clamp_min(s_in, torch.finfo(f32).tiny)
    q = torch.round(y0 / s_in).to(torch.int8)
    re = int8_matmul(q, calib.op_re_q).to(f32) * (s_in * calib.op_scale_re)
    im = int8_matmul(q, calib.op_im_q).to(f32) * (s_in * calib.op_scale_im)
    return re.to(yr.dtype), im.to(yr.dtype)


def ascan_mags_fused(yr: torch.Tensor, calib: Calibration,
                     precision: str = "default") -> torch.Tensor:
    """A-scan magnitudes |yr @ M| (M composes DC removal, window, zero-pad,
    resample, dispersion and the truncated inverse DFT)."""
    re, im = _op_matmul_pair(yr, calib, precision)
    return torch.sqrt(re * re + im * im)


def ascan_complex(yr: torch.Tensor, calib: Calibration,
                  precision: str = "default") -> torch.Tensor:
    """Complex A-scans yr @ M, before the magnitude."""
    re, im = _op_matmul_pair(yr, calib, precision)
    return torch.complex(re, im)


def linearize(yr: torch.Tensor, calib: Calibration) -> torch.Tensor:
    """DC removal, window, zero-pad and λ→k resample of the ratio rows, the
    gather path (BscanFFT.cpp:1135-1177)."""
    y = (yr - yr.mean(dim=-1, keepdim=True)) * calib.window
    y = zeropad_rowwise(y, calib.mult, calib.bandpassfilter)
    return resample_klinear(y, calib.nearest_idx, calib.frac, compat=calib.compat)


def ascan_mags_gather(yr: torch.Tensor, calib: Calibration) -> torch.Tensor:
    """Step-by-step A-scan magnitudes truncated to the display depth
    (BscanFFT.cpp:1181-1195), with the dispersion phase when the
    calibration has one."""
    mag = ifft_mag_rows(linearize(yr, calib), calib.phase if calib.has_phase else None)
    return mag[..., :calib.ndisp]


def ascan_mags(yr: torch.Tensor, calib: Calibration, method: str = "fused",
               precision: str = "default") -> torch.Tensor:
    """A-scan magnitudes of ratio rows by ``method``; ``precision`` applies
    to 'fused' only ('fused_exact' is 'highest', the stepwise methods
    compute in the rows' type)."""
    _check_method(method)
    if method == "gather":
        return ascan_mags_gather(yr, calib)
    if method == "hilbert":
        return hilbert_reconstruct(linearize(yr, calib), calib.ndisp)
    return ascan_mags_fused(yr, calib, "highest" if method == "fused_exact" else precision)


def _accepts_raw_frames(fn):
    """``fn`` also taking its frames as ``raw_frames=``, the JAX package's
    name for them, beside ``raw`` (positional or keyword)."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(*args, raw_frames=None, **kw):
        if raw_frames is not None:
            if args or "raw" in kw:
                raise TypeError(f"{fn.__name__}() got both raw and raw_frames")
            kw["raw"] = raw_frames
        return fn(*args, **kw)

    wrapper.__signature__ = sig.replace(parameters=[
        *sig.parameters.values(),
        inspect.Parameter("raw_frames", inspect.Parameter.KEYWORD_ONLY, default=None)])
    return wrapper


@_accepts_raw_frames
def reconstruct(raw: torch.Tensor, background: torch.Tensor, pi_frame: torch.Tensor,
                calib: Calibration, cfg, method: str = "fused", dtype=None) -> torch.Tensor:
    """Raw frames (..., H, W) → per-frame A-scan magnitudes (..., oph, ndisp).
    ``dtype`` (a torch dtype or its name; default ``cfg.dtype``) is the type
    the spectra, the ratio and the products are computed in."""
    yr = apodize_ratio(preprocess(raw, cfg, dtype), background, pi_frame, cfg)
    return ascan_mags(yr, calib, method, cfg.matmul_precision)


def raw_kernel_applies(raw: torch.Tensor, cfg) -> bool:
    """Whether the ratio can be formed from the raw counts inside the kernel:
    8- or 16-bit single-channel frames (the TPU kernel's "raw uint8/uint16
    frames") and an identity preprocess and normalization (no median,
    binning or moving average; donotnormalize and no row-wise
    normalization).  The same conditions as pallas_kernels.py:137-139."""
    return (raw.dtype in RAW_ENTRY and raw.ndim == 3
            and cfg.mediann <= 1 and cfg.movavgn <= 0
            and max(cfg.binvalue, cfg.binvaluex, cfg.binvaluey) == 1
            and cfg.donotnormalize and not cfg.rowwisenormalize)


def group_kernel_applies(op_dtype: torch.dtype) -> bool:
    """Whether the group kernels take an operator of this type: float32 or
    bfloat16.  Any other (a float64 config's M) runs the plain chain on
    every device, so the CPU takes the route the card takes; the kernels'
    wrappers keep raising for it on CUDA."""
    return op_dtype in (torch.float32, torch.bfloat16)


def kernel_operator(method: str, cfg, calib: Calibration, device: torch.device,
                    dtype: torch.dtype | None = None) -> str | None:
    """The operator a product kernel of the port's multiplies by, one rule
    for every route that picks a kernel (:func:`reconstruct_group`,
    :func:`ratio_group_sum`, ``parallel.sharded.cscan_kernel_route``):
    ``"bf16"``, the bfloat16 pair, where the products run on bfloat16
    operands (:func:`use_bf16`); ``"f32"``, M with its TF32 table
    ('highest', or the 'fused_exact' method); None where the plain chain
    runs: a stepwise method ('gather', 'hilbert'), the int8 tables, or an
    operator the kernels do not take (:func:`group_kernel_applies`: a
    float64 config).  ``dtype`` is the ratio's (default ``cfg.dtype``);
    ``calib`` is the calibration or another operator with its tables."""
    _check_method(method)
    precision = "highest" if method == "fused_exact" else cfg.matmul_precision
    _check_precision(precision)
    if method in STEPWISE_METHODS or _int8_tables_apply(precision, calib):
        return None
    bf16 = use_bf16(precision, dtype or getattr(torch, cfg.dtype), device)
    if not group_kernel_applies(_operator(calib, bf16)[0].dtype):
        return None
    return "bf16" if bf16 else "f32"


def reconstruct_group(raw: torch.Tensor, background: torch.Tensor,
                      pi_frame: torch.Tensor, calib: Calibration, cfg,
                      method: str = "fused", dark: torch.Tensor | None = None) -> torch.Tensor:
    """Σ over the group of |apodize_ratio(preprocess(raw[b]) − dark) @ M|,
    (oph, ndisp); ``dark`` (the dark variant's frame, BscanDark.cpp:1269)
    may be None.

    The counterpart of ``reconstruct_group_pallas`` (pipeline.py:253-275 of
    the JAX package) and the session's group step.  8- and 16-bit frames with an
    identity preprocess go straight to the raw-input kernel, the dark frame
    folded into its π: (y − dark − π)/bg = (raw − (π + dark))·(1/bg), one
    launch per group (the session forms π + dark once per capture and
    passes it as ``pi_frame`` with no ``dark``).  Any other configuration preprocesses, subtracts the
    dark frame and normalizes in torch ops, then runs the ratio-input
    kernel.  Under 'int8' with the calibration's int8 tables, and with an
    operator the kernels do not take (:func:`group_kernel_applies`: a
    float64 config), the plain chain runs, as the JAX package runs its
    float64 session through ``ascan_mags``.  So do the stepwise methods
    ('gather', 'hilbert'), which have no kernel: no launch.
    """
    operator = kernel_operator(method, cfg, calib, raw.device)
    dtype = getattr(torch, cfg.dtype)
    background, pi_frame = background.to(dtype), pi_frame.to(dtype)
    if operator is not None and raw_kernel_applies(raw, cfg):
        pi = pi_frame if dark is None else pi_frame + dark.to(dtype)
        return fused_recon_raw_accumulate(raw.contiguous(), pi.contiguous(),
                                          (1.0 / background).contiguous(),
                                          *_operator(calib, operator == "bf16"))
    y = preprocess(raw, cfg, dtype)
    if dark is not None:
        y = y - dark.to(dtype)
    return ratio_group_sum(apodize_ratio(y, background, pi_frame, cfg), calib, cfg, method)


def ratio_group_sum(yr: torch.Tensor, calib: Calibration, cfg,
                    method: str = "fused") -> torch.Tensor:
    """Σ over the frames of |yr[b] @ M| from a ratio stack (B, oph, opw):
    the ratio-input kernel ``fused_recon_accumulate``, or the plain chain
    where :func:`reconstruct_group` takes it (a stepwise method, the int8
    tables, an operator the kernels do not take)."""
    operator = kernel_operator(method, cfg, calib, yr.device, yr.dtype)
    if operator is None:
        return ascan_mags(yr, calib, method, cfg.matmul_precision).sum(dim=0)
    return fused_recon_accumulate(yr.contiguous(), *_operator(calib, operator == "bf16"))


def reconstruct_group_frames(raw: torch.Tensor, background: torch.Tensor,
                             pi_frame: torch.Tensor, calib: Calibration, cfg,
                             method: str = "fused", dark: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """(Σ, [each frame's magnitudes]) of a group, for the session's
    ``saveframes`` ring: :func:`reconstruct_group` once per frame (B = 1, so
    a group of N frames costs N kernel launches), the sum taken in frame
    order as per-frame ``Session.process`` accumulates it, so the display
    equals that path's."""
    mags = [reconstruct_group(raw[b:b + 1], background, pi_frame, calib, cfg, method, dark)
            for b in range(raw.shape[0])]
    total = mags[0]
    for m in mags[1:]:
        total = total + m
    return total, mags


def form_bscan(mag_sum: torch.Tensor, cfg, averages: int = 1,
               bscanthreshold: float | torch.Tensor | None = None,
               eps: float = 1e-5) -> BscanOutputs:
    """Accumulated magnitudes (oph, ndisp) → displayed B-scan
    (BscanFFT.cpp:1211-1255): ÷N, +eps, dB, DC rows masked, threshold floor,
    optional absolute clamp, min-max normalize, uint8.  Runs untransposed
    and transposes at the end.  ``eps`` is 1e-5 in the live app
    (BscanFFT.cpp:1222), 1e-6 in the simulator (BscanFFTsim.cpp:949)."""
    thresh = cfg.bscanthreshold if bscanthreshold is None else bscanthreshold
    bscan_u = mag_sum / averages + eps
    db_u = to_db(bscan_u, eps=0.0, compat=cfg.compat)
    depth = torch.arange(db_u.shape[-1], device=db_u.device)
    db_u = torch.where(depth < 2, db_u[..., 4:5], db_u)      # depth cols 0,1 ← 4
    disp_u = threshold_floor(db_u, thresh)
    if cfg.clampupper:
        disp_u = clamp_pixel(disp_u, cfg.clampupperdb)
    lo, hi = minmax_pair(disp_u)
    rng = hi - lo
    safe = torch.where(rng == 0, 1.0, rng)
    disp = torch.where(rng == 0, 0.0, (disp_u.transpose(-1, -2) - lo) / safe)
    return BscanOutputs(bscan=bscan_u.transpose(-1, -2),
                        bscandb=db_u.transpose(-1, -2),
                        bscandisp=to_uint8(disp))


@_accepts_raw_frames
def reconstruct_bscan(raw: torch.Tensor, background: torch.Tensor,
                      pi_frame: torch.Tensor, calib: Calibration, cfg,
                      method: str = "fused", averages: int | None = None,
                      dtype=None) -> BscanOutputs:
    """A batch of raw frames (or one frame) → one averaged, displayed B-scan,
    through the group kernel.  A ``dtype`` other than ``cfg.dtype`` sums the
    per-frame magnitudes of :func:`reconstruct` in that type instead, as the
    JAX package does (the kernels take the calibration's type)."""
    frames = raw if raw.ndim == 3 else raw[None]
    n = averages if averages is not None else frames.shape[0]
    if dtype is not None and as_torch_dtype(dtype) != as_torch_dtype(cfg.dtype):
        mag_sum = reconstruct(frames, background, pi_frame, calib, cfg, method, dtype).sum(0)
    else:
        mag_sum = reconstruct_group(frames, background, pi_frame, calib, cfg, method)
    return form_bscan(mag_sum, cfg, n)
