"""int8-direct display path: zero elementwise work on the big input.

The port of ``fdoct_tpu/int8direct.py``.  The f32 path computes
|((y − π)/bg) @ M|.  Here the calibration frames fold into the operator:

- the background bg ≈ u[r]·v[c] (rank 1); 1/v folds into the operator
  rows and 1/u scales the small output per row;
- π (and the dark frame, which enters linearly) becomes a constant output
  correction (π + dark) @ Mv;
- camera counts are exact 8-bit integers, so the bias-shifted s8 frame
  ``raw ^ 0x80`` has no quantization error; only the operator is quantized
  (symmetric per output column, with column-sum error feedback), and the
  +128 bias becomes the constant row 128·colsum(Mv).

Per group the device then runs two s8 × s8 → s32 products and an
O(rows × ndisp) epilogue: :func:`reconstruct_int8_direct` per frame, or
:func:`reconstruct_bscan_int8_fused`, one launch of the hand-written kernel
``ops.kernels.int8_bscan_display_fused`` with the display chain fused, plus
a small normalize + transpose + uint8 tail.

The plan tables are built on the host in numpy float64 (:class:`Int8DirectPlan`)
and moved once to an explicit device.  Display mode only: the error is the
operator quantization plus the background's rank-1 residual.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping

import numpy as np
import torch

from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.ops import to_uint8
from fdoct_tpu_torch.ops.kernels import (
    int8_bscan_display_fused, int8_matmul, pack_int8_operator,
)
from fdoct_tpu_torch.pipeline import BscanOutputs


def rank1_factor(bg: np.ndarray, iters: int = 4) -> tuple[np.ndarray, np.ndarray, float]:
    """Best rank-1 factorization ``bg ≈ u[:, None]·v[None, :]`` by alternating
    least squares.  Returns (u, v, rel_residual), ``v`` normalized to mean 1
    so that ``u`` carries the per-row intensity scale."""
    b = np.asarray(bg, np.float64)
    v = b.mean(axis=0)
    v = np.where(v == 0.0, 1e-12, v)
    u = np.ones(b.shape[0])
    for _ in range(iters):
        u = (b @ v) / (v @ v)
        u = np.where(u == 0.0, 1e-12, u)
        v = (u @ b) / (u @ u)
        v = np.where(v == 0.0, 1e-12, v)
    scale = v.mean()
    if scale == 0.0:
        scale = 1.0
    v = v / scale
    u = u * scale
    resid = float(np.linalg.norm(b - np.outer(u, v)) / (np.linalg.norm(b) + 1e-300))
    return u, v, resid


def _quant_cols(A: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-column int8 quantization with column-sum error feedback:
    ±1 nudges go to the entries with the largest same-signed rounding
    residual until each quantized column sum matches the exact one to half a
    quantum, so the DC of the camera counts (which passes through colsum)
    leaks no accumulated rounding error into the output."""
    s = np.abs(A).max(axis=0) / 127.0
    s = np.where(s == 0.0, 1.0, s)
    q = np.clip(np.rint(A / s), -127.0, 127.0)
    resid = A / s - q
    delta = np.rint(A.sum(axis=0) / s - q.sum(axis=0)).astype(np.int64)
    for d in np.nonzero(delta)[0]:
        k = int(delta[d])
        sign = 1 if k > 0 else -1
        order = np.argsort(-sign * resid[:, d])
        room = (q[order, d] * sign) < 127.0
        picks = order[room][: abs(k)]
        q[picks, d] += sign
    return q.astype(np.int8), s.astype(np.float32)


def int8_direct_supported(cfg) -> tuple[bool, str]:
    """Whether the int8-direct path computes the f32 pipeline's function for
    this config: the frame → magnitudes map must be affine in the raw 8-bit
    counts."""
    if cfg.bpp > 8:
        return False, "input must be 8-bit camera counts (bpp <= 8)"
    if cfg.mediann > 0:
        return False, "median filter is nonlinear (mediann > 0)"
    if cfg.movavgn > 0:
        return False, "moving-average smoothing not folded (movavgn > 0)"
    if max(cfg.binvalue, cfg.binvaluex, cfg.binvaluey, 1) != 1:
        return False, "software binning not folded (binvalue[x/y] > 1)"
    if cfg.rowwisenormalize or not cfg.donotnormalize:
        return False, "input normalization is data-dependent (nonlinear)"
    return True, ""


def to_s8(raw_u8: np.ndarray) -> np.ndarray:
    """Host bias shift u8 → s8 (raw − 128 == raw ^ 0x80 bit-exactly).
    Rejects anything but uint8: a cast would wrap 16-bit counts."""
    arr = np.asarray(raw_u8)
    if arr.dtype != np.uint8:
        raise TypeError(f"to_s8 expects exact uint8 camera counts, got {arr.dtype} "
                        "(16-bit sources are unsupported by int8_direct — see "
                        "int8_direct_supported)")
    return np.bitwise_xor(arr, 0x80).view(np.int8)


def shift_u8_to_s8(raw_u8: torch.Tensor) -> torch.Tensor:
    """Device bias shift for frames already resident as uint8."""
    if raw_u8.dtype != torch.uint8:
        raise TypeError(f"shift_u8_to_s8 expects uint8 counts, got {raw_u8.dtype}")
    return torch.bitwise_xor(raw_u8, 0x80).view(torch.int8)


def _host64(x: Any) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().double().numpy()
    return np.asarray(x, np.float64)


@dataclasses.dataclass(frozen=True)
class Int8DirectPlan:
    """Tables for :func:`reconstruct_int8_direct`, as tensors on one device.

    Rebuilt whenever the background / π / dark frames change (the 'b'/'p'
    captures); the per-frame path touches only the tables.  The rank-2
    fields (``oq2_*``, ``s2_*``, ``row_gain2``) are None for a rank-1 plan.
    ``oq_packed`` is not a leaf of the JAX plan: it is (oq_re, oq_im) packed
    K-major for the s8 tensor cores (``pack_int8_operator``), made once per
    plan by :meth:`from_arrays`.
    """

    oph: int
    opw: int
    ndisp: int

    oq_re: torch.Tensor             # (opw, ndisp) int8, quantized diag(1/v) @ M
    oq_im: torch.Tensor
    s_re: torch.Tensor              # (ndisp,) float32 dequant scales
    s_im: torch.Tensor
    row_gain_inv: torch.Tensor      # (oph, 1) float32: 1/u (rank 1), u1 (rank 2)
    const_re: torch.Tensor          # (oph, ndisp) float32: bias and π/dark terms
    const_im: torch.Tensor
    bg_rank1_resid: torch.Tensor    # () float32 diagnostic
    oq2_re: torch.Tensor | None = None   # (opw, ndisp) int8, quantized diag(v2) @ M
    oq2_im: torch.Tensor | None = None
    s2_re: torch.Tensor | None = None    # (ndisp,) float32
    s2_im: torch.Tensor | None = None
    row_gain2: torch.Tensor | None = None  # (oph, 1) float32: u2
    oq_packed: torch.Tensor | None = None  # (2, ndisp, opw padded) int8, K-major

    @classmethod
    def create(cls, calib: Calibration, cfg, background, pi_frame, dark_frame=None,
               rank: int = 1, device: torch.device | str | None = None) -> "Int8DirectPlan":
        """Fold bg/π/dark into quantized operator tables on the host in
        float64 and put them on ``device`` (default: the calibration's).

        M is the calibration's working-dtype operator upcast to float64, as
        the JAX package folds it, so that the quantizer picks the same
        integers.  ``rank=2`` folds the top-2 SVD of the reciprocal
        background: two quantized operator pairs, four s8 products.  Raises
        ValueError for a config the folding does not support."""
        supported, why = int8_direct_supported(cfg)
        if not supported:
            raise ValueError(f"int8_direct unsupported for this config: {why}")
        if rank not in (1, 2):
            raise ValueError(f"rank must be 1 or 2, got {rank}")
        M_re, M_im = _host64(calib.op_re), _host64(calib.op_im)   # (opw, ndisp)
        bg = _host64(background)
        pi = _host64(pi_frame)
        if dark_frame is not None:
            pi = pi + _host64(dark_frame)
        device = calib.op_re.device if device is None else device

        if rank == 2:
            binv = 1.0 / np.where(bg == 0.0, 1e-12, bg)
            U, S, Vt = np.linalg.svd(binv, full_matrices=False)
            u1, v1 = U[:, 0] * S[0], Vt[0]
            u2, v2 = U[:, 1] * S[1], Vt[1]
            resid = float(np.linalg.norm(binv - np.outer(u1, v1) - np.outer(u2, v2))
                          / (np.linalg.norm(binv) + 1e-300))
            Mv1_re, Mv1_im = M_re * v1[:, None], M_im * v1[:, None]
            Mv2_re, Mv2_im = M_re * v2[:, None], M_im * v2[:, None]
            oq_re, s_re = _quant_cols(Mv1_re)
            oq_im, s_im = _quant_cols(Mv1_im)
            oq2_re, s2_re = _quant_cols(Mv2_re)
            oq2_im, s2_im = _quant_cols(Mv2_im)
            # the π/dark term uses the exact reciprocal; the +128 bias passes
            # through both folded operators' exact column sums
            bias_re = 128.0 * (np.outer(u1, Mv1_re.sum(axis=0)) + np.outer(u2, Mv2_re.sum(axis=0)))
            bias_im = 128.0 * (np.outer(u1, Mv1_im.sum(axis=0)) + np.outer(u2, Mv2_im.sum(axis=0)))
            arrays = dict(oq_re=oq_re, oq_im=oq_im, s_re=s_re, s_im=s_im,
                          row_gain_inv=u1[:, None],
                          const_re=bias_re - (pi * binv) @ M_re,
                          const_im=bias_im - (pi * binv) @ M_im,
                          bg_rank1_resid=resid, oq2_re=oq2_re, oq2_im=oq2_im,
                          s2_re=s2_re, s2_im=s2_im, row_gain2=u2[:, None])
            return cls.from_arrays(arrays, device)

        u, v, resid = rank1_factor(bg)
        Mv_re = M_re / v[:, None]
        Mv_im = M_im / v[:, None]
        oq_re, s_re = _quant_cols(Mv_re)
        oq_im, s_im = _quant_cols(Mv_im)
        uinv = (1.0 / u)[:, None]                               # (oph, 1)
        arrays = dict(oq_re=oq_re, oq_im=oq_im, s_re=s_re, s_im=s_im, row_gain_inv=uinv,
                      const_re=(128.0 * Mv_re.sum(axis=0)[None, :] - pi @ Mv_re) * uinv,
                      const_im=(128.0 * Mv_im.sum(axis=0)[None, :] - pi @ Mv_im) * uinv,
                      bg_rank1_resid=resid)
        return cls.from_arrays(arrays, device)

    @classmethod
    def from_arrays(cls, arrays: Mapping[str, Any],
                    device: torch.device | str) -> "Int8DirectPlan":
        """Tensors on ``device`` from host arrays named as the JAX plan's
        leaves (the rank-2 ones may be missing or None): int8 tables stay
        int8, the rest become float32, and the K-major operator is packed
        from oq_re and oq_im.  How the JAX package and the port run on one
        plan."""
        device = torch.device(device)

        def as_dev(name: str) -> torch.Tensor | None:
            a = arrays.get(name)
            if a is None:
                return None
            a = np.asarray(a)
            if name.startswith("oq") and a.dtype != np.int8:
                raise TypeError(f"{name} must be int8, got {a.dtype}")
            a = np.array(a, dtype=np.int8 if name.startswith("oq") else np.float32)
            return torch.as_tensor(a, device=device)

        tables = {f.name: as_dev(f.name) for f in dataclasses.fields(cls)
                  if f.name not in ("oph", "opw", "ndisp", "oq_packed")}
        opw, ndisp = tables["oq_re"].shape
        return cls(oph=tables["const_re"].shape[0], opw=opw, ndisp=ndisp,
                   oq_packed=pack_int8_operator(tables["oq_re"], tables["oq_im"]), **tables)


def reconstruct_int8_direct(frames_s8: torch.Tensor, plan: Int8DirectPlan) -> torch.Tensor:
    """A-scan magnitudes from bias-shifted s8 frames (..., oph, opw): two
    s8 × s8 → s32 products (four for a rank-2 plan) and a float32 epilogue.
    Returns (..., oph, ndisp) float32."""
    f32 = torch.float32
    re = (int8_matmul(frames_s8, plan.oq_re).to(f32) * plan.s_re) * plan.row_gain_inv \
        + plan.const_re
    im = (int8_matmul(frames_s8, plan.oq_im).to(f32) * plan.s_im) * plan.row_gain_inv \
        + plan.const_im
    if plan.oq2_re is not None:
        re = re + (int8_matmul(frames_s8, plan.oq2_re).to(f32) * plan.s2_re) * plan.row_gain2
        im = im + (int8_matmul(frames_s8, plan.oq2_im).to(f32) * plan.s2_im) * plan.row_gain2
    return torch.sqrt(re * re + im * im)


def int8_bscan_outputs(frames_s8: torch.Tensor, plan: Int8DirectPlan, thresh: float,
                       averages: int, compat: bool = True, eps: float = 1e-5,
                       with_linear: bool = True) -> BscanOutputs:
    """One averaged, displayed B-scan from a group of s8 frames through one
    launch of ``int8_bscan_display_fused`` and the normalize + transpose +
    uint8 tail, as ``form_bscan(reconstruct_int8_direct(...).sum(0))``
    computes it.  Rank-1 plans only, and no ``clampupper`` (callers gate on
    both and take that plain chain instead).  ``bscan`` is None unless
    ``with_linear``."""
    if plan.oq2_re is not None:
        raise ValueError("the fused int8 B-scan takes rank-1 plans only")
    denom = 2.303 if compat else math.log(10.0)
    out = int8_bscan_display_fused(frames_s8, plan.oq_re, plan.oq_im, plan.s_re, plan.s_im,
                                   plan.row_gain_inv, plan.const_re, plan.const_im,
                                   thresh, averages, eps=eps, denom=denom,
                                   with_linear=with_linear, oq_packed=plan.oq_packed)
    lo, hi = out.mn.min(), out.mx.max()
    rng = hi - lo
    safe = torch.where(rng == 0, 1.0, rng)
    disp_u = torch.clamp_min(out.db, thresh)
    disp01 = torch.where(rng == 0, 0.0, (disp_u.T - lo) / safe)
    return BscanOutputs(bscan=None if out.linear is None else out.linear.T,
                        bscandb=out.db.T, bscandisp=to_uint8(disp01))


def reconstruct_bscan_int8_fused(frames_s8: torch.Tensor, plan: Int8DirectPlan, thresh: float,
                                 averages: int, compat: bool = True,
                                 eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """(bscandb (ndisp, rows), bscandisp uint8 (ndisp, rows)) of one averaged
    group, the kernel writing exactly the TPU kernel's outputs (no linear
    image).  See :func:`int8_bscan_outputs`."""
    out = int8_bscan_outputs(frames_s8, plan, thresh, averages, compat, eps, with_linear=False)
    return out.bscandb, out.bscandisp
