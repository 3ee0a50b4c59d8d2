"""Log scaling, normalization and thresholding on tensors.

The display-conditioning steps of the reference hot loop
(BscanFFT.cpp:1211-1255) and its helpers (88-97, 173-178), as in
``fdoct_tpu/ops/scale.py``.
"""

from __future__ import annotations

import math

import torch

# The reference converts ln to dB with the literal 2.303, not ln(10)
# (BscanFFT.cpp:1235-1237); kept for numerical parity.
_REF_LN10 = 2.303


def to_db(x: torch.Tensor, eps: float = 1e-5, compat: bool = True) -> torch.Tensor:
    """``20·ln(x + eps)/2.303`` (BscanFFT.cpp:1222, 1235-1237); ``compat=False``
    divides by the exact ln(10)."""
    denom = _REF_LN10 if compat else math.log(10.0)
    return 20.0 * torch.log(x + eps) / denom


def normalize_minmax(x: torch.Tensor, lo: float = 0.0, hi: float = 1.0,
                     axis: int | tuple[int, ...] | None = None) -> torch.Tensor:
    """Min-max normalize to [lo, hi] over ``axis`` (all axes when None), with
    cv::normalize NORM_MINMAX semantics: a constant input maps to ``lo``
    (BscanFFT.cpp:1254)."""
    if axis is None:
        xmin, xmax = torch.aminmax(x)
    else:
        xmin = torch.amin(x, dim=axis, keepdim=True)
        xmax = torch.amax(x, dim=axis, keepdim=True)
    rng = xmax - xmin
    safe = torch.where(rng == 0, 1.0, rng)
    return torch.where(rng == 0, lo, (x - xmin) / safe * (hi - lo) + lo)


def minmax_pair(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Global (min, max) of ``x`` in one reduction."""
    lo, hi = torch.aminmax(x)
    return lo, hi


def normalize_rows(x: torch.Tensor, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """Per-row min-max normalize (normalizerows, BscanFFT.cpp:88-97)."""
    return normalize_minmax(x, lo, hi, axis=-1)


def make_only_positive(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0) (makeonlypositive, BscanFFT.cpp:173-178)."""
    return torch.clamp_min(x, 0.0)


def threshold_floor(x: torch.Tensor, thresh: float | torch.Tensor) -> torch.Tensor:
    """Display floor ``max(x, thresh)`` (BscanFFT.cpp:1247)."""
    return torch.maximum(x, torch.as_tensor(thresh, dtype=x.dtype, device=x.device))


def clamp_pixel(x: torch.Tensor, value: float, row: int = 5, col: int = 5) -> torch.Tensor:
    """Pin pixel (row, col) to ``value`` so the display scale is absolute
    (the 'q' key, BscanFFT.cpp:1248-1253)."""
    out = x.clone()
    out[..., row, col] = value
    return out


def to_uint8(x01: torch.Tensor) -> torch.Tensor:
    """[0, 1] → uint8 as ``convertTo(CV_8UC1, 255.0)`` (BscanFFT.cpp:1255):
    round half to even (as ``jnp.round``), then saturate."""
    return torch.clamp(torch.round(x01 * 255.0), 0, 255).to(torch.uint8)


def mask_dc_rows(bscan: torch.Tensor, src_row: int = 4, upto: int = 2) -> torch.Tensor:
    """Copy depth row ``src_row`` over rows [0, upto) of a (depth, lateral)
    B-scan (BscanFFT.cpp:1239-1240)."""
    depth = torch.arange(bscan.shape[-2], device=bscan.device)[:, None]
    return torch.where(depth < upto, bscan[..., src_row:src_row + 1, :], bscan)
