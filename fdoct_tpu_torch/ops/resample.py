"""λ→k resampling: the gather form on tensors and the dense host matrix.

``resample_klinear`` is the gather path's per-frame interpolation
(BscanFFT.cpp:1150-1177); ``resample_matrix`` is its operator form, in numpy
float64, that the fused operator M is composed from.  The semantics of
``compat`` are described in ``fdoct_tpu/ops/resample.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def row_slopes(y: torch.Tensor) -> torch.Tensor:
    """Backward differences per row, the first column copied from the second
    (BscanFFT.cpp:1153-1161)."""
    d = torch.diff(y, dim=-1)
    return torch.cat([d[..., :1], d], dim=-1)


def resample_klinear(y: torch.Tensor, nearest_idx: torch.Tensor, frac: torch.Tensor,
                     compat: bool = True) -> torch.Tensor:
    """Gather k-linearization of ``y`` (..., n_in) → (..., nfft).

    ``nearest_idx`` ((nfft,) integers in [0, n_in), as
    :func:`fdoct_tpu_torch.calibration.reference_grids` builds them) and
    ``frac`` ((nfft,)) come from the calibration.  compat: ``ylin[q] = y[i]
    + frac[i]·(y[i] − y[i−1])`` with ``i = nearest_idx[q]`` (``frac``
    re-indexed by the clipped index, BscanFFT.cpp:1169-1171) and columns 0
    and nfft−1 zero; otherwise ``y[i] − frac[q]·(y[i] − y[i−1])``."""
    nfft = nearest_idx.shape[-1]
    yg = torch.index_select(y, -1, nearest_idx)
    sg = torch.index_select(row_slopes(y), -1, nearest_idx)
    if compat:
        f = torch.index_select(frac, -1, nearest_idx.clamp(0, nfft - 1))
        cols = torch.arange(nfft, device=y.device)
        inner = (cols > 0) & (cols < nfft - 1)
        return torch.where(inner, yg + f * sg, torch.zeros((), dtype=y.dtype, device=y.device))
    return yg - frac * sg


def resample_matrix(nearest_idx: np.ndarray, frac: np.ndarray, n_in: int,
                    compat: bool = True, dtype=np.float64) -> np.ndarray:
    """The k-linearization as a dense (n_in, nfft) operator R, ``ylin = y @ R``.

    compat: ``ylin[q] = y[i] + frac[i]·(y[i] - y[i-1])`` with ``i =
    nearest_idx[q]`` and columns 0 and nfft-1 zero, as the reference computes
    it; otherwise the correct interpolation ``y[i] - frac[q]·(y[i] - y[i-1])``.
    """
    nfft = nearest_idx.shape[-1]
    R = np.zeros((n_in, nfft), dtype=dtype)
    cols = np.arange(nfft)
    idx = nearest_idx.astype(np.int64)
    if compat:
        f = frac[np.clip(idx, 0, nfft - 1)]
        valid = (cols > 0) & (cols < nfft - 1)
    else:
        f = -frac
        valid = np.ones(nfft, bool)
    # the slope at idx == 0 is the slope at 1 (reference's first-column copy)
    prev = np.where(idx >= 1, idx - 1, 0)
    nxt = np.where(idx >= 1, idx, 1)
    np.add.at(R, (idx[valid], cols[valid]), 1.0)
    np.add.at(R, (nxt[valid], cols[valid]), f[valid])
    np.add.at(R, (prev[valid], cols[valid]), -f[valid])
    return R
