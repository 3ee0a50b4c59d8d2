"""λ→k resampling as a dense host-side matrix (numpy float64).

``resample_matrix`` is the operator form of the reference's per-frame
interpolation loop (BscanFFT.cpp:1150-1177) that the fused operator M is
composed from; the semantics of ``compat`` are described in
``fdoct_tpu/ops/resample.py``.  The gather form (``resample_klinear``) belongs
to the gather path, which this port does not have yet.
"""

from __future__ import annotations

import numpy as np


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
