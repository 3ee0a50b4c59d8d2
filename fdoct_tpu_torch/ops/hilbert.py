"""Hilbert-phase alternative reconstruction, on ``torch.fft``.

The port of ``fdoct_tpu/ops/hilbert.py``: the analytic signal of the
k-linear spectrum supplies the complex fringe before the inverse transform,
an independent estimator to cross-check the direct inverse-FFT path (the
role of the Hilbert method in Matlab files/wangOCTrec4.m:8-12, 128-171).
"""

from __future__ import annotations

import torch

from fdoct_tpu_torch.ops.fft import _complex


def analytic_signal(x: torch.Tensor) -> torch.Tensor:
    """Row-wise analytic signal (scipy.signal.hilbert semantics): zero the
    negative frequencies, double the positive ones.  The multiplier is built
    in the real type of ``x``, so float32 rows stay complex64."""
    n = x.shape[-1]
    spec = torch.fft.fft(x.to(_complex(x.dtype)), dim=-1)
    h = torch.zeros(n, dtype=x.dtype, device=x.device)
    h[0] = 1.0
    if n % 2 == 0:
        h[n // 2] = 1.0
        h[1:n // 2] = 2.0
    else:
        h[1:(n + 1) // 2] = 2.0
    return torch.fft.ifft(spec * h, dim=-1)


def hilbert_reconstruct(ylin: torch.Tensor, ndisp: int) -> torch.Tensor:
    """Analytic-signal A-scan magnitudes of k-linear fringes, truncated to
    ``ndisp`` depths and scaled like :func:`fdoct_tpu_torch.ops.fft.ifft_mag_rows`.
    The conjugate is taken before the inverse transform: under the ifft
    convention the displayed positive-depth bins carry the negative spectral
    branch, which the analytic signal would otherwise suppress."""
    n = ylin.shape[-1]
    z = torch.conj(analytic_signal(ylin))
    return torch.fft.ifft(z, dim=-1).abs()[..., :ndisp].to(ylin.dtype) * n
