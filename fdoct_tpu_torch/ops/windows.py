"""Apodization windows, in numpy float64.

Host-side only: the window enters the fused operator M when
:meth:`fdoct_tpu_torch.calibration.Calibration.create` builds it.  Same
formulas as ``fdoct_tpu/ops/windows.py`` (the reference's modified
Bartlett-Hann, BscanFFT.cpp:936-944, and the Octave scripts' comparison
windows), all length-N MATLAB-symmetric.  ``dtype`` (anything numpy reads
as a dtype; None is float64) is the type of the returned window: it is
computed in float64 and rounded once.
"""

from __future__ import annotations

import numpy as np


def _typed(w: np.ndarray, dtype) -> np.ndarray:
    return w.astype(dtype or np.float64)


def _ramp(n: int) -> np.ndarray:
    """n/(N-1) in [0, 1], the MATLAB symmetric-window argument."""
    return np.arange(n) / (n - 1) if n > 1 else np.zeros(n)


def barthann(n: int, dtype=None) -> np.ndarray:
    """w(p) = 0.62 - 0.48*|p/(N-1) - 0.5| + 0.38*cos(2π(p/(N-1) - 0.5))."""
    x = _ramp(n) - 0.5
    return _typed(0.62 - 0.48 * np.abs(x) + 0.38 * np.cos(2 * np.pi * x), dtype)


def hann(n: int, dtype=None) -> np.ndarray:
    return _typed(0.5 - 0.5 * np.cos(2 * np.pi * _ramp(n)), dtype)


def hamming(n: int, dtype=None) -> np.ndarray:
    return _typed(0.54 - 0.46 * np.cos(2 * np.pi * _ramp(n)), dtype)


def tukey(n: int, alpha: float = 0.5, dtype=None) -> np.ndarray:
    """Tapered-cosine window."""
    if alpha <= 0:
        return _typed(np.ones(n), dtype)
    if alpha >= 1:
        return hann(n, dtype)
    x = _ramp(n)
    left = 0.5 * (1 + np.cos(np.pi * (2 * x / alpha - 1)))
    right = 0.5 * (1 + np.cos(np.pi * (2 * x / alpha - 2 / alpha + 1)))
    w = np.ones(n)
    w = np.where(x < alpha / 2, left, w)
    return _typed(np.where(x >= 1 - alpha / 2, right, w), dtype)


def gaussian(n: int, sigma: float = 0.4, dtype=None) -> np.ndarray:
    """Gaussian window, σ relative to the half-width (gausswin style)."""
    half = (n - 1) / 2
    x = (np.arange(n) - half) / half if n > 1 else np.zeros(n)
    return _typed(np.exp(-0.5 * (x / sigma) ** 2), dtype)


def blackmanharris(n: int, dtype=None) -> np.ndarray:
    """4-term Blackman-Harris."""
    a0, a1, a2, a3 = 0.35875, 0.48829, 0.14128, 0.01168
    x = 2 * np.pi * _ramp(n)
    return _typed(a0 - a1 * np.cos(x) + a2 * np.cos(2 * x) - a3 * np.cos(3 * x), dtype)


_WINDOWS = {
    "barthann": barthann,
    "hann": hann,
    "hamming": hamming,
    "tukey": tukey,
    "gaussian": gaussian,
    "blackmanharris": blackmanharris,
    "rect": lambda n, dtype=None: _typed(np.ones(n), dtype),
}


def get_window(kind: str, n: int, dtype=None, **kw) -> np.ndarray:
    """Window factory; ``kind`` is one of ``_WINDOWS``."""
    try:
        fn = _WINDOWS[kind]
    except KeyError:
        raise ValueError(f"unknown window {kind!r}; have {sorted(_WINDOWS)}") from None
    return fn(n, dtype=dtype, **kw)
