"""JET colormap for B-scan display.

The port's own copy of ``fdoct_tpu/utils/colormap.py`` (numpy only).  The
reference colorizes every displayed B-scan with
``applyColorMap(..., COLORMAP_JET)`` (BscanFFT.cpp:1284); this is the
classic piecewise-linear jet ramp, display-equivalent to OpenCV's table.
"""

from __future__ import annotations

import numpy as np


def _jet(x: np.ndarray) -> np.ndarray:
    """GNU-Octave/MATLAB jet formula on x ∈ [0, 1] → (len(x), 3) floats."""
    r = np.clip(1.5 - np.abs(4 * x - 3.0), 0, 1)
    g = np.clip(1.5 - np.abs(4 * x - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4 * x - 1.0), 0, 1)
    return np.stack([r, g, b], axis=-1)


def jet_table(n: int = 256, anchors: int = 64) -> np.ndarray:
    """(n, 3) uint8 RGB jet table: OpenCV's COLORMAP_JET interpolates a
    64-entry GNU-Octave jet onto 256 levels, and so does this, which matches
    its table at the clip corners too."""
    xa = np.linspace(0.0, 1.0, anchors)
    table = _jet(xa)
    xq = np.linspace(0.0, 1.0, n)
    out = np.stack([np.interp(xq, xa, table[:, c]) for c in range(3)], axis=-1)
    return np.round(out * 255).astype(np.uint8)


_TABLE = jet_table()


def apply_jet(img_u8: np.ndarray) -> np.ndarray:
    """uint8 grayscale (h, w) → RGB (h, w, 3) via the jet table."""
    return _TABLE[np.asarray(img_u8, dtype=np.uint8)]
