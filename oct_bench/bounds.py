"""The card's peaks and the least time of a unit of work, counted from shapes.

A copy of ``bound_keys`` in ``chip_smoke.py`` with one rule changed: the
operations count at the bf16 dense peak for every precision, so that no
implementation of a product can read above its roofline.  (``PERF.md``
also gives the 3xTF32 convention for 'highest' products, which counts six
operations a multiply-add at the TF32 peak; that is not this metric.)
"""

from __future__ import annotations

#: one H100 SXM at 700 W, NVIDIA's data sheet, dense rates
PEAK_BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
#: operations of one real multiply-add
OPS_PER_MAC = 2


def least_seconds(macs: int, nbytes: int) -> tuple[float, str]:
    """(the least time of the card for ``macs`` multiply-adds and ``nbytes``
    read or written once, what bounds it)."""
    ops_s = macs * OPS_PER_MAC / PEAK_BF16_FLOPS
    bytes_s = nbytes / HBM_BYTES_PER_S
    return max(ops_s, bytes_s), ("operations" if ops_s >= bytes_s else "bytes")


def _frame_bytes(cfg) -> int:
    return cfg.height * cfg.width * (1 if cfg.bpp <= 8 else 2)


def _ndisp(cfg) -> int:
    return min(cfg.numdisplaypoints, cfg.numfftpoints)


def volume_bound(cfg, frames: int) -> tuple[float, str]:
    """One C-scan volume of ``frames`` frames: F·rows·W·ndisp multiply-adds for
    each part; reading the frames and writing the float32 volume."""
    rows, w, nd = cfg.height, cfg.width, _ndisp(cfg)
    nbytes = frames * _frame_bytes(cfg) + frames * nd * rows * 4
    return least_seconds(2 * frames * rows * w * nd, nbytes)
