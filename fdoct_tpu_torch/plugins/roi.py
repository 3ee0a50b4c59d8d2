"""ROI intensity reporting and A-scan min/max (the Status-window analytics).

The port's own copy of ``fdoct_tpu/plugins/roi.py``.  It differs in one
way: a B-scan that lives on a device (a tensor) is sliced there and only
the slice comes to the host (``np.asarray`` of a CUDA tensor raises, and the
whole dB B-scan is not needed).

reference: printAvgROI (BscanFFT.cpp:99-144) — mean of a 3-row ROI of the dB
B-scan plus a scrolling 600×300 strip chart mapping 0-50 dB onto 300 px;
printMinMaxAscan (BscanFFT.cpp:146-171) — min/max of one A-scan column with
the DC rows masked by a copy of row 4.
"""

from __future__ import annotations

import numpy as np

from fdoct_tpu_torch.utils import to_host


def ascan_min_max(bscandb, ascanat: int, ndisp: int) -> tuple[float, float]:
    """Min/max of A-scan column ``ascanat`` with rows 0-3 masked by row 4
    (reference: printMinMaxAscan)."""
    col = to_host(bscandb[:, ascanat]).copy()
    col[0:4] = col[4]
    col = col[:ndisp]
    return float(col.min()), float(col.max())


def roi_mean_db(bscandb, ascanat: int, vertpos: int,
                width: int, height: int = 3) -> float | None:
    """Mean dB of the (height×width) ROI at (vertpos, ascanat); None when the
    ROI falls off the image (reference guards ascanat+width < cols)."""
    if ascanat + width >= bscandb.shape[1]:
        return None
    return float(to_host(
        bscandb[vertpos: vertpos + height, ascanat: ascanat + width]).mean())


class ROIPlugin:
    """Maintains the scrolling ROI-intensity strip chart.

    The chart is a 300×600 image; each completed B-scan appends one column
    with a 6-px tick at 300 - 6·floor(mean_dB) (0-50 dB → 0-300 px,
    reference: BscanFFT.cpp:118-137).
    """

    def __init__(self, width: int = 600, height: int = 300):
        self.plot = np.zeros((height, width), np.float64)
        self.col = 0
        self.last_mean: float | None = None
        self.last_minmax: tuple[float, float] | None = None

    def key(self, session, ch: str) -> bool:
        return False

    def on_bscan(self, session, result) -> None:
        if not session.ROIreport:
            return
        mean = roi_mean_db(result.bscandb, session.ascanat,
                           session.vertposROI, session.widthROI)
        self.last_mean = mean
        self.last_minmax = ascan_min_max(result.bscandb, session.ascanat,
                                         session.calib.ndisp)
        if mean is None:
            session._say("ascanat+widthROI > width of image!")
            return
        session._say(f"Mean of ROI at {session.ascanat} = {mean:f} dB")
        h = self.plot.shape[0]
        vertindex = int(abs(6 * np.floor(mean)))
        if vertindex < h:
            vertindex = h - vertindex
        self.plot[:, self.col] = 0
        for d in range(-2, 4):
            if 0 < vertindex + d < h:
                self.plot[vertindex + d, self.col] = 1
        self.col = self.col + 1 if self.col < self.plot.shape[1] - 1 else 0
