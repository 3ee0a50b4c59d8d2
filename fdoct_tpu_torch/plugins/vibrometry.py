"""Peak-hold Bessel-J0-null vibrometry (the BscanFFTpeak variant).

The port's own copy of ``fdoct_tpu/plugins/vibrometry.py`` (numpy and
scipy's ``j0``).  It differs in one way: a dB B-scan that lives on a device
(a tensor) is sliced there, to the ROI's rows, and only that band comes to
the host.

Physics: a sample vibrating sinusoidally with amplitude A phase-modulates
the interference fringe; averaged over many vibration cycles the fringe
amplitude (hence the A-scan peak) is multiplied by |J0(x)| with
x = 2·k·A = 4π·A/λ0.  Measuring the dB drop between a still hold and a
vibrating hold therefore yields x, and A = x·λ0/(4π)
(reference: BscanFFTpeak.cpp:615-624).

The reference inverts y = |20·log10 J0(x)| with a 48-entry hand lookup table
(besseldbinverse, BscanFFTpeak.cpp:243-395, steps of ~0.05 in x); here the
inverse is *computed* from a fine J0 grid (first-branch, x ∈ [0, 2.405)),
which agrees with that LUT to its own quantization.  ``errnull`` estimates
the systematic error from the distance to the first J0 null at 2.405
(BscanFFTpeak.cpp:397-415).

Peak-hold protocol (printPeakHoldAscan, BscanFFTpeak.cpp:466-738): four
holds over ``peakholdnumframes`` displayed B-scans each track per-column
maxima of the dB B-scan inside a user ROI; hold1/2 = reference (twice, for
the error bar), hold3 = vibrating, hold4 = bias.  After hold 3 the
displacement profile is besseldbinverse(max1vals - max3vals)·λ0/(4π) per
column; after hold 4 the profile is profile3 - profile4.
"""

from __future__ import annotations

import numpy as np
from scipy.special import j0 as _j0

from fdoct_tpu_torch.utils import to_host

_J0_FIRST_NULL = 2.405  # BscanFFTpeak.cpp:411

# fine inverse table on the first branch: y(x) = |20·log10 J0(x)| is
# monotonic on [0, first null)
_XGRID = np.linspace(0.0, 2.4045, 4810)
_YGRID = np.abs(20.0 * np.log10(np.abs(_j0(_XGRID))))


def bessel_db_inverse(y: float | np.ndarray) -> np.ndarray | float:
    """x such that |20·log10 J0(x)| = y, first branch; saturates at ~2.38
    for y > 30 dB like the reference LUT's top entry."""
    y = np.asarray(y, dtype=np.float64)
    x = np.interp(y, _YGRID, _XGRID, left=0.0, right=2.38)
    x = np.where(y > 30.0, 2.38, x)
    return float(x) if x.ndim == 0 else x


def errnull(y: float) -> float:
    """Error proxy: distance of the inverted x from the first null
    (reference: errnull, BscanFFTpeak.cpp:397-415)."""
    return _J0_FIRST_NULL - bessel_db_inverse(y)


def displacement_nm(db_drop, lambda0: float):
    """dB drop → displacement in nm: A = besseldbinverse(Δ)·λ0/(4π)
    (BscanFFTpeak.cpp:623)."""
    return bessel_db_inverse(db_drop) * lambda0 * 1e9 / (4 * np.pi)


def render_vib_profile(profile_nm: np.ndarray, limit_nm: int = 160) -> np.ndarray:
    """Render the ±limit_nm displacement profile into the reference's
    4·limit-tall uint8 plot, origin bottom-left (showVibProfile,
    BscanFFTpeak.cpp:417-461)."""
    h = 4 * limit_nm
    img = np.zeros((h, profile_nm.shape[-1]), np.uint8)
    vert = (2 * limit_nm + 2 * np.round(profile_nm)).astype(int)
    for xi, v in enumerate(vert):
        for d in range(2):
            if 0 < v + d < h:
                img[v + d, xi] = 255
    return img[::-1]  # flip: origin bottom-left


class VibrometryPlugin:
    """Session plugin implementing the BscanFFTpeak key set and holds."""

    def __init__(self, lambda0: float, peakholdnumframes: int = 50):
        self.lambda0 = lambda0
        self.nframes = peakholdnumframes
        self.roi = dict(x=0, y=0, w=10, h=10)   # ROIposx/y/w/h globals
        self.roi_selected = False               # set by set_roi / move keys
        self.display_profile = True
        self.active_hold: int | None = None
        self.frame_count = 0
        # the reference zero-initializes its peak holds (max1val = 0,
        # BscanFFTpeak.cpp), which silently floors scenes whose dB values are
        # negative; -inf is the faithful "no data yet" that matches its
        # intent on its own positive-dB data
        self.maxval = [-np.inf] * 4
        self.maxvals = [None, None, None, None]
        self.profile: np.ndarray | None = None
        self.profile3: np.ndarray | None = None
        self.dispnm: float | None = None
        self.errnm: float | None = None
        self.vibrindexi = 0

    # ------------------------------------------------------------------
    def set_roi(self, x: int, y: int, w: int, h: int) -> None:
        """Programmatic ROI selection (the mouse path, onMouse
        BscanFFTpeak.cpp:112-181); resets all hold arrays like the
        reference's mouse handler."""
        self.roi = dict(x=x, y=y, w=w, h=h)
        # explicit selection flag for display overlays — the (0,0) sentinel
        # below (a reference parity quirk, BscanFFTpeak.cpp:475-485) only
        # gates the hold keys
        self.roi_selected = True
        self._reset_vals()

    def _reset_vals(self) -> None:
        w = self.roi["w"]
        self.maxvals = [np.full(w, -np.inf) for _ in range(4)]
        self.profile = np.zeros(w)

    # ------------------------------------------------------------------
    def key(self, session, ch: str) -> bool:
        if ch in "1234":
            if self.active_hold is None:
                if self.roi["x"] == 0 and self.roi["y"] == 0:
                    session._say("Select an ROI first.")  # BscanFFTpeak.cpp:475-485
                    return True
                self.active_hold = int(ch)
                self.frame_count = 0
            return True
        if ch in "!@#$":
            idx = "!@#$".index(ch)
            self.maxval[idx] = -np.inf
            self.maxvals[idx] = np.full(self.roi["w"], -np.inf)
            return True
        if ch in ("v", "V"):
            self.display_profile = not self.display_profile
            return True
        if ch == ">":
            self.roi["x"] += 1
            self.roi_selected = True
            return True
        if ch == "<":
            self.roi["x"] = max(0, self.roi["x"] - 1)
            self.roi_selected = True
            return True
        if ch == ",":
            self.roi["y"] += 1
            self.roi_selected = True
            return True
        if ch == ".":
            # reference decrements ROIposx here (BscanFFTpeak.cpp '.': a
            # copy-paste slip under the "ROIposy up" comment); implementing
            # the documented intent instead
            self.roi["y"] = max(0, self.roi["y"] - 1)
            self.roi_selected = True
            return True
        if ch == "M":
            self.roi["w"] += 1
            self.roi_selected = True
            self._reset_vals()
            return True
        if ch == "m":
            self.roi["w"] = max(1, self.roi["w"] - 1)
            self.roi_selected = True
            self._reset_vals()
            return True
        if ch == "?":
            self.roi["h"] += 1
            self.roi_selected = True
            return True
        if ch == "/":
            self.roi["h"] = max(1, self.roi["h"] - 1)
            self.roi_selected = True
            return True
        if ch in ("Z", "z"):
            if session.sink is not None and self.profile is not None:
                self.vibrindexi += 1
                name = f"vibrprof{self.vibrindexi:03d}"
                session.sink.save_data(name, self.profile)
                session.sink.save_image(name, render_vib_profile(self.profile))
                session._say(f"{name} saved.")
            return True
        return False

    # ------------------------------------------------------------------
    def on_bscan(self, session, result) -> None:
        if self.active_hold is None:
            return
        if self.maxvals[0] is None:
            self._reset_vals()
        k = self.active_hold - 1
        r = self.roi
        band = to_host(result.bscandb[r["y"]: r["y"] + r["h"]])   # the ROI's rows
        col = band[:, session.ascanat]
        block = band[:, r["x"]: r["x"] + r["w"]]
        colmax = block.max(axis=0)                  # reduce CV_REDUCE_MAX
        self.maxval[k] = max(self.maxval[k], float(col.max()))
        self.maxvals[k] = np.maximum(self.maxvals[k], colmax)
        self.frame_count += 1
        if self.frame_count < self.nframes:
            session._say(f"PkHold{self.nframes} {k+1} = {self.frame_count} fr")
            return

        # hold finished
        self.active_hold = None
        self.frame_count = 0
        session._say(f"PkHold{self.nframes} {k+1} = {self.maxval[k]:f} dB")
        lam = self.lambda0
        if k == 2:  # hold 3 done → displacement (BscanFFTpeak.cpp:591-645)
            db12 = self.maxval[0] - self.maxval[1]
            db13 = self.maxval[0] - self.maxval[2]
            self.dispnm = displacement_nm(db13, lam)
            self.errnm = errnull(db12) * lam * 1e9 / (4 * np.pi)
            self.profile = displacement_nm(self.maxvals[0] - self.maxvals[2], lam)
            self.profile3 = self.profile.copy()
            session._say(f"disp = {self.dispnm:3.2f} +- {self.errnm:1.2f} nm")
        elif k == 3:  # hold 4 done → bias-subtracted profile (649-734)
            db14 = self.maxval[0] - self.maxval[3]
            self.dispnm = displacement_nm(db14, lam)
            profile4 = displacement_nm(self.maxvals[0] - self.maxvals[3], lam)
            base = self.profile3 if self.profile3 is not None else self.profile
            self.profile = base - profile4
            session._say(f"disp = {self.dispnm:3.2f} nm (bias-subtracted)")
