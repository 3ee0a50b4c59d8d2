"""J-threshold masking (the BscanFFTsim variant's lock-in display).

The port's own copy of ``fdoct_tpu/plugins/jmask.py``; it reads only
``result.bscandisp``, which is a host array.

reference: BscanFFTsim.cpp:959-975 — after a 'j' capture stores the current
display image (×255) as ``jscansave``, each displayed B-scan is masked:
``mask = threshold(max(bscandisp·255 - jscansave, 0) > 5)`` and the display
is ``bscandisp & mask`` — leaving only pixels that brightened by more than
5/255 relative to the J0 capture.
"""

from __future__ import annotations

import numpy as np


class JMaskPlugin:
    def __init__(self):
        self.jscansave: np.ndarray | None = None
        self.active = False

    def key(self, session, ch: str) -> bool:
        # 'j'/'c' are captured at the session level for the lock-in flow;
        # in sim variant we piggyback on the same pending flags via on_bscan.
        return False

    def on_bscan(self, session, result) -> None:
        # capture requested this group? (session handles 'j' by setting
        # jlockin; sim semantics store the *display* image instead)
        if session.jlockin and self.jscansave is None:
            self.jscansave = result.bscandisp.astype(np.float64)
            self.active = True
        if not session.jlockin:
            self.jscansave = None
            self.active = False
            return
        if self.active and self.jscansave is not None:
            diff = result.bscandisp.astype(np.float64) - self.jscansave
            positive = np.maximum(diff, 0).astype(np.uint8)
            mask = np.where(positive > 5, 255, 0).astype(np.uint8)
            result.sub_disp = result.bscandisp & mask
