"""Frame sources: any iterable of raw frames is one (the port of
``fdoct_tpu/sources/__init__.py``)."""

from __future__ import annotations

from typing import Iterator, Protocol, runtime_checkable

import numpy as np


@runtime_checkable
class FrameSource(Protocol):
    """A stream of raw interferogram frames (rows = lateral positions,
    cols = wavelength samples) plus the calibration frames the 'b' and 'p'
    captures of the 'sim' variant read (BscanFFTsim.cpp:806-825)."""

    def frames(self) -> Iterator[np.ndarray]:
        """Yield raw frames (uint8/uint16/float, (h, w))."""
        ...

    def background(self) -> np.ndarray:
        """Source-spectrum frame S(λ) (the 'b' key capture, BscanFFT.cpp:1000-1075)."""
        ...

    def pi_frame(self) -> np.ndarray:
        """π-shifted / J0 reference frame (the 'p' key capture, BscanFFT.cpp:1077-1099)."""
        ...


from fdoct_tpu_torch.sources.camera import CameraSource  # noqa: E402
from fdoct_tpu_torch.sources.replay import DirectorySource, ReplaySource  # noqa: E402
from fdoct_tpu_torch.sources.synthetic import SyntheticSource, staircase_phantom  # noqa: E402

__all__ = ["CameraSource", "DirectorySource", "FrameSource", "ReplaySource", "SyntheticSource",
           "staircase_phantom"]
