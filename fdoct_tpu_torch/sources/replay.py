"""File-replay frame sources — the hardware-free twin of the live backends.

The port's own copy of ``fdoct_tpu/sources/replay.py``, reading PNGs with
the port's own codec (:mod:`fdoct_tpu_torch.utils.imageio`).
:class:`ReplaySource` mirrors BscanFFTsim.cpp: the same frame (``imgi.png``)
every iteration, ``backg.png`` as the background capture and ``piimgi.png``
as the π capture (BscanFFTsim.cpp:778-825).  :class:`DirectorySource`
replays the triggered-batch output of the spinj variants
(``Trig%03d-%03d.png`` / ``KTrig%03d-%03d.png``, BscanFFTspinj.cpp:258-450).
"""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path
from typing import Iterator

import numpy as np

from fdoct_tpu_torch.utils.imageio import read_png_gray


@dataclasses.dataclass
class ReplaySource:
    """Replay a single interferogram image forever (BscanFFTsim semantics)."""

    image: str | Path | np.ndarray
    background_image: str | Path | np.ndarray | None = None
    pi_image: str | Path | np.ndarray | None = None
    channel: int = 0

    def _load(self, x) -> np.ndarray:
        if isinstance(x, np.ndarray):
            return x
        return read_png_gray(x, self.channel)

    def frames(self) -> Iterator[np.ndarray]:
        frame = self._load(self.image)
        while True:
            yield frame

    def background(self) -> np.ndarray:
        if self.background_image is None:
            raise FileNotFoundError("no background image configured")
        return self._load(self.background_image)

    def pi_frame(self) -> np.ndarray:
        if self.pi_image is None:
            frame = self._load(self.image)
            return np.zeros_like(frame)
        return self._load(self.pi_image)


_TRIG_RE = re.compile(r"^(K?)Trig(\d+)-(\d+)\.png$")


@dataclasses.dataclass
class DirectorySource:
    """Replay a triggered-capture directory of Trig/KTrig PNGs.

    Files are grouped by capture index: ``Trig{set:03d}-{frame:03d}.png``
    are signal frames, ``KTrig...`` the alternating J0 frames
    (BscanFFTspinj.cpp:349-450).  Iterates signal frames in order; J0 sets
    are available via :meth:`j0_sets`.
    """

    directory: str | Path
    background_image: str | Path | np.ndarray | None = None
    pi_image: str | Path | np.ndarray | None = None

    def _scan(self) -> dict[bool, dict[int, list[Path]]]:
        groups: dict[bool, dict[int, list[Path]]] = {False: {}, True: {}}
        for p in sorted(Path(self.directory).iterdir()):
            m = _TRIG_RE.match(p.name)
            if m:
                is_k = bool(m.group(1))
                groups[is_k].setdefault(int(m.group(2)), []).append(p)
        return groups

    def sets(self, j0: bool = False) -> dict[int, list[Path]]:
        return self._scan()[j0]

    def frames(self) -> Iterator[np.ndarray]:
        for _, paths in sorted(self.sets(False).items()):
            for p in paths:
                yield read_png_gray(p)

    def j0_sets(self) -> Iterator[list[np.ndarray]]:
        for _, paths in sorted(self.sets(True).items()):
            yield [read_png_gray(p) for p in paths]

    def background(self) -> np.ndarray:
        if self.background_image is None:
            raise FileNotFoundError("no background image configured")
        if isinstance(self.background_image, np.ndarray):
            return self.background_image
        return read_png_gray(self.background_image)

    def pi_frame(self) -> np.ndarray:
        if self.pi_image is None:
            first = next(self.frames())
            return np.zeros_like(first)
        if isinstance(self.pi_image, np.ndarray):
            return self.pi_image
        return read_png_gray(self.pi_image)
