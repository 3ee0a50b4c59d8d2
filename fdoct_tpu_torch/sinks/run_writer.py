"""Run-directory writer: images, data dumps, parameter footer.

The port's own copy of ``fdoct_tpu/sinks/run_writer.py``, on the port's
config and utils; for the same inputs and ``timestamp`` it names the same
directory and writes the same ``.m``, ``.xml``, ``.npz`` and ``.ocv``
bytes (its PNGs hold the same pixels; the port's PNG codec compresses
differently from PIL).  Every ``save_*`` takes host numpy arrays: the
session moves tensors to the host, not the sink.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.utils.colormap import apply_jet
from fdoct_tpu_torch.utils.cvxml import write_xml
from fdoct_tpu_torch.utils.imageio import write_png
from fdoct_tpu_torch.utils.ocv_io import matwrite


def matlab_matrix(arr: np.ndarray) -> str:
    """Format a 2D array the way cv::Mat streams to text: ``[a, b;\\n c, d]``
    (the format the reference's .m dumps use, savematasdata
    BscanFFT.cpp:333-339) — valid MATLAB/Octave matrix syntax."""
    arr = np.atleast_2d(np.asarray(arr))
    rows = [", ".join(f"{v:.10g}" for v in row) for row in arr]
    return "[" + ";\n ".join(rows) + "]"


class RunWriter:
    """Owns one timestamped output directory and its data file.

    fmt='m'    — append MATLAB text (the reference's unix path)
    fmt='xml'  — OpenCV FileStorage XML (the reference's windows path)
    fmt='npz'  — native compressed archive
    """

    def __init__(self, base: str | Path = ".", descr: str = "fdoct",
                 fmt: str = "m", timestamp: float | None = None,
                 stem: str = "BscanFFT"):
        ts = time.localtime(timestamp if timestamp is not None else time.time())
        # reference: strftime("%Y-%m-%d_%H_%M_%S-") + dirdescr (BscanFFT.cpp:704-706)
        name = time.strftime("%Y-%m-%d_%H_%M_%S-", ts) + descr
        self.dir = Path(base) / name
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fmt = fmt
        self.stem = stem
        self._mats: dict[str, np.ndarray] = {}
        self._m_lines: list[str] = []
        self._footer: list[str] = []
        self._footer_scalars: dict[str, float] = {}

    # ------------------------------------------------------------------
    def save_image(self, name: str, arr: np.ndarray) -> Path:
        """PNG save (reference: savematasimage)."""
        p = self.dir / f"{name}.png"
        write_png(p, np.asarray(arr))
        return p

    def save_colormapped(self, name: str, gray_u8: np.ndarray) -> Path:
        """JET-colorized PNG (reference: applyColorMap + imwrite of
        ``bscanc%03d``)."""
        return self.save_image(name, apply_jet(gray_u8))

    def save_data(self, name: str, arr: np.ndarray) -> None:
        """Named matrix into the run's data file (reference: savematasdata)."""
        arr = np.asarray(arr)
        self._mats[name] = arr
        if self.fmt == "m":
            self._m_lines.append(f"{name}={matlab_matrix(arr)};")

    def save_bin(self, name: str, arr: np.ndarray) -> Path:
        """Raw .ocv dump (reference: savematasbin)."""
        p = self.dir / f"{name}.ocv"
        matwrite(p, np.asarray(arr))
        return p

    def parameter_footer(self, cfg: PipelineConfig,
                         bscanthreshold: float | None = None) -> None:
        """Run-parameter trailer (reference: BscanFFT.cpp:1929-1954 appends
        '% Parameters were - camgain, camtime, bpp, w, h, camspeed,
        usbtraffic, binvalue, bscanthreshold')."""
        th = cfg.bscanthreshold if bscanthreshold is None else bscanthreshold
        if not np.isfinite(th):
            th = -999.0  # sim variant disables the floor (-inf)
        self._footer = [
            "% Parameters were - camgain, camtime, bpp, w , h , camspeed, "
            "usbtraffic, binvalue, bscanthreshold",
            f"% {cfg.gain}, {cfg.exposure_us}, {cfg.bpp}, {cfg.width}, "
            f"{cfg.height}, {cfg.camspeed}, {cfg.usbtraffic}, {cfg.binvalue}, "
            f"{int(th)}",
        ]
        # the windows/XML build writes these as scalars (BscanFFT.cpp:1949)
        self._footer_scalars = {"camgain": cfg.gain,
                                "camtime": cfg.exposure_us,
                                "bscanthreshold": int(th)}

    def close(self) -> Path:
        """Flush the data file; returns its path."""
        if self.fmt == "m":
            p = self.dir / f"{self.stem}.m"
            p.write_text("\n".join(self._m_lines + self._footer) + "\n")
        elif self.fmt == "xml":
            p = self.dir / f"{self.stem}.xml"
            write_xml(p, self._mats, scalars=self._footer_scalars)
        elif self.fmt == "npz":
            p = self.dir / f"{self.stem}.npz"
            np.savez_compressed(p, **self._mats)
        else:
            raise ValueError(f"unknown fmt {self.fmt!r}")
        return p
