"""Minimal OpenCV FileStorage XML reader/writer.

The port's own copy of ``fdoct_tpu/utils/cvxml.py`` (standard library and
numpy only), writing the same bytes.  The reference's Windows builds persist
Mats via ``cv::FileStorage`` XML (savematasdata, BscanFFT.cpp:342-347); this
speaks enough of the opencv-matrix XML dialect to interoperate with those
files.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

_DT = {"u": np.uint8, "c": np.int8, "w": np.uint16, "s": np.int16,
       "i": np.int32, "f": np.float32, "d": np.float64}
_DT_INV = {np.dtype(v): k for k, v in _DT.items()}


def write_xml(path: str | Path, mats: dict[str, np.ndarray],
              scalars: dict[str, float | int] | None = None) -> None:
    """Write named matrices (and scalars) as an opencv_storage XML file."""
    out = ['<?xml version="1.0"?>', "<opencv_storage>"]
    for name, arr in mats.items():
        arr = np.asarray(arr)
        if arr.ndim == 1:
            arr = arr[None, :]
        dt = _DT_INV[arr.dtype]
        vals = " ".join(f"{float(v):.17g}" if arr.dtype.kind == "f" else str(int(v))
                        for v in arr.ravel())
        out.append(
            f'<{name} type_id="opencv-matrix">\n'
            f"  <rows>{arr.shape[0]}</rows>\n"
            f"  <cols>{arr.shape[1]}</cols>\n"
            f"  <dt>{dt}</dt>\n"
            f"  <data>\n    {vals}</data></{name}>"
        )
    for name, v in (scalars or {}).items():
        out.append(f"<{name}>{v}</{name}>")
    out.append("</opencv_storage>")
    Path(path).write_text("\n".join(out) + "\n")


_MAT_RE = re.compile(
    r"<(?P<name>\w+) type_id=\"opencv-matrix\">.*?"
    r"<rows>(?P<rows>\d+)</rows>.*?<cols>(?P<cols>\d+)</cols>.*?"
    r"<dt>(?P<dt>\w+)</dt>.*?<data>(?P<data>.*?)</data>",
    re.S,
)
_SCALAR_RE = re.compile(r"<(?P<name>\w+)>(?P<val>[-+0-9.eE]+)</(?P=name)>")


def read_xml(path: str | Path) -> tuple[dict[str, np.ndarray], dict[str, float]]:
    """Read an opencv_storage XML file → (matrices, scalars)."""
    text = Path(path).read_text()
    mats: dict[str, np.ndarray] = {}
    for m in _MAT_RE.finditer(text):
        dtype = _DT[m.group("dt")]
        data = np.array(m.group("data").split(), dtype=np.float64)
        arr = data.astype(dtype).reshape(int(m.group("rows")), int(m.group("cols")))
        mats[m.group("name")] = arr
    scalars = {}
    structural = {"rows", "cols", "dt"} | set(mats)
    for m in _SCALAR_RE.finditer(text):
        if m.group("name") not in structural:
            scalars[m.group("name")] = float(m.group("val"))
    return mats, scalars
