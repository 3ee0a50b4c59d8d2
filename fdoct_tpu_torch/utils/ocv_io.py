"""Raw binary Mat interop (.ocv files).

The port's own copy of ``fdoct_tpu/utils/ocv_io.py`` (standard library and
numpy only), writing the same bytes.  Byte-compatible with the reference's
matwrite/matread serialization (BscanFFTspinjnt.cpp:576-620): a
little-endian int32 header (rows, cols, type, channels) followed by the raw
element data.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

# OpenCV primitive type codes (depth part of Mat::type())
_CV_TO_NP = {
    0: np.uint8,    # CV_8U
    1: np.int8,     # CV_8S
    2: np.uint16,   # CV_16U
    3: np.int16,    # CV_16S
    4: np.int32,    # CV_32S
    5: np.float32,  # CV_32F
    6: np.float64,  # CV_64F
}
_NP_TO_CV = {np.dtype(v): k for k, v in _CV_TO_NP.items()}


def _cv_maketype(depth: int, channels: int) -> int:
    return depth + ((channels - 1) << 3)


def matwrite(path: str | Path, arr: np.ndarray) -> None:
    """Write an array as a reference-compatible .ocv dump."""
    arr = np.ascontiguousarray(arr)
    if arr.ndim == 2:
        rows, cols, channels = arr.shape[0], arr.shape[1], 1
    elif arr.ndim == 3:
        rows, cols, channels = arr.shape
    else:
        raise ValueError("only 2D or 2D-multichannel arrays supported")
    depth = _NP_TO_CV[arr.dtype]
    header = struct.pack("<iiii", rows, cols, _cv_maketype(depth, channels), channels)
    Path(path).write_bytes(header + arr.tobytes())


def matread(path: str | Path) -> np.ndarray:
    """Read a reference .ocv dump back into a numpy array."""
    raw = Path(path).read_bytes()
    rows, cols, cvtype, channels = struct.unpack("<iiii", raw[:16])
    depth = cvtype & 7
    dtype = np.dtype(_CV_TO_NP[depth])
    data = np.frombuffer(raw[16:16 + rows * cols * channels * dtype.itemsize], dtype)
    shape = (rows, cols) if channels == 1 else (rows, cols, channels)
    return data.reshape(shape).copy()
