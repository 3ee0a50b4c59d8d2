"""Grayscale/color PNG IO for frames and B-scans, on ``zlib`` and ``struct``.

The port's counterpart of ``fdoct_tpu/utils/imageio.py``, which reads and
writes through PIL; the port carries its own PNG codec instead, so that it
needs no imaging package.  The reference saves everything through
cv::imwrite (savematasimage, BscanFFT.cpp:307-327) and the batch path
writes 16-bit Trig PNGs (BscanFFTspinj.cpp:258-347).

- :func:`write_png` writes uint8 grey, uint16 grey (big-endian, as PNG
  stores it) and uint8 RGB, every row unfiltered, no interlace, at zlib
  level 1: the default of the reference's cv::imwrite
  (IMWRITE_PNG_COMPRESSION), and the level that
  keeps the per-group J-lockin saves of a live session cheap (a 512 × 512
  JET PNG takes ~7x longer at PIL's level 6).
- :func:`read_png` reads grey, RGB and RGBA at 8 and 16 bits, every row
  filter (None, Sub, Up, Average, Paeth), no interlace, and returns what the
  JAX package's PIL reader returns: grey stays 2-D (uint8 or uint16), colour
  becomes (h, w, 3) uint8 (16-bit colour keeps each sample's high byte, the
  alpha channel is dropped).  Palette, grey+alpha, sub-byte depths and
  Adam7 raise ``ValueError`` naming the file.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: zlib level of the written files (cv::imwrite's default; see the docstring)
_ZLIB_LEVEL = 1
#: PNG colour type → samples per pixel, for the types this codec reads
_CHANNELS = {0: 1, 2: 3, 6: 4}


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(arr: np.ndarray) -> bytes:
    """PNG bytes of a uint8 grey (h, w), uint16 grey (h, w) or uint8 RGB
    (h, w, 3) array, every row unfiltered (filter type 0)."""
    arr = np.asarray(arr)
    if arr.ndim == 2 and arr.dtype in (np.uint8, np.uint16):
        color, channels = 0, 1
    elif arr.ndim == 3 and arr.shape[-1] == 3 and arr.dtype == np.uint8:
        color, channels = 2, 3
    else:
        raise ValueError(f"cannot write a {arr.dtype} array of shape {arr.shape} as PNG")
    h, w = arr.shape[:2]
    depth = 8 * arr.dtype.itemsize
    rows = np.ascontiguousarray(arr.astype(">u2") if depth == 16 else arr)
    rows = rows.view(np.uint8).reshape(h, w * channels * arr.dtype.itemsize)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), _ZLIB_LEVEL)) + _chunk(b"IEND", b""))


def _unfilter(data: bytes, h: int, stride: int, bpp: int, path) -> np.ndarray:
    """Undo the per-row filters of decompressed image data → (h, stride)."""
    if len(data) < h * (stride + 1):
        raise ValueError(f"{path}: truncated PNG image data")
    src = np.frombuffer(data, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, cur = int(src[y, 0]), src[y, 1:]
        if ftype == 0:
            row = cur
        elif ftype == 1:
            # recon[x] = cur[x] + recon[x - bpp]: a running sum per byte lane
            lanes = np.zeros(-(-stride // bpp) * bpp, np.uint16)
            lanes[:stride] = cur
            row = (np.cumsum(lanes.reshape(-1, bpp), axis=0, dtype=np.uint64).ravel()[:stride]
                   & 0xFF).astype(np.uint8)
        elif ftype == 2:
            row = cur + prev                      # uint8 arithmetic wraps mod 256
        elif ftype in (3, 4):
            row = _unfilter_sequential(bytearray(cur.tobytes()), prev.tobytes(), bpp, ftype)
        else:
            raise ValueError(f"{path}: PNG filter type {ftype} is not 0-4")
        out[y] = row
        prev = out[y]
    return out


def _unfilter_sequential(cur: bytearray, prev: bytes, bpp: int, ftype: int) -> np.ndarray:
    """Average (3) and Paeth (4) rows: each byte depends on the byte
    reconstructed ``bpp`` before it, so the row is undone in order."""
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def decode_png(blob: bytes, path: str | Path = "<bytes>") -> np.ndarray:
    """Pixels of a PNG as (h, w) or (h, w, channels), uint8 or uint16, in the
    file's own channels (grey, RGB or RGBA)."""
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, ihdr, idat = 8, None, []
    while pos + 8 <= len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if ihdr is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, color, _, _, interlace = ihdr
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    if color not in _CHANNELS:
        kind = {3: "palette", 4: "grey+alpha"}.get(color, f"colour type {color}")
        raise ValueError(f"{path}: {kind} PNG is not supported (grey, RGB or RGBA only)")
    if depth not in (8, 16):
        raise ValueError(f"{path}: {depth}-bit PNG is not supported (8 or 16 bits only)")
    channels, nbytes = _CHANNELS[color], depth // 8
    stride = w * channels * nbytes
    rows = _unfilter(zlib.decompress(b"".join(idat)), h, stride, channels * nbytes, path)
    px = rows.view(">u2").astype(np.uint16) if depth == 16 else rows
    px = px.reshape(h, w, channels)
    return px[..., 0] if channels == 1 else px


def read_png(path: str | Path) -> np.ndarray:
    """Read a PNG as a numpy array; grayscale stays 2D (uint8/uint16),
    color becomes (h, w, 3) uint8."""
    px = decode_png(Path(path).read_bytes(), path)
    if px.ndim == 2:
        return px
    if px.dtype == np.uint16:
        px = (px >> 8).astype(np.uint8)           # PIL's RGB;16B keeps the high byte
    return np.ascontiguousarray(px[..., :3])


def read_png_gray(path: str | Path, channel: int = 0) -> np.ndarray:
    """Read a PNG and return one channel, the way the simulator does
    ``split(mraw, chan)`` and keeps chan[0] (BscanFFTsim.cpp:778-779)."""
    arr = read_png(path)
    if arr.ndim == 3:
        # RGB ordering here; OpenCV's chan[0] is Blue
        return arr[..., 2 - channel] if channel < 3 else arr.sum(-1)
    return arr


def write_png(path: str | Path, arr: np.ndarray) -> None:
    """Write uint8/uint16 grayscale or uint8 RGB PNG (any other 2-D type is
    cast to uint8, any other colour array to uint8 RGB, as the JAX package
    does)."""
    arr = np.asarray(arr)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if not (arr.ndim == 2 and arr.dtype == np.uint16):
        arr = arr.astype(np.uint8)
    path.write_bytes(encode_png(arr))
