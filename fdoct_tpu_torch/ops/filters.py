"""Spatial preprocessing filters on tensors with any leading batch axes.

The reference's OpenCV preprocessing as in ``fdoct_tpu/ops/filters.py``:
medianBlur (BscanFFT.cpp:952-956), software binning by INTER_AREA resize
(958), the weighted moving average (smoothmovavg, 247-304) and the webcam
channel selection (BscanFFTwebcam.cpp:1015-1039).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def smooth_moving_average(x: torch.Tensor, n: int) -> torch.Tensor:
    """2n+1-point weighted moving average along the last axis:
    x'(p) = (x(p-n) + … + 2·x(p) + … + x(p+n)) / (2(n+1)), with each tap that
    falls off the edge replaced by x(p) (BscanFFT.cpp:247-304).  Computed as
    a padded cumulative-sum window plus (1 + #off-edge taps)·x(p)."""
    if n <= 0:
        return x
    L = x.shape[-1]
    cs = torch.cumsum(F.pad(x, (n + 1, n)), dim=-1)
    win_sum = cs[..., 2 * n + 1: 2 * n + 1 + L] - cs[..., :L]
    j = torch.arange(L, device=x.device)
    oob = (torch.clamp_min(n - j, 0) + torch.clamp_min(j + n - (L - 1), 0)).to(x.dtype)
    return (win_sum + (oob + 1.0) * x) / (2.0 * (n + 1))


def median_blur(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """ksize×ksize median over the last two axes with replicated borders
    (BscanFFT.cpp:952-956), as the middle of the sorted k² shifted planes."""
    if ksize <= 1:
        return img
    if ksize % 2 != 1:
        raise ValueError(f"median aperture must be odd, got {ksize}")
    r = ksize // 2
    h, w = img.shape[-2], img.shape[-1]
    rows = torch.arange(-r, h + r, device=img.device).clamp(0, h - 1)
    cols = torch.arange(-r, w + r, device=img.device).clamp(0, w - 1)
    padded = img.index_select(-2, rows).index_select(-1, cols)
    planes = [padded[..., dy:dy + h, dx:dx + w]
              for dy in range(ksize) for dx in range(ksize)]
    return torch.sort(torch.stack(planes), dim=0).values[ksize * ksize // 2]


def bin_area(img: torch.Tensor, bx: int, by: int | None = None) -> torch.Tensor:
    """Integer-factor binning = block mean over the last two axes (INTER_AREA
    resize, BscanFFT.cpp:958).  Integer input is averaged in float32 and
    rounded half to even back to its dtype, as the JAX package does."""
    by = bx if by is None else by
    if bx == 1 and by == 1:
        return img
    *lead, h, w = img.shape
    if h % by or w % bx:
        raise ValueError(f"frame {h}x{w} not divisible by bin {by}x{bx}")
    blocks = img.reshape(*lead, h // by, by, w // bx, bx)
    if img.dtype.is_floating_point:
        return blocks.mean(dim=(-3, -1))
    return torch.round(blocks.float().mean(dim=(-3, -1))).to(img.dtype)


def channel_select(frame: torch.Tensor, channelnum: int) -> torch.Tensor:
    """Webcam channel selection on RGB-order (…, h, w, 3) frames: 0/1/2 pick
    OpenCV's B/G/R plane (RGB channel 2 - c); 3 sums the channels scaled by
    1/(255·3) (BscanFFTwebcam.cpp:1015-1039).  2-D frames pass through."""
    if frame.ndim == 2:
        return frame
    if channelnum == 3:
        return frame.float().sum(dim=-1) / (255.0 * 3.0)
    return frame[..., 2 - channelnum]
