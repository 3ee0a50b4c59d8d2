"""C-scan volume analysis: en-face projections, surface topography,
per-A-scan peaks.

The reference never assembles volumes (it saves B-scan stacks for offline
MATLAB work); these are the standard volumetric views that workflow needs,
computed on the volume's device over (F, depth, lateral) tensors.

The port of ``fdoct_tpu/volume.py``.  Indices are int64 tensors; where
several depths tie, each picks the first, as ``jnp.argmax`` does
(``torch.argmax`` returns the first maximal index; a boolean mask is
compared as uint8, which ``torch.argmax`` takes).
"""

from __future__ import annotations

import torch


def ascan_peaks(bscan: torch.Tensor, dc_rows: int = 5) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-A-scan peak depth and value of a (depth, lateral) B-scan with
    the DC rows excluded (the display masks rows 0-4, BscanFFT.cpp:1239).

    Returns (depth_idx (lateral,), value (lateral,))."""
    body = bscan[..., dc_rows:, :]
    return torch.argmax(body, dim=-2) + dc_rows, torch.amax(body, dim=-2)


def enface_projection(volume: torch.Tensor, mode: str = "max",
                      depth_range: tuple[int, int] | None = None,
                      dc_rows: int = 5) -> torch.Tensor:
    """En-face view of a (F, depth, lateral) volume: reduce over depth.

    mode: 'max' (maximum-intensity projection), 'mean' (integrated), or
    'sum'.  ``depth_range`` restricts the slab; DC rows excluded by default.
    Returns (F, lateral)."""
    lo, hi = depth_range if depth_range is not None else (dc_rows, volume.shape[-2])
    slab = volume[..., lo:hi, :]
    if mode == "max":
        return torch.amax(slab, dim=-2)
    if mode == "mean":
        return torch.mean(slab, dim=-2)
    if mode == "sum":
        return torch.sum(slab, dim=-2)
    raise ValueError(f"unknown mode {mode!r}")


def surface_map(volume: torch.Tensor, threshold_frac: float = 0.5,
                dc_rows: int = 5) -> torch.Tensor:
    """Surface topography: per (frame, lateral) position, the first depth
    whose intensity exceeds ``threshold_frac`` of that A-scan's peak.
    Returns (F, lateral) depth indices."""
    body = volume[..., dc_rows:, :]
    peak = torch.amax(body, dim=-2, keepdim=True)
    above = (body >= threshold_frac * peak).to(torch.uint8)
    return torch.argmax(above, dim=-2) + dc_rows          # first True along depth
