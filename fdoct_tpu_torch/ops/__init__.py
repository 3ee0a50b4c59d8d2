"""Tensor ops of the port.  The hand-written kernels live in
:mod:`fdoct_tpu_torch.ops.kernels`; they build on first launch, never at
import."""

from fdoct_tpu_torch.ops.filters import (
    bin_area, channel_select, median_blur, smooth_moving_average,
)
from fdoct_tpu_torch.ops.scale import (
    clamp_pixel, make_only_positive, mask_dc_rows, minmax_pair,
    normalize_minmax, normalize_rows, threshold_floor, to_db, to_uint8,
)

__all__ = [
    "bin_area", "channel_select", "clamp_pixel", "make_only_positive",
    "mask_dc_rows", "median_blur", "minmax_pair", "normalize_minmax",
    "normalize_rows", "smooth_moving_average", "threshold_floor", "to_db",
    "to_uint8",
]
