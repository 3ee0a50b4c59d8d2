"""Tensor ops of the port, under the names ``fdoct_tpu/ops/__init__.py``
re-exports.  The hand-written kernels live in
:mod:`fdoct_tpu_torch.ops.kernels`; they build on first launch, never at
import.  The windows are numpy arrays: they enter the operator M on the host
(:meth:`fdoct_tpu_torch.calibration.Calibration.create`)."""

from fdoct_tpu_torch.ops.dispersion import apply_dispersion, dispersion_phase
from fdoct_tpu_torch.ops.fft import ifft_mag_rows, lowpass_rowwise, zeropad_rowwise
from fdoct_tpu_torch.ops.filters import (
    bin_area, bscan_rebin, channel_select, median_blur, resize_area, resize_bicubic,
    smooth_moving_average,
)
from fdoct_tpu_torch.ops.hilbert import analytic_signal, hilbert_reconstruct
from fdoct_tpu_torch.ops.resample import resample_klinear, resample_matrix
from fdoct_tpu_torch.ops.scale import (
    clamp_pixel, make_only_positive, mask_dc_rows, minmax_pair,
    normalize_minmax, normalize_rows, threshold_floor, to_db, to_uint8,
)
from fdoct_tpu_torch.ops.windows import (
    barthann, blackmanharris, gaussian, get_window, hamming, hann, tukey,
)

__all__ = [
    "analytic_signal", "apply_dispersion", "barthann", "bin_area", "blackmanharris",
    "bscan_rebin", "channel_select", "clamp_pixel", "dispersion_phase", "gaussian",
    "get_window", "hamming", "hann", "hilbert_reconstruct", "ifft_mag_rows", "lowpass_rowwise",
    "make_only_positive", "mask_dc_rows", "median_blur", "minmax_pair", "normalize_minmax",
    "normalize_rows", "resample_klinear", "resample_matrix", "resize_area", "resize_bicubic",
    "smooth_moving_average", "threshold_floor", "to_db", "to_uint8", "tukey", "zeropad_rowwise",
]
