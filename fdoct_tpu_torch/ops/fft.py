"""Row-wise Fourier ops of the gather path: spectral zero-pad upsampling,
low-pass/band-pass filtering and the inverse-FFT magnitude core, on
``torch.fft`` (cuFFT on the card).

The port of ``fdoct_tpu/ops/fft.py`` (reference: zeropadrowwise,
BscanFFT.cpp:180-245, band-pass variant BscanDark.cpp:169-254; lpfilter,
BscanDark.cpp:119-167; the merge→dft(DFT_ROWS|DFT_INVERSE)→magnitude core,
BscanFFT.cpp:1181-1190), with OpenCV's scale conventions: the forward DFT
with DFT_SCALE divides by n, the inverse without it is unnormalized (×n
after ``torch.fft.ifft``).  The transforms run in complex64 for float32
rows and complex128 for float64 rows.  All functions work on the last axis
with any leading batch dims.
"""

from __future__ import annotations

import torch


def _complex(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def _fftshift(x: torch.Tensor) -> torch.Tensor:
    return torch.roll(x, x.shape[-1] // 2, dims=-1)


def _ifftshift(x: torch.Tensor) -> torch.Tensor:
    return torch.roll(x, -(x.shape[-1] // 2), dims=-1)


def _bandpass_blank(spec_shifted: torch.Tensor, blank_dc: int = 0) -> torch.Tensor:
    """Blank the outer 80 % of a centred (fftshifted) spectrum, keeping the
    centre ±floor(n/10) bins, and optionally ±blank_dc bins around DC
    (BscanDark.cpp:218-236 with dcvals=3; lpfilter 143-151 without)."""
    n = spec_shifted.shape[-1]
    tenth = n // 10
    idx = torch.arange(n, device=spec_shifted.device)
    keep = (idx >= n // 2 - tenth) & (idx < n // 2 + tenth)
    if blank_dc > 0:
        keep = keep & ~((idx >= n // 2 - blank_dc) & (idx < n // 2 + blank_dc))
    return torch.where(keep, spec_shifted, torch.zeros((), dtype=spec_shifted.dtype,
                                                       device=spec_shifted.device))


def zeropad_rowwise(x: torch.Tensor, mult: int, bandpassfilter: bool = False) -> torch.Tensor:
    """Sinc-interpolated row upsampling by Fourier zero-padding: fft/n →
    fftshift → [band-pass blank] → (N−n)/2 zeros each side → ifftshift →
    unnormalized inverse fft, real part; N = n·mult.  Amplitude-preserving."""
    if mult <= 1 and not bandpassfilter:
        return x
    n = x.shape[-1]
    spec = _fftshift(torch.fft.fft(x.to(_complex(x.dtype)), dim=-1) / n)
    if bandpassfilter:
        spec = _bandpass_blank(spec, blank_dc=3)
    z = (n * mult - n) // 2
    if z:
        spec = torch.nn.functional.pad(spec, (z, z))
    out = torch.fft.ifft(_ifftshift(spec), dim=-1).real * spec.shape[-1]
    return out.to(x.dtype)


def lowpass_rowwise(x: torch.Tensor) -> torch.Tensor:
    """FFT low-pass keeping the centred ±10 % of each row's spectrum
    (lpfilter, BscanDark.cpp:119-167)."""
    n = x.shape[-1]
    spec = torch.fft.fft(x.to(_complex(x.dtype)), dim=-1) / n
    spec = _bandpass_blank(_fftshift(spec))
    return (torch.fft.ifft(_ifftshift(spec), dim=-1).real * n).to(x.dtype)


def ifft_mag_rows(x: torch.Tensor, phase: torch.Tensor | None = None) -> torch.Tensor:
    """|IDFT(x)| per row with OpenCV's unnormalized inverse (n·|ifft|):
    the magnitude is cast to the input's type, then scaled by n, in the
    JAX package's order.  ``phase`` applies the dispersion factor exp(iφ(k))
    before the transform."""
    n = x.shape[-1]
    z = x.to(_complex(x.dtype))
    if phase is not None:
        z = z * torch.exp(1j * phase.to(z.dtype))
    return torch.fft.ifft(z, dim=-1).abs().to(x.dtype) * n
