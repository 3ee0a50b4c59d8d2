"""Textbook FD-OCT estimators from Wang & Wu Chapter 9 (wangOCT.m).

The port of ``fdoct_tpu/ops/wang.py``.  The reference's prototyping flow
compares four A-scan estimators on a simulated two-scatterer interferogram
(Matlab files/wangOCT.m:20-59): the raw interferogram, its plain IFT, the
IFT of the interferogram deconvolved by the source PSD S(k), and the IFT of
the deconvolved *differential* interferogram (the reference arm's phase
flipped by π cancels the DC and autocorrelation terms).  The estimators take
tensors, run ``torch.fft`` on their device in their type (complex64 for
float32, complex128 for float64) and are batched over leading axes (last
axis = the k samples); ``depth_axis`` and the fixture pair are numpy float64
on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def ift_reflectivity(I_k: torch.Tensor) -> torch.Tensor:
    """Relative reflectivity |IFT| of an interferogram, fftshifted so the
    depth axis runs symmetrically about zero (wangOCT.m:33:
    ``abs(fftshift(ifft(I_k1)))/sqrt(N)``)."""
    n = I_k.shape[-1]
    return torch.fft.fftshift(torch.fft.ifft(I_k, dim=-1), dim=-1).abs() / math.sqrt(n)


def deconvolved_ift(I_k: torch.Tensor, S_k: torch.Tensor) -> torch.Tensor:
    """IFT of the source-deconvolved interferogram (wangOCT.m:42:
    ``ifft(I_k1./S_k)``): dividing by the source PSD flattens the axial
    point-spread envelope at the cost of amplifying the spectral tails."""
    return ift_reflectivity(I_k / S_k)


def differential_deconvolved_ift(I_k1: torch.Tensor, I_k2: torch.Tensor,
                                 S_k: torch.Tensor) -> torch.Tensor:
    """IFT of the deconvolved differential interferogram
    (wangOCT.m:52-54): ``I_k2`` is acquired with the reference arm phase
    shifted by π, so the difference cancels the source DC term and the
    sample autocorrelation terms exactly, leaving only the cross terms —
    the textbook form of what the live pipeline's π-frame subtraction
    (``apodize_ratio``'s ``data_yp``) implements."""
    return ift_reflectivity((I_k1 - I_k2) / S_k)


def depth_axis(n: int, sigma_k: float, nsigma: float = 5.0,
               ns: float = 1.0) -> np.ndarray:
    """Depth sample positions (meters) for the fftshifted estimators
    (wangOCT.m:34-36): bin = 1/sampling-range of k/(2π), scaled by the
    round-trip 2·ns."""
    dls_prime = 1.0 / (2.0 * nsigma * sigma_k / (2.0 * np.pi))
    # fftshift bin order: offsets -(n//2) .. n-1-(n//2) for both parities
    return dls_prime * (np.arange(n) - n // 2) / (2.0 * ns)


def wang_interferogram_pair(depths_m=(90e-6, 150e-6),
                            reflectivities=(0.001, 0.0),
                            lambda0: float = 830e-9,
                            dlambda: float = 20e-9,
                            ns: float = 1.38, n: int = 1024,
                            nsigma: float = 5.0):
    """The Wang & Wu Ch. 9 simulated two-scatterer interferogram pair
    (wangOCT.m:4-24, 51-52): Gaussian source PSD over a symmetric k grid,
    sample field ``Σ r·exp(i·2·k·ns·ls)``, and the two quadrature
    interferograms ``S(k)·|±1 + E_s|²``.

    Returns ``(I_k1, I_k2, S_k, sigma_k)`` as float64 numpy arrays — the
    fixtures the four-panel comparison runs on.
    """
    k0 = 2.0 * np.pi / lambda0
    delta_k = 2.0 * np.pi * dlambda / lambda0 ** 2
    sigma_k = delta_k / np.sqrt(2.0 * np.log(2.0))
    k = k0 + sigma_k * np.linspace(-nsigma, nsigma, n)
    S_k = np.exp(-0.5 * (k - k0) ** 2 / sigma_k ** 2)
    E_s = sum(r * np.exp(1j * 2.0 * k * ns * ls)
              for ls, r in zip(depths_m, reflectivities))
    I_k1 = S_k * np.abs(1.0 + E_s) ** 2
    I_k2 = S_k * np.abs(-1.0 + E_s) ** 2
    return I_k1, I_k2, S_k, sigma_k
