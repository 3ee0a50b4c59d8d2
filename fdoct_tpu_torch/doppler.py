"""Doppler / phase-resolved OCT.

The port of ``fdoct_tpu/doppler.py``.  No reference equivalent (the
reference discards phase at BscanFFT.cpp:1190); built on the fused path's
complex A-scans (:func:`fdoct_tpu_torch.pipeline.ascan_complex`).  Standard
phase-resolved processing: the frame-to-frame phase difference at each voxel
measures axial displacement Δz = Δφ·λ0/(4π·n_s) per inter-frame interval,
i.e. axial velocity.

The products run at ``precision`` (default 'default', as the JAX functions
call ``ascan_complex``): on CUDA that multiplies bf16-rounded operands, as
the JAX package's 'default' does on its accelerator, and float32 on the CPU;
'highest' multiplies in float32 on every device.  The phase error the bf16
operands give is measured on the card (``chip_smoke.py`` phase 15).  No
kernel runs here: the JAX functions reach no Pallas kernel either.
"""

from __future__ import annotations

import math

import torch

from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.pipeline import apodize_ratio, ascan_complex, preprocess


def phase_difference(z_prev: torch.Tensor, z_curr: torch.Tensor) -> torch.Tensor:
    """Wrapped per-voxel phase change Δφ ∈ (−π, π] between two complex
    A-scan fields (angle of the Kasai autocorrelation)."""
    return torch.angle(z_curr * torch.conj(z_prev))


def displacement_m(dphi, lambda0: float, ns: float = 1.0):
    """Δz = Δφ·λ0 / (4π·n_s) — double-pass axial displacement."""
    return dphi * lambda0 / (4 * math.pi * ns)


def speckle_variance(z: torch.Tensor) -> torch.Tensor:
    """Speckle-variance OCT-A: inter-frame variance (the population
    variance, as ``jnp.var``) of the A-scan magnitude at each voxel of a
    (T, H, ndisp) complex stack — high where scatterers decorrelate (flow),
    low in static tissue."""
    return torch.var(z.abs(), dim=0, correction=0)


def _complex_ascans(raw_frames: torch.Tensor, background: torch.Tensor,
                    pi_frame: torch.Tensor, calib: Calibration, cfg,
                    precision: str) -> torch.Tensor:
    """(T, H, ndisp) complex A-scans of a (T, H, W) frame sequence."""
    yr = apodize_ratio(preprocess(raw_frames, cfg), background, pi_frame, cfg)
    return ascan_complex(yr, calib, precision)


def octa_bscan(raw_frames: torch.Tensor, background: torch.Tensor,
               pi_frame: torch.Tensor, calib: Calibration, cfg,
               mag_floor_frac: float = 0.1, precision: str = "default"):
    """Angiography B-scan: (mean_mag (ndisp, H), normalized speckle-variance
    map (ndisp, H)) from a repeated-frame sequence."""
    z = _complex_ascans(raw_frames, background, pi_frame, calib, cfg, precision)
    mag = z.abs().mean(dim=0)
    sv = speckle_variance(z) / (mag**2 + 1e-20)   # contrast-normalized
    mask = mag > mag_floor_frac * mag.max()
    return mag.T, torch.where(mask, sv, 0.0).T


def doppler_bscan(raw_frames: torch.Tensor, background: torch.Tensor,
                  pi_frame: torch.Tensor, calib: Calibration, cfg,
                  ns: float = 1.0, mag_floor_frac: float = 0.1,
                  precision: str = "default"):
    """Doppler B-scan from a (T, H, W) frame sequence.

    Returns (mean_mag (ndisp, H), velocity_map (ndisp, H)) where the
    velocity map is the magnitude-weighted mean inter-frame displacement in
    meters per frame interval; voxels below ``mag_floor_frac`` of the peak
    magnitude are masked to 0 (phase is noise there).
    """
    z = _complex_ascans(raw_frames, background, pi_frame, calib, cfg, precision)
    # Kasai estimator: magnitude-weighted mean of z_t · conj(z_{t-1})
    corr = (z[1:] * torch.conj(z[:-1])).sum(dim=0)
    dphi = torch.angle(corr)
    # the displayed positive-depth peak is the conjugate fringe branch
    # under the ifft convention (see ops/dispersion.py note), so its phase
    # runs backwards; negate so positive velocity = increasing depth
    disp = -displacement_m(dphi, cfg.lambda0, ns)
    mag = z.abs().mean(dim=0)
    mask = mag > mag_floor_frac * mag.max()
    return mag.T, torch.where(mask, disp, 0.0).T    # (ndisp, H) layouts
