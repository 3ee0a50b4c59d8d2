"""Dispersion-compensation phase correction.

The reference hardware setup compensates dispersion optically and has no
numerical dispersion correction; this op supplies the standard FD-OCT
numerical compensation (multiply the k-linear spectrum by exp(i·φ(k)) with a
polynomial phase) as a framework extension, plus an automatic coefficient
sweep that maximizes a B-scan sharpness metric — used by the volumetric
C-scan ("512-frame volume assembly with dispersion sweep").

The port of ``fdoct_tpu/ops/dispersion.py``.  Where the JAX package maps a
trial over a coefficient grid with ``jax.vmap``, a grid here is a leading
axis: :func:`compensated_mags` runs every candidate as one batched
``torch.fft.ifft`` over a (grid, rows, n) tensor.
"""

from __future__ import annotations

import torch


def _complex(dtype: torch.dtype) -> torch.dtype:
    return torch.complex128 if dtype in (torch.float64, torch.complex128) else torch.complex64


def dispersion_phase(klinear: torch.Tensor, a2: float | torch.Tensor,
                     a3: float | torch.Tensor = 0.0) -> torch.Tensor:
    """φ(k) = a2·(k-k̄)² + a3·(k-k̄)³ over the uniform k grid (normalized to
    the grid half-width so a2/a3 are O(1) radians at the band edge).  A
    tensor ``a2`` or ``a3`` of shape G gives (*G, nfft): each coefficient
    is broadcast against a trailing k axis."""
    kc = (klinear[0] + klinear[-1]) / 2
    half = (klinear[-1] - klinear[0]) / 2
    x = (klinear - kc) / half
    if torch.is_tensor(a2):
        a2 = a2[..., None]
    if torch.is_tensor(a3):
        a3 = a3[..., None]
    return a2 * x**2 + a3 * x**3


def apply_dispersion(spectrum: torch.Tensor, phase: torch.Tensor) -> torch.Tensor:
    """Multiply a k-linear (real or complex) spectrum by exp(i·φ(k))."""
    cdtype = _complex(spectrum.dtype)
    return spectrum.to(cdtype) * torch.exp(1j * phase.to(cdtype))


def compensated_mags(ylin: torch.Tensor, klinear: torch.Tensor, a2: float | torch.Tensor,
                     ndisp: int, a3: float | torch.Tensor = 0.0) -> torch.Tensor:
    """|IFFT(ylin · exp(i·φ))| truncated to ``ndisp`` depths and scaled by
    n (the unnormalized inverse DFT of the reference), for k-linear rows
    ``ylin`` (*R, n).  With coefficient tensors of broadcast shape G the
    result is (*G, *R, ndisp), every candidate in one batched IFFT."""
    phase = dispersion_phase(klinear, a2, a3)
    phase = phase.reshape(phase.shape[:-1] + (1,) * (ylin.ndim - 1) + phase.shape[-1:])
    n = ylin.shape[-1]
    return torch.fft.ifft(apply_dispersion(ylin, phase), dim=-1).abs()[..., :ndisp] * n


def sharpness_metric(mag: torch.Tensor, grid_dims: int = 0) -> torch.Tensor:
    """Normalized intensity-squared sharpness (higher = better focused).

    Standard autofocus metric for dispersion sweeps: Σ I² / (Σ I)² on the
    A-scan magnitudes, in float32.  The first ``grid_dims`` axes index
    candidates: one score each, the sums over the rest."""
    i = mag.to(torch.float32) ** 2
    dims = tuple(range(grid_dims, i.ndim))
    return torch.sum(i * i, dim=dims) / (torch.sum(i, dim=dims) ** 2 + 1e-30)


def dispersion_sweep(spectra: torch.Tensor, klinear: torch.Tensor,
                     a2_grid: torch.Tensor, ndisp: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Evaluate the sharpness metric over a grid of a2 coefficients.

    ``spectra``: (rows, nfft) k-linear spectra.  Returns (scores, best_a2):
    the first maximum's coefficient, as ``jnp.argmax`` picks it."""
    scores = sharpness_metric(compensated_mags(spectra, klinear, a2_grid, ndisp), grid_dims=1)
    return scores, a2_grid[torch.argmax(scores)]
