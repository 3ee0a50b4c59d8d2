"""Dispersion autofocus: sweep compensation coefficients over a volume.

No reference equivalent (its dispersion is balanced optically); this is the
numerical dispersion workflow of the volumetric config ("512-frame volume
assembly with dispersion sweep"): evaluate a grid of second/third-order
phase coefficients on sample A-scans, score each reconstruction with a
sharpness metric, and rebuild the fused operator with the winner.

The port of ``fdoct_tpu/autofocus.py``.  The k-linear spectra are computed
once; every candidate of a grid then runs in one batched IFFT over a
(grid, rows, n) tensor (:func:`fdoct_tpu_torch.ops.dispersion.
compensated_mags`), where the JAX package maps a trial with ``jax.vmap``.
A winner is the first maximum of the scores, the index ``jnp.argmax``
picks.
"""

from __future__ import annotations

import numpy as np
import torch

from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.ops.dispersion import compensated_mags, sharpness_metric
from fdoct_tpu_torch.pipeline import apodize_ratio, linearize, preprocess


def _grid(values, calib: Calibration) -> torch.Tensor:
    """A coefficient grid as a tensor on the calibration's device (float64
    from a list or numpy array, a tensor's own type otherwise)."""
    return torch.as_tensor(values, dtype=None if torch.is_tensor(values) else torch.float64,
                           device=calib.klinear.device)


def _sample_spectra(frames: torch.Tensor, background: torch.Tensor, pi_frame: torch.Tensor,
                    calib: Calibration, cfg, sample_rows: int) -> torch.Tensor:
    """The k-linear spectra of the first ``sample_rows`` rows of the first
    frame: preprocess, ratio, linearize."""
    f = frames.reshape(-1, frames.shape[-2], frames.shape[-1])
    yr = apodize_ratio(preprocess(f[0], cfg), background, pi_frame, cfg)
    return linearize(yr, calib)[:sample_rows]


def sweep_volume(frames: torch.Tensor, background: torch.Tensor, pi_frame: torch.Tensor,
                 calib: Calibration, cfg, a2_grid, sample_rows: int = 32
                 ) -> tuple[np.ndarray, float]:
    """Score each a2 candidate on a row subsample of the volume.

    The k-linear spectra are computed once (the expensive part); each
    candidate then costs one phase multiply + IFFT over the subsample.
    Returns (scores, best_a2)."""
    grid = _grid(a2_grid, calib)
    ylin = _sample_spectra(frames, background, pi_frame, calib, cfg, sample_rows)
    scores = sharpness_metric(compensated_mags(ylin, calib.klinear, grid, calib.ndisp),
                              grid_dims=1)
    return scores.cpu().numpy(), float(grid[torch.argmax(scores)])


def sweep_volume_2d(frames: torch.Tensor, background: torch.Tensor, pi_frame: torch.Tensor,
                    calib: Calibration, cfg, a2_grid, a3_grid, sample_rows: int = 32
                    ) -> tuple[np.ndarray, float, float]:
    """Joint (a2, a3) sweep: second- plus third-order compensation, all
    len(a2) × len(a3) candidates in one batched IFFT.

    Returns (scores[len(a2), len(a3)], best_a2, best_a3)."""
    a2, a3 = _grid(a2_grid, calib), _grid(a3_grid, calib)
    ylin = _sample_spectra(frames, background, pi_frame, calib, cfg, sample_rows)
    mags = compensated_mags(ylin, calib.klinear, a2[:, None], calib.ndisp, a3[None, :])
    scores = sharpness_metric(mags, grid_dims=2)
    i, j = np.unravel_index(int(torch.argmax(scores)), tuple(scores.shape))
    return scores.cpu().numpy(), float(a2[i]), float(a3[j])


def autofocused_calibration(cfg, best_a2: float, best_a3: float = 0.0,
                            device: torch.device | str = "cuda") -> Calibration:
    """Rebuild the fused operator on ``device`` with the winning
    coefficients folded in (one host-side rebuild; the per-frame cost is
    unchanged)."""
    return Calibration.create(cfg.replace(dispersion_a2=best_a2, dispersion_a3=best_a3), device)


def segmented_dispersion_mags(yr: torch.Tensor, calib: Calibration, a2_per_segment
                              ) -> torch.Tensor:
    """Depth-segmented dispersion compensation.

    Sample dispersion grows with depth (light traverses more material), so
    one global coefficient can only focus one depth; this reconstructs the
    k-linear spectrum once, applies each segment's phase, and stitches each
    segment's depth window from its own compensated IFFT.

    ``a2_per_segment`` (S,) splits the display depth range into S equal
    segments.  Returns (..., ndisp) magnitudes."""
    a2 = _grid(a2_per_segment, calib)
    S = a2.shape[0]
    seg_len = calib.ndisp // S
    if seg_len * S != calib.ndisp:
        raise ValueError(f"{S} segments do not divide ndisp = {calib.ndisp}")
    mags = compensated_mags(linearize(yr, calib), calib.klinear, a2, calib.ndisp)
    return torch.cat([mags[s][..., s * seg_len:(s + 1) * seg_len] for s in range(S)], dim=-1)


def sweep_per_segment(yr: torch.Tensor, calib: Calibration, a2_grid,
                      n_segments: int) -> torch.Tensor:
    """Per-segment coefficient sweep: for each depth segment, pick the a2
    maximizing that segment's sharpness.  Returns (n_segments,) best a2s."""
    grid = _grid(a2_grid, calib)
    seg_len = calib.ndisp // n_segments
    mag = compensated_mags(linearize(yr, calib), calib.klinear, grid, calib.ndisp)
    segs = mag.reshape(*mag.shape[:-1], n_segments, seg_len).movedim(-2, 1)  # (G, S, ..., seg)
    return grid[torch.argmax(sharpness_metric(segs, grid_dims=2), dim=0)]
