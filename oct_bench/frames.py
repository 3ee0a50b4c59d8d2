"""Seeded spectral-domain OCT frames, made on the device in a few large calls.

A frozen copy of the interferogram formula of
``fdoct_tpu_torch/sources/synthetic.py`` (``interferogram``, ``source_psd``:
the Wang & Wu model of the upstream's validation scripts): a Gaussian
source spectrum S(λ) over the configuration's λ range and point scatterers
at depths z_j with reflectivities r_j give

    I(λ) = S(λ) · | r_R + Σ_j r_j · exp(i·4π·z_j / λ) |²

with r_R = +1 for a sample frame, −1 for the π-shifted frame and no
scatterer for the background.  Unlike the program's ``SyntheticSource``,
every row of every frame draws its own depths and reflectivities and its
own camera noise, so that rows and frames differ.  Counts are quantized to
the configuration's ``bpp`` (uint8 or uint16).

The benchmark copies this file and not the program's source, so that the
inputs do not change when the program does.
"""

from __future__ import annotations

import numpy as np
import torch

#: scatterers per A-scan row
SCATTERERS = 3
#: reflectivity range of a scatterer
REFLECTIVITY = (0.05, 0.3)
#: camera read noise, as a share of the full scale
NOISE = 0.006
#: elements of one block of the generator's (frames, rows, scatterers, samples) phases
BLOCK_ELEMENTS = 1 << 26


def generator(seed: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed``; any whole number,
    taken modulo 2**63."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def full_scale(bpp: int) -> int:
    return (1 << min(int(bpp), 16)) - 1


def _dtype(bpp: int) -> torch.dtype:
    return torch.uint8 if bpp <= 8 else torch.uint16


def wavelengths(cfg, device: torch.device) -> torch.Tensor:
    """The camera's pixel wavelengths (BscanFFT.cpp:615-643 at multiplier 1)."""
    i = torch.arange(cfg.width, dtype=torch.float64, device=device)
    return cfg.lambdamin + i * (cfg.lambdamax - cfg.lambdamin) / cfg.width


def spectrum(lam: torch.Tensor, cfg) -> torch.Tensor:
    """S(λ): a Gaussian centred in the λ range, the range spanning ±2σ."""
    lam0 = (cfg.lambdamin + cfg.lambdamax) / 2
    sigma = (cfg.lambdamax - cfg.lambdamin) / 4
    return torch.exp(-0.5 * ((lam - lam0) / sigma) ** 2)


def depth_range(cfg) -> tuple[float, float]:
    """Scatterer depths (m): from 10 depth bins to 0.8 of the deepest bin
    both the display and the camera's sampling reach."""
    kspan = 2 * np.pi * (1 / cfg.lambdamin - 1 / cfg.lambdamax)
    per_bin = np.pi / kspan
    bins = min(cfg.numdisplaypoints, cfg.width // 2)
    return 10 * per_bin, 0.8 * bins * per_bin


def _quantize(intensity: torch.Tensor, noise: torch.Tensor, bpp: int) -> torch.Tensor:
    fs = full_scale(bpp)
    counts = torch.round((intensity + noise) * fs).clamp_(0, fs)
    # uint16 has no cast from float on every device: through int32
    return counts.to(torch.int32).to(_dtype(bpp))


def sample_frames(cfg, n: int, g: torch.Generator, device: torch.device,
                  r_ref: float = 1.0) -> torch.Tensor:
    """``n`` frames (n, height, width) of seeded scatterers, in blocks of
    frames so that the phases fit in memory."""
    lam = wavelengths(cfg, device).to(torch.float32)
    s = spectrum(lam, cfg).to(torch.float32)
    zlo, zhi = depth_range(cfg)
    peak = (abs(r_ref) + SCATTERERS * REFLECTIVITY[1]) ** 2
    h, w = cfg.height, cfg.width
    per_frame = h * SCATTERERS * w
    block = max(1, BLOCK_ELEMENTS // per_frame)
    out = torch.empty((n, h, w), dtype=_dtype(cfg.bpp), device=device)
    for a in range(0, n, block):
        b = min(n, a + block)
        shape = (b - a, h, SCATTERERS, 1)
        z = zlo + (zhi - zlo) * torch.rand(shape, generator=g, device=device)
        r = REFLECTIVITY[0] + (REFLECTIVITY[1] - REFLECTIVITY[0]) * torch.rand(
            shape, generator=g, device=device)
        phase = (4 * np.pi) * z / lam                        # (f, h, J, w)
        re = r_ref + (r * torch.cos(phase)).sum(2)
        im = (r * torch.sin(phase)).sum(2)
        intensity = s * (re * re + im * im) / peak * 0.9
        noise = NOISE * torch.randn((b - a, h, w), generator=g, device=device)
        out[a:b] = _quantize(intensity, noise, cfg.bpp)
    return out


def background_frames(cfg, n: int, g: torch.Generator, device: torch.device) -> torch.Tensor:
    """``n`` frames of the reference arm alone (the sample arm blocked), as
    an operator averages them into S(k) with the 'b' key."""
    lam = wavelengths(cfg, device).to(torch.float32)
    s = spectrum(lam, cfg).to(torch.float32) * 0.9 / (1 + SCATTERERS * REFLECTIVITY[1]) ** 2
    noise = NOISE * torch.randn((n, cfg.height, cfg.width), generator=g, device=device)
    return _quantize(s.expand(n, cfg.height, cfg.width), noise, cfg.bpp)
