"""Split-spectrum amplitude-decorrelation angiography (SSADA), step by step
in float64: the plain reference of the angiography volume.

Jia et al., "Split-spectrum amplitude-decorrelation angiography with optical
coherence tomography", Opt. Express 20(4):4710, 2012.  Each ratio row goes
through the upstream's steps of :mod:`oct_bench.reference.oct_ref`:

    ratio (raw − π)/S(k) → per-row DC removal
    → full band: × barthann, zero-pad, resample to k-linear (as oct_ref)
    → band m: zero-pad, resample to k-linear, × gₘ(f) = exp(−4 ln 2 (f − cₘ)² / w²),
      cₘ = (m + ½)/M and w = 0.4 of the nfft bins
    → unnormalized inverse FFT, first ndisp depths, |·|

then, for N repeats a position and M bands,

    structure = (1/N) Σₙ A_full,n
    D = 1 − (1/(N−1))·(1/M)·Σₙ Σₘ Aₙ,ₘ·Aₙ₊₁,ₘ / (½Aₙ,ₘ² + ½Aₙ₊₁,ₘ²)

where a term whose denominator is 0 (both magnitudes zero) counts 1: the
repeats agree.  It never composes an operator, so it shares no table with
the program, and it imports nothing of ``fdoct_tpu_torch``, ``fdoct_tpu`` or
``jax``.  Frames are position-major: frames r·N … r·N+N−1 are the repeats at
position r.  Everything runs in float64 (complex128 for the transforms) on
the inputs' device, in blocks of positions.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from oct_bench.reference.oct_ref import (
    F64, RefConfig, _minmax, _resample, _to_uint8, _zeropad, barthann, grids, ratio,
)

#: depth rows the en-face projections leave out (the display's DC rows)
DC_ROWS = 5
#: each band's full width at half maximum, a share of the k-linear bins
BAND_WIDTH = 0.4
#: the angiogram masks voxels whose structure is at most this share of its
#: B-scan's maximum
FLOOR_FRAC = 0.1


@dataclasses.dataclass(frozen=True)
class RefAngio:
    """The angiography fields the reference reads, from a configuration
    file's ``angio`` object: ``repeats`` and ``bands``, the bands centred at
    (m + ½)/M of the k-linear bins.  Another method than ``ssada``, another
    projection than ``max`` or any other key is refused."""

    repeats: int = 2
    bands: int = 4

    @classmethod
    def from_config(cls, angio: dict) -> "RefAngio":
        if angio.get("method", "ssada") != "ssada":
            raise ValueError(f"the reference implements SSADA only, not {angio['method']!r}")
        if angio.get("projection", "max") != "max":
            raise ValueError("the reference implements the maximum projection only")
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(angio) - names - {"method", "projection"}
        if unknown:
            raise ValueError(f"the reference has no angiography settings {sorted(unknown)}")
        return cls(**{k: v for k, v in angio.items() if k in names})

    def centres(self) -> list[float]:
        return [(m + 0.5) / self.bands for m in range(self.bands)]


def band_weights(cfg: RefConfig, angio: RefAngio, device) -> torch.Tensor:
    """(M, nfft) Gaussian weights on the k-linear bins f = 0 … nfft−1."""
    nfft = cfg.numfftpoints
    f = torch.arange(nfft, dtype=F64, device=device)
    rows = []
    w = BAND_WIDTH * nfft
    for c in angio.centres():
        rows.append(torch.exp(-4.0 * math.log(2.0) * (f - c * nfft) ** 2 / (w * w)))
    return torch.stack(rows)


def _mags(y: torch.Tensor, cfg: RefConfig) -> torch.Tensor:
    """|unnormalized inverse FFT| of k-linear rows, the first ndisp depths."""
    return (torch.fft.ifft(y, dim=-1)[..., :cfg.ndisp] * cfg.numfftpoints).abs()


def band_mags(rows: torch.Tensor, cfg: RefConfig, angio: RefAngio, g: dict,
              weights: torch.Tensor) -> torch.Tensor:
    """(R, 1 + M, ndisp) magnitudes of ratio rows (R, width): the full band,
    then each band."""
    y0 = rows.to(F64)
    y0 = y0 - y0.mean(dim=-1, keepdim=True)
    win = barthann(cfg.width, rows.device)
    full = _resample(_zeropad(y0 * win, cfg.mult), g, cfg.numfftpoints, cfg.compat)
    k = _resample(_zeropad(y0, cfg.mult), g, cfg.numfftpoints, cfg.compat)
    out = [_mags(full, cfg)]
    for w in weights:
        out.append(_mags(k * w, cfg))
    return torch.stack(out, dim=-2)


def ssada(a: torch.Tensor, angio: RefAngio) -> tuple[torch.Tensor, torch.Tensor]:
    """(structure, D) of magnitudes (P, N, rows, 1 + M, ndisp), each (P,
    rows, ndisp)."""
    n, m = angio.repeats, angio.bands
    structure = a[:, :, :, 0].sum(dim=1) / n
    total = torch.zeros_like(structure)
    for i in range(n - 1):
        x, y = a[:, i, :, 1:], a[:, i + 1, :, 1:]
        den = 0.5 * x * x + 0.5 * y * y
        r = torch.where(den > 0, x * y / torch.where(den > 0, den, 1.0), 1.0)
        total += r.sum(dim=-2)
    return structure, 1.0 - total / ((n - 1) * m)


def angio_volume(raw: torch.Tensor, background: torch.Tensor, pi_frame: torch.Tensor,
                 cfg: RefConfig, angio: RefAngio,
                 positions_per_block: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """(structure, D), each (P, ndisp, rows) float64, of raw position-major
    frames (P·N, rows, width)."""
    n = angio.repeats
    if raw.shape[0] % n:
        raise ValueError(f"{raw.shape[0]} frames are not whole groups of {n} repeats")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = grids(cfg, raw.device)
    weights = band_weights(cfg, angio, raw.device)
    p, rows = raw.shape[0] // n, raw.shape[1]
    shape = (p, cfg.ndisp, rows)
    structure = torch.empty(shape, dtype=F64, device=raw.device)
    decorr = torch.empty(shape, dtype=F64, device=raw.device)
    for a in range(0, p, positions_per_block):
        b = min(p, a + positions_per_block)
        r = ratio(raw[a * n:b * n], background, pi_frame)
        mags = band_mags(r.reshape(-1, cfg.width), cfg, angio, g, weights)
        s, d = ssada(mags.reshape(b - a, n, rows, 1 + angio.bands, cfg.ndisp), angio)
        structure[a:b] = s.transpose(-1, -2)
        decorr[a:b] = d.transpose(-1, -2)
    return structure, decorr


def mask(structure: torch.Tensor) -> torch.Tensor:
    """Voxels whose structure exceeds :data:`FLOOR_FRAC` of their B-scan's
    (position's) maximum, (P, ndisp, rows) bool."""
    peak = structure.flatten(1).amax(dim=1)[:, None, None]
    return structure > FLOOR_FRAC * peak


def angio_views(structure: torch.Tensor, decorr: torch.Tensor,
                compat: bool = True) -> dict[str, torch.Tensor]:
    """The en-face angiogram (D where :func:`mask` holds, else 0, its
    maximum over depth below the DC rows, min-max scaled to uint8) and the
    structural dB MIP (as the C-scan's), each (P, rows)."""
    ang = torch.where(mask(structure), decorr, 0.0)
    db = 20.0 * torch.log(structure + 1e-5) / (2.303 if compat else math.log(10.0))
    return {"angio_enface": _to_uint8(_minmax(ang[:, DC_ROWS:].amax(dim=1))),
            "structure_mip": _to_uint8(_minmax(db[:, DC_ROWS:].amax(dim=1)))}
