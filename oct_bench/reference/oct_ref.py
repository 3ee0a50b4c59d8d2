"""Frame → B-scan and C-scan volume, step by step in float64.

Written from the upstream's hot loop (hn-88/FDOCT, BscanFFT.cpp:946-1255),
one step at a time, as the upstream computes it:

    ratio (raw − π)/S(k)                       (1123-1132)
    → per-row DC removal, window               (1135-1141)
    → spectral zero-pad ×mult                  (zeropadrowwise, 180-245)
    → λ→k linear resampling                    (615-698, 1150-1177)
    → unnormalized inverse DFT, |·|, first numdisplaypoints depths
                                               (1181-1195)
    → Σ over the averaged frames, ÷N, +1e-5, dB with 2.303, DC depths
      masked, threshold floor, [clamp], min-max, uint8       (1211-1255)

The program composes the linear steps into one operator and multiplies;
this file never does, so the two share no code and no table.  It reads
only its own configuration fields (:class:`RefConfig`) and the inputs the
benchmark made.  Every step runs in float64 (complex128 for the
transforms) on whatever device its inputs are on.
"""

from __future__ import annotations

import dataclasses
import math

import torch

F64 = torch.float64
#: rows per block of the transforms (bounds the complex128 working set)
ROW_BLOCK = 1 << 14


@dataclasses.dataclass(frozen=True)
class RefConfig:
    """The configuration fields the reference reads, from a configuration
    file's ``pipeline`` object.  Steps it does not implement are refused."""

    width: int
    height: int
    averages: int
    numfftpoints: int
    numdisplaypoints: int
    lambdamin: float
    lambdamax: float
    increasefftpointsmultiplier: int = 1
    window: str = "barthann"
    compat: bool = True
    bscanthreshold: float = -30.0
    clampupper: bool = False
    clampupperdb: float = 50.0

    #: fields that must hold these values, or the reference lacks the step
    PLAIN = {"mediann": 0, "movavgn": 0, "binvalue": 1, "binvaluex": 1, "binvaluey": 1,
             "bscanbinx": 1, "bscanbiny": 1, "donotnormalize": True,
             "rowwisenormalize": False, "bandpassfilter": False, "dispersion_a2": 0.0,
             "dispersion_a3": 0.0, "dtype": "float32"}

    @classmethod
    def from_pipeline(cls, pipeline: dict) -> "RefConfig":
        for name, want in cls.PLAIN.items():
            if pipeline.get(name, want) != want:
                raise ValueError(f"the reference has no step for {name}={pipeline[name]!r}")
        if pipeline.get("window", "barthann") != "barthann":
            raise ValueError("the reference implements the barthann window only")
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in pipeline.items() if k in names})

    @property
    def mult(self) -> int:
        return max(int(self.increasefftpointsmultiplier), 1)

    @property
    def ndisp(self) -> int:
        return min(self.numdisplaypoints, self.numfftpoints)


def barthann(n: int, device) -> torch.Tensor:
    """w(p) = 0.62 − 0.48·|p/(N−1) − 0.5| + 0.38·cos(2π(p/(N−1) − 0.5))."""
    x = torch.arange(n, dtype=F64, device=device) / max(n - 1, 1) - 0.5
    return 0.62 - 0.48 * x.abs() + 0.38 * torch.cos(2 * math.pi * x)


def grids(cfg: RefConfig, device) -> dict[str, torch.Tensor]:
    """The upstream's λ→k tables (BscanFFT.cpp:615-698): for each k-linear
    sample q, the first camera sample i with k[i] < klinear[q] (0 where
    none is) and the fraction of the step to it."""
    opw, mult, nfft = cfg.width, cfg.mult, cfg.numfftpoints
    n_in = opw * mult
    dlam = (cfg.lambdamax - cfg.lambdamin) / opw
    lam = cfg.lambdamin + torch.arange(n_in, dtype=F64, device=device) * dlam / mult
    k = 2 * math.pi / lam
    kmin = 2 * math.pi / (cfg.lambdamax - dlam)
    kmax = 2 * math.pi / cfg.lambdamin
    dk = (kmax - kmin) / nfft
    klin = kmin + (torch.arange(nfft, dtype=F64, device=device) + 1) * dk
    diffk = torch.empty_like(k)
    diffk[1:] = k[:-1] - k[1:]
    diffk[0] = diffk[1]
    below = (k[None, :] < klin[:, None]).to(torch.uint8)
    nearest = torch.argmax(below, dim=1)              # first True; 0 where none
    frac = (klin - k[nearest]) / diffk[nearest]
    return {"nearest": nearest, "frac": frac}


def _zeropad(y: torch.Tensor, mult: int) -> torch.Tensor:
    """fft/n → fftshift → (N−n)/2 zeros on each side → ifftshift →
    unnormalized inverse, real part (zeropadrowwise)."""
    if mult <= 1:
        return y
    n = y.shape[-1]
    spec = torch.fft.fftshift(torch.fft.fft(y, dim=-1) / n, dim=-1)
    z = (n * mult - n) // 2
    spec = torch.nn.functional.pad(spec, (z, z))
    big = spec.shape[-1]
    return torch.fft.ifft(torch.fft.ifftshift(spec, dim=-1), dim=-1).real * big


def _resample(y: torch.Tensor, g: dict, nfft: int, compat: bool) -> torch.Tensor:
    """Linear interpolation onto the k-linear grid.  The upstream's form
    (compat): y[i] + frac[i]·(y[i] − y[i−1]) with i the nearest sample and
    frac read at index i, the slope at i = 0 that of i = 1, and samples 0
    and nfft−1 zero; otherwise y[i] − frac[q]·(y[i] − y[i−1])."""
    idx = g["nearest"]
    slope = torch.diff(y, dim=-1)
    slope = torch.cat([slope[..., :1], slope], dim=-1)
    yi, si = y[..., idx], slope[..., idx]
    if not compat:
        return yi - g["frac"] * si
    f = g["frac"][idx.clamp(0, nfft - 1)]
    out = yi + f * si
    out[..., 0] = 0.0
    out[..., nfft - 1] = 0.0
    return out


def ascan_mags(ratio: torch.Tensor, cfg: RefConfig, g: dict | None = None) -> torch.Tensor:
    """A-scan magnitudes (..., ndisp) of ratio rows (..., width), float64."""
    g = g if g is not None else grids(cfg, ratio.device)
    win = barthann(cfg.width, ratio.device)
    lead = ratio.shape[:-1]
    rows = ratio.reshape(-1, cfg.width).to(F64)
    out = torch.empty((rows.shape[0], cfg.ndisp), dtype=F64, device=ratio.device)
    for a in range(0, rows.shape[0], ROW_BLOCK):
        y = rows[a:a + ROW_BLOCK]
        y = (y - y.mean(dim=-1, keepdim=True)) * win
        y = _resample(_zeropad(y, cfg.mult), g, cfg.numfftpoints, cfg.compat)
        spec = torch.fft.ifft(y, dim=-1)[..., :cfg.ndisp] * cfg.numfftpoints
        out[a:a + ROW_BLOCK] = spec.abs()
    return out.reshape(*lead, cfg.ndisp)


def ratio(raw: torch.Tensor, background: torch.Tensor, pi_frame: torch.Tensor) -> torch.Tensor:
    return (raw.to(F64) - pi_frame.to(F64)) / background.to(F64)


def _minmax(x: torch.Tensor) -> torch.Tensor:
    lo, hi = x.min(), x.max()
    if hi == lo:
        return torch.zeros_like(x)
    return (x - lo) / (hi - lo)


def _to_uint8(x01: torch.Tensor) -> torch.Tensor:
    """round half to even of x·255, saturated (convertTo CV_8UC1, 255)."""
    return torch.clamp(torch.round(x01 * 255.0), 0, 255).to(torch.uint8)


def volume(raw: torch.Tensor, background: torch.Tensor, pi_frame: torch.Tensor,
           cfg: RefConfig, frames_per_block: int = 32) -> torch.Tensor:
    """The C-scan volume (F, ndisp, rows) of raw frames (F, rows, width)."""
    g = grids(cfg, raw.device)
    out = torch.empty((raw.shape[0], cfg.ndisp, raw.shape[1]), dtype=F64, device=raw.device)
    for a in range(0, raw.shape[0], frames_per_block):
        sl = slice(a, a + frames_per_block)
        out[sl] = ascan_mags(ratio(raw[sl], background, pi_frame), cfg, g).transpose(-1, -2)
    return out


def cscan_views(vol: torch.Tensor, compat: bool = True,
                dc_rows: int = 5) -> dict[str, torch.Tensor]:
    """What the C-scan command keeps of a volume (F, depth, rows): the dB
    volume's 8 sampled frames as uint8, the en-face maximum-intensity
    projection as uint8 and the surface map (per (frame, row), the first
    depth at or above half the A-scan's peak, DC depths excluded)."""
    vol = vol.to(F64)
    db = 20.0 * torch.log(vol + 1e-5) / (2.303 if compat else math.log(10.0))
    n = vol.shape[0]
    frames = torch.stack([_to_uint8(_minmax(db[i])) for i in range(0, n, max(1, n // 8))])
    mip = _to_uint8(_minmax(torch.amax(db[:, dc_rows:, :], dim=1)))
    body = vol[:, dc_rows:, :]
    above = (body >= 0.5 * torch.amax(body, dim=1, keepdim=True)).to(torch.uint8)
    surface = torch.argmax(above, dim=1) + dc_rows
    return {"frames": frames, "mip": mip, "surface": surface}
