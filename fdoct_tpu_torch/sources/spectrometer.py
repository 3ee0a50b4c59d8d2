"""Spectrometer-based acquisition: Ocean Optics ProcSpec ingestion and
per-pixel wavelength calibration.

The port of ``fdoct_tpu/sources/spectrometer.py``.  The reference's
spectrometer prototype reads 3648-px A-scans from Ocean Optics Spectra Suite
ProcSpec files — XML with ``<double>`` element lists for pixel data and
wavelength data (Matlab files/readpixeldata.m, readlambdadata.m; the batch
converter convertProcSpec.bat unzips the .ProcSpec container first) — and
reconstructs B-scans from saved A-scan sets with dark/ref/sample/J0/π frames
interpolated to a 3× linear-k grid (Matlab files/2018_09_10 cellotape
bscan/bscan.m).

The ingestion and :func:`calibration_from_lambdas` are numpy on the host;
:func:`reconstruct_spectrometer_ascans` runs the k-resampling and the
|IFFT| on a torch device.
"""

from __future__ import annotations

import re
import zipfile
from pathlib import Path

import numpy as np
import torch

from fdoct_tpu_torch.ops.fft import ifft_mag_rows
from fdoct_tpu_torch.ops.resample import resample_klinear
from fdoct_tpu_torch.ops.windows import get_window

_DOUBLE_RE = re.compile(r"<double>\s*([-+0-9.eE]+)\s*</double>")


def read_procspec_xml(path_or_text: str | Path) -> list[np.ndarray]:
    """Extract the ``<double>`` blocks of a ProcSpec XML.

    Returns consecutive runs of <double> values as separate arrays; for a
    standard ProcSpec dump the first block is pixel data and the second is
    the wavelength vector (readpixeldata.m line 9 / readlambdadata.m line
    3690 offsets).
    """
    text = path_or_text if isinstance(path_or_text, str) and "<" in path_or_text \
        else Path(path_or_text).read_text()
    blocks: list[list[float]] = []
    current: list[float] = []
    for line in text.splitlines():
        m = _DOUBLE_RE.search(line)
        if m:
            current.append(float(m.group(1)))
        elif current:
            blocks.append(current)
            current = []
    if current:
        blocks.append(current)
    return [np.asarray(b) for b in blocks]


def read_procspec(path: str | Path) -> tuple[np.ndarray, np.ndarray | None]:
    """Read pixel data (+ wavelength vector when present) from a ProcSpec
    container (.ProcSpec zip) or its extracted XML."""
    path = Path(path)
    if zipfile.is_zipfile(path):
        with zipfile.ZipFile(path) as z:
            xml_names = [n for n in z.namelist() if n.endswith(".xml")]
            text = z.read(xml_names[0]).decode(errors="replace")
        blocks = read_procspec_xml(text)
    else:
        blocks = read_procspec_xml(path)
    if not blocks:
        raise ValueError(f"no <double> data in {path}")
    pixels = blocks[0]
    lambdas = blocks[1] if len(blocks) > 1 else None
    return pixels, lambdas


def calibration_from_lambdas(lambdas_m: np.ndarray, nfft: int, ndisp: int,
                             window: str = "barthann", oversample: int = 1):
    """Resampling tables for a measured per-pixel λ vector.

    Unlike the ini-config path (a linspace λ assumption,
    BscanFFT.cpp:638-643), a real spectrometer supplies per-pixel
    wavelengths; this builds the uniform-k target grid directly from the
    measured k range (the approach of the cellotape bscan.m script:
    ``lineark = linspace(min(k), max(k), length(k)*3)``) with clean linear
    interpolation weights.  Returns dict with klinear, nearest_idx, frac,
    window.
    """
    lambdas_m = np.asarray(lambdas_m, np.float64)
    k = 2 * np.pi / lambdas_m
    ascending = k[0] < k[-1]
    ks = k if ascending else k[::-1]
    n = k.shape[0]
    klinear = np.linspace(ks[0], ks[-1], nfft * oversample)[:nfft]
    # nearest lower sample in the sorted-k frame
    idx_sorted = np.clip(np.searchsorted(ks, klinear, side="right") - 1,
                         0, n - 2)
    frac = (klinear - ks[idx_sorted]) / (ks[idx_sorted + 1] - ks[idx_sorted])
    if not ascending:
        # map back to original (descending-k) pixel order: interp between
        # original indices j = n-1-idx_sorted and j-1
        j = n - 1 - idx_sorted
        nearest = j
        frac_out = frac  # y(klin) = y[j] + frac*(y[j-1] - y[j])
    else:
        nearest = idx_sorted
        frac_out = -frac  # clean-mode convention: y[i] - frac*(y[i]-y[i-1])
    win = np.asarray(get_window(window, n)).astype(np.float64)
    return dict(klinear=klinear, nearest_idx=nearest.astype(np.int32),
                frac=frac_out, window=win, ndisp=ndisp, nfft=nfft)


def reconstruct_spectrometer_ascans(
    ascans: np.ndarray, lambdas_m: np.ndarray, nfft: int, ndisp: int,
    dark: np.ndarray | None = None, ref_arm: np.ndarray | None = None,
    sample_arm: np.ndarray | None = None, pi_frames: np.ndarray | None = None,
    window: str = "barthann", device: torch.device | str = "cuda",
    dtype: torch.dtype = torch.float32,
) -> np.ndarray:
    """Spectrometer A-scan stack → depth magnitudes, a numpy array (the
    bscan.m flow: dark subtraction, (i − π)/(ref+sample) apodization, DC
    removal and window in float64 on the host; interp to linear k and
    |IFFT| on ``device`` in ``dtype``).  ``dtype`` is the JAX function's
    default float type: float32, or float64 where JAX runs with x64."""
    tab = calibration_from_lambdas(lambdas_m, nfft, ndisp, window)
    a = np.atleast_2d(np.asarray(ascans, np.float64))
    if dark is not None:
        a = a - dark
    if pi_frames is not None:
        p = np.atleast_2d(np.asarray(pi_frames, np.float64))
        if dark is not None:
            p = p - dark
        a = a - p
    denom = None
    if ref_arm is not None or sample_arm is not None:
        denom = np.zeros_like(a[0])
        if ref_arm is not None:
            denom = denom + (ref_arm - (dark if dark is not None else 0))
        if sample_arm is not None:
            denom = denom + (sample_arm - (dark if dark is not None else 0))
        denom = np.where(denom == 0, 1.0, denom)
        a = a / denom
    a = a - a.mean(axis=-1, keepdims=True)
    a = a * tab["window"]
    ylin = resample_klinear(torch.as_tensor(a, dtype=dtype).to(device),
                            torch.as_tensor(tab["nearest_idx"], dtype=torch.long).to(device),
                            torch.as_tensor(tab["frac"], dtype=dtype).to(device), compat=False)
    return ifft_mag_rows(ylin)[:, :ndisp].cpu().numpy()
