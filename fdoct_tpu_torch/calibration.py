"""λ→k calibration and the fused reconstruction operator, as tensors.

Everything between the apodization ratio ``yr = (y - y_p)/y_b`` and the
A-scan magnitudes (per-row DC removal, window, spectral zero-pad, k-linear
resampling, dispersion phase and the display-truncated inverse DFT) is linear
in ``yr``.  :meth:`Calibration.create` composes it into one complex matrix
M = op_re + i·op_im (n_raw × ndisp) on the host in numpy float64, exactly as
``fdoct_tpu/calibration.py`` does, and casts once to tensors on a device.
:func:`split_spectrum_operator` stacks M with the same chain under Gaussian
k-domain bands, for the angiography volume (:mod:`fdoct_tpu_torch.angio`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from fdoct_tpu_torch.ops import windows as _windows
from fdoct_tpu_torch.ops.kernels import pack_tf32_operator
from fdoct_tpu_torch.ops.resample import resample_matrix

_PI = np.pi


def _np_zeropad_rowwise(x: np.ndarray, mult: int, bandpassfilter: bool = False) -> np.ndarray:
    """Spectral zero-pad ×mult with the optional BscanDark band-pass, float64
    (BscanFFT.cpp:180-245 / BscanDark.cpp:169-254)."""
    if mult <= 1 and not bandpassfilter:
        return x
    n = x.shape[-1]
    spec = np.fft.fftshift(np.fft.fft(x, axis=-1) / n, axes=-1)
    if bandpassfilter:
        tenth = n // 10
        keep = np.zeros(n, bool)
        keep[n // 2 - tenth: n // 2 + tenth] = True
        keep[n // 2 - 3: n // 2 + 3] = False
        spec = np.where(keep, spec, 0.0)
    z = (n * mult - n) // 2
    if z:
        spec = np.pad(spec, [(0, 0)] * (x.ndim - 1) + [(z, z)])
    return np.fft.ifft(np.fft.ifftshift(spec, axes=-1), axis=-1).real * spec.shape[-1]


def reference_grids(cfg) -> dict[str, np.ndarray]:
    """The reference's λ→k precompute (BscanFFT.cpp:615-698), vectorized:
    lambdas and k (length opw·mult), klinear, nearest_idx and frac (length
    numfftpoints), diffk and deltak."""
    opw = cfg.opw
    mult = max(cfg.increasefftpointsmultiplier, 1)
    nfft = cfg.numfftpoints
    n_in = opw * mult

    deltalambda = (cfg.lambdamax - cfg.lambdamin) / opw   # BscanFFT.cpp:615
    i = np.arange(n_in, dtype=np.float64)
    lambdas = cfg.lambdamin + i * deltalambda / mult       # 638-643
    k = 2 * _PI / lambdas                                  # 644
    kmin = 2 * _PI / (cfg.lambdamax - deltalambda)         # 645
    kmax = 2 * _PI / cfg.lambdamin                         # 646
    deltak = (kmax - kmin) / nfft
    f = np.arange(nfft, dtype=np.float64)
    klinear = kmin + (f + 1) * deltak                      # 649-653

    diffk = np.empty(n_in)                                 # 663-671
    diffk[1:] = k[:-1] - k[1:]
    diffk[0] = diffk[1]

    # first i with k[i] < klinear[f] (first-match search, 673-690); k is
    # strictly decreasing, so this counts k[i] >= klinear[f]; unfound → 0
    nearest = np.searchsorted(-k, -klinear, side="right")
    nearest = np.where(nearest >= n_in, 0, nearest).astype(np.int32)

    frac = (klinear - k[nearest]) / diffk[nearest]         # 692-698
    return dict(lambdas=lambdas, k=k, klinear=klinear, diffk=diffk,
                nearest_idx=nearest, frac=frac, deltak=deltak)


def _linear_chain(cfg, g: Mapping[str, np.ndarray], win: np.ndarray, phase: np.ndarray,
                  kweights: np.ndarray | None = None) -> np.ndarray:
    """The operator(s) of the linear chain in float64, the identity pushed
    through it (calibration.py:150-181 of the JAX package): DC removal, the
    camera-side window ``win``, zero-pad, k-linear resample, then each row
    of the k-domain weights ``kweights`` ((bands, nfft), or None for none),
    the dispersion phase and the display-truncated inverse DFT.  Returns
    (n_raw, ndisp), or (bands, n_raw, ndisp) with weights, complex."""
    opw = cfg.opw
    mult = max(cfg.increasefftpointsmultiplier, 1)
    nfft = cfg.numfftpoints
    ndisp = min(cfg.numdisplaypoints, nfft)

    E = np.eye(opw)
    X = (E - E.mean(axis=-1, keepdims=True)) * win           # DC removal, window
    X = _np_zeropad_rowwise(X, mult, cfg.bandpassfilter)      # zero-pad ×mult
    X = X @ resample_matrix(g["nearest_idx"], g["frac"], opw * mult,
                            compat=cfg.compat)                # k-linear resample
    if kweights is not None:
        X = X * kweights[..., None, :]                        # k-domain weights
    # dispersion ⊙ unnormalized inverse DFT truncated to the displayed depths
    # (OpenCV DFT_INVERSE has no 1/N, BscanFFT.cpp:1185; colRange, 1195)
    F = np.exp((2j * _PI / nfft) * (np.arange(nfft)[:, None] * np.arange(ndisp)[None, :]))
    if phase.any():
        F = np.exp(1j * phase)[:, None] * F
    return X.astype(complex) @ F


def _fused_operator(cfg, g: Mapping[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Window, dispersion phase and M in float64: the chain of
    :func:`_linear_chain` with the configured window and no k-domain
    weights."""
    win = _windows.get_window(cfg.window, cfg.opw).astype(np.float64)
    if cfg.dispersion_a2 or cfg.dispersion_a3:
        kl = g["klinear"]
        x = (kl - (kl[0] + kl[-1]) / 2) / ((kl[-1] - kl[0]) / 2)
        phase = cfg.dispersion_a2 * x**2 + cfg.dispersion_a3 * x**3
    else:
        phase = np.zeros(cfg.numfftpoints)
    M = _linear_chain(cfg, g, win, phase)
    return dict(window=win, phase=phase, op_re=M.real, op_im=M.imag)


def gaussian_bands(nfft: int, centres, width: float) -> np.ndarray:
    """(bands, nfft) float64 Gaussian weights on the k-linear bins f = 0 …
    nfft−1: g(f) = exp(−4 ln 2 (f − c)² / w²) for each centre c (in bins),
    of full width at half maximum w (bins)."""
    f = np.arange(nfft, dtype=np.float64)
    c = np.asarray(centres, dtype=np.float64)[:, None]
    return np.exp(-4.0 * np.log(2.0) * (f - c) ** 2 / float(width) ** 2)


def split_spectrum_operator(cfg, centres, width: float) -> np.ndarray:
    """The split-spectrum operator [M | M₁ … M_B] in float64, (n_raw, (1 +
    B)·ndisp) complex: the full-band M (:func:`_fused_operator`'s) and, for
    each Gaussian band of :func:`gaussian_bands` (``centres`` and ``width``
    in k-linear bins), M's chain with no camera-side window and the band's
    weights on the k-linear grid after the resample (SSADA, Jia et al.,
    Opt. Express 20(4):4710, 2012)."""
    cfg.validate()
    g = reference_grids(cfg)
    full = _fused_operator(cfg, g)
    bands = _linear_chain(cfg, g, np.ones(cfg.opw), full["phase"],
                          gaussian_bands(cfg.numfftpoints, centres, width))
    M = full["op_re"] + 1j * full["op_im"]
    return np.concatenate([M, *bands], axis=-1)


def _quant_cols(A: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-column int8 quantization (int8 scales float32)."""
    s = np.abs(A).max(axis=0) / 127.0
    s = np.where(s == 0.0, 1.0, s)
    q = np.clip(np.rint(A / s), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Per-config reconstruction tables as tensors on one device.

    ``op_re``/``op_im`` are M in the working dtype; ``op_re_bf16`` and
    ``op_im_bf16`` are the same operator rounded once to bfloat16 for the
    bf16 matmul branch (pipeline.py:170-176 of the JAX package).  With
    ``matmul_precision='int8'`` only, ``op_re_q``/``op_im_q`` hold the
    float64 M quantized to int8 per output column and
    ``op_scale_re``/``op_scale_im`` their float32 scales
    (calibration.py:183-200 of the JAX package); otherwise they are None.
    ``op_tf32`` is the float32 M as the f32-operator kernels' wgmma schedule
    reads it (:func:`~fdoct_tpu_torch.ops.kernels.pack_tf32_operator`: its
    TF32 parts, K-major), built once here for a float32 M so that no group
    step packs it; None for any other type.  It is derived from ``op_re``
    and ``op_im``, and nothing saves it.
    """

    n_raw: int
    n_in: int
    nfft: int
    ndisp: int
    mult: int
    compat: bool
    bandpassfilter: bool
    has_phase: bool

    lambdas: torch.Tensor
    k: torch.Tensor
    klinear: torch.Tensor
    nearest_idx: torch.Tensor   # (nfft,) int64
    frac: torch.Tensor
    window: torch.Tensor        # (n_raw,)
    phase: torch.Tensor         # (nfft,) dispersion phase; zeros if unused
    op_re: torch.Tensor         # (n_raw, ndisp)
    op_im: torch.Tensor
    op_re_bf16: torch.Tensor
    op_im_bf16: torch.Tensor
    op_re_q: torch.Tensor | None = None      # (n_raw, ndisp) int8
    op_im_q: torch.Tensor | None = None
    op_scale_re: torch.Tensor | None = None  # (ndisp,) float32
    op_scale_im: torch.Tensor | None = None
    op_tf32: torch.Tensor | None = None      # (2, 2, ndisp, n_raw) float32

    @classmethod
    def create(cls, cfg, device: torch.device | str,
               dtype: torch.dtype | None = None) -> "Calibration":
        """Build every table on the host in float64, then cast to ``dtype``
        (default: ``cfg.dtype``) on ``device``."""
        cfg.validate()
        g = reference_grids(cfg)
        arrays = {name: g[name] for name in
                  ("lambdas", "k", "klinear", "nearest_idx", "frac")}
        arrays.update(_fused_operator(cfg, g))
        if cfg.matmul_precision == "int8":
            # from the float64 M; the tables cost device memory, so only
            # for the precision that reads them
            arrays["op_re_q"], arrays["op_scale_re"] = _quant_cols(arrays["op_re"])
            arrays["op_im_q"], arrays["op_scale_im"] = _quant_cols(arrays["op_im"])
        return cls.from_arrays(arrays, cfg, device, dtype)

    @classmethod
    def from_arrays(cls, arrays: Mapping[str, Any], cfg,
                    device: torch.device | str,
                    dtype: torch.dtype | None = None) -> "Calibration":
        """Tensors from host arrays named as the JAX ``Calibration``'s leaves
        (``op_re``, ``op_im``, ``window``, ``nearest_idx``, ``frac``,
        ``phase``, ``lambdas``, ``k``, ``klinear``, and optionally the int8
        tables ``op_re_q``, ``op_im_q``, ``op_scale_re``, ``op_scale_im``),
        so the JAX package and the port can run on the same M."""
        dtype = dtype or getattr(torch, cfg.dtype)
        device = torch.device(device)
        mult = max(cfg.increasefftpointsmultiplier, 1)

        def as_dev(name: str) -> torch.Tensor:
            return torch.as_tensor(np.array(arrays[name])).to(dtype).to(device)

        op_re, op_im = as_dev("op_re"), as_dev("op_im")
        phase = np.asarray(arrays["phase"])
        nearest = np.asarray(arrays["nearest_idx"]).astype(np.int64)
        if nearest.size and (nearest.min() < 0 or nearest.max() >= cfg.opw * mult):
            # the gather path's index_select raises (CPU) or faults (CUDA)
            # out of range, where jnp.take fills
            raise ValueError(f"nearest_idx outside [0, {cfg.opw * mult})")
        return cls(
            n_raw=cfg.opw, n_in=cfg.opw * mult,
            nfft=cfg.numfftpoints, ndisp=op_re.shape[1],
            mult=mult, compat=cfg.compat,
            bandpassfilter=cfg.bandpassfilter, has_phase=bool(phase.any()),
            lambdas=as_dev("lambdas"), k=as_dev("k"), klinear=as_dev("klinear"),
            nearest_idx=torch.as_tensor(nearest, device=device),
            frac=as_dev("frac"), window=as_dev("window"), phase=as_dev("phase"),
            op_re=op_re, op_im=op_im,
            op_re_bf16=op_re.to(torch.bfloat16), op_im_bf16=op_im.to(torch.bfloat16),
            op_tf32=(pack_tf32_operator(op_re, op_im) if dtype == torch.float32 else None),
            **{name: torch.as_tensor(np.array(arrays[name]), device=device)
               for name in ("op_re_q", "op_im_q", "op_scale_re", "op_scale_im")
               if arrays.get(name) is not None},
        )
