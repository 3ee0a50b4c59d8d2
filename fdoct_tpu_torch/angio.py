"""Split-spectrum amplitude-decorrelation angiography (SSADA) of C-scan volumes.

Jia et al., "Split-spectrum amplitude-decorrelation angiography with optical
coherence tomography", Opt. Express 20(4):4710, 2012.  Each lateral position
is scanned N times; the k-linear spectrum is split into M Gaussian bands,
and for each voxel

    D = 1 − (1/(N−1))·(1/M)·Σₙ Σₘ Aₙ,ₘ·Aₙ₊₁,ₘ / (½Aₙ,ₘ² + ½Aₙ₊₁,ₘ²)

with Aₙ,ₘ the magnitude of repeat n in band m.  The structure is the
full-band magnitude averaged over the repeats.

Every band is linear in the apodization ratio, as M is, so one product of
the ratio rows with the stacked operator [M | M₁ … M_M]
(:func:`fdoct_tpu_torch.calibration.split_spectrum_operator`) gives every
magnitude.  At 'highest' on CUDA, on float32 ratios, one hand-written kernel
computes the product and its magnitudes
(:func:`fdoct_tpu_torch.ops.kernels.split_spectrum_mags`: 3xTF32 on the
tensor cores, float32-grade, no product written to device memory);
elsewhere the product runs under the precision policy of M's products
(``pipeline._op_matmul_pair``) and the magnitudes are formed in the real
part's memory.  Each term is computed as (Aₙ − Aₙ₊₁)² /
(Aₙ² + Aₙ₊₁²), the same quantity 1 − Aₙ·Aₙ₊₁/(½Aₙ² + ½Aₙ₊₁²) with no
cancellation; a term whose two magnitudes are both zero counts 0 (the
repeats agree).

Frames are position-major: frames r·N … r·N+N−1 are the repeats at
position r.  The volume's entry, on one card or on a mesh, is
:func:`fdoct_tpu_torch.parallel.sharded_angio_volume`; its volumes come out
(P, ndisp, H), as the C-scan volume's (F, ndisp, H).  The int8 precisions
have no band tables and are refused.

The spans ``angio.products`` (the split-spectrum products and their
magnitudes) and ``angio.decorrelation`` (structure and SSADA) and the
counters ``angio.product_bytes`` (the device bytes of the tensors the
product writes: re and im, or the kernel's magnitudes),
``angio.kernel_frames`` (the frames whose products the kernel computed, 0
on the other route) and ``angio.frames`` record while a profiler session
runs (:mod:`fdoct_tpu_torch.utils.profiling`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch

from fdoct_tpu_torch.calibration import split_spectrum_operator
from fdoct_tpu_torch.ops import normalize_minmax, to_db, to_uint8
from fdoct_tpu_torch.ops.kernels import pack_tf32_operator, split_spectrum_mags
from fdoct_tpu_torch.pipeline import _op_matmul_pair
from fdoct_tpu_torch.utils.profiling import count, span
from fdoct_tpu_torch.volume import enface_projection

#: the precisions the band products have no tables for
INT8_PRECISIONS = ("int8", "int8_direct")
#: each band's full width at half maximum, a share of the k-linear bins
BAND_WIDTH = 0.4
#: the angiogram view masks voxels whose structure is at most this share of
#: its B-scan's maximum (``doppler.octa_bscan``'s rule)
FLOOR_FRAC = 0.1


@dataclasses.dataclass(frozen=True)
class AngioConfig:
    """The angiography settings; the defaults are SSADA's (N = 2 repeats,
    M = 4 Gaussian bands centred at (m + ½)/M of the k-linear bins, each
    :data:`BAND_WIDTH` of the bins wide)."""

    repeats: int = 2
    bands: int = 4

    def centres(self) -> tuple[float, ...]:
        """The band centres, shares of the k-linear bins."""
        return tuple((m + 0.5) / self.bands for m in range(self.bands))

    def validate(self) -> "AngioConfig":
        if self.repeats < 2:
            raise ValueError(f"SSADA needs at least 2 repeats a position, got {self.repeats}")
        if self.bands < 1:
            raise ValueError(f"SSADA needs at least 1 band, got {self.bands}")
        return self

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "AngioConfig":
        """From a configuration file's ``angio`` object: ``repeats``,
        ``bands`` and, if given, ``method`` ``ssada`` and ``projection``
        ``max``; any other key is refused."""
        if d.get("method", "ssada") != "ssada":
            raise ValueError(f"unknown angiography method {d['method']!r}")
        if d.get("projection", "max") != "max":
            raise ValueError(f"the en-face angiogram is a maximum projection, not "
                             f"{d['projection']!r}")
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names - {"method", "projection"}
        if unknown:
            raise ValueError(f"unknown angiography settings {sorted(unknown)}")
        return cls(**{k: v for k, v in d.items() if k in names}).validate()


@dataclasses.dataclass(frozen=True)
class SplitSpectrumOperator:
    """[M | M₁ … M_B] on a device: (n_raw, (1 + B)·ndisp) in the working
    type, and rounded once to bfloat16 for the bf16 products; the operator
    pair ``pipeline._op_matmul_pair`` takes.  Columns b·ndisp … (b+1)·ndisp−1
    are band b, band 0 the full band M.  ``op_tf32`` is the float32
    operator as :func:`~fdoct_tpu_torch.ops.kernels.split_spectrum_mags`
    takes it (:func:`~fdoct_tpu_torch.ops.kernels.pack_tf32_operator`,
    (2, 2, (1 + B)·ndisp, n_raw), 105 MB at the OCTA-500 shape), None for
    another type.  It has no int8 tables (:func:`check_precision`)."""

    op_re: torch.Tensor
    op_im: torch.Tensor
    op_re_bf16: torch.Tensor
    op_im_bf16: torch.Tensor
    op_tf32: torch.Tensor | None = None
    op_re_q = None

    @classmethod
    def create(cls, cfg, acfg: AngioConfig,
               device: torch.device | str) -> "SplitSpectrumOperator":
        """Built on the host in float64, then cast to ``cfg.dtype`` on
        ``device``."""
        acfg.validate()
        nfft = cfg.numfftpoints
        op = split_spectrum_operator(cfg, [c * nfft for c in acfg.centres()],
                                     BAND_WIDTH * nfft)
        dtype = getattr(torch, cfg.dtype)
        op_re = torch.as_tensor(op.real).to(dtype).to(device)
        op_im = torch.as_tensor(op.imag).to(dtype).to(device)
        return cls(op_re=op_re, op_im=op_im,
                   op_re_bf16=op_re.to(torch.bfloat16), op_im_bf16=op_im.to(torch.bfloat16),
                   op_tf32=(pack_tf32_operator(op_re, op_im) if dtype == torch.float32
                            else None))


def check_precision(precision: str) -> None:
    if precision in INT8_PRECISIONS:
        raise ValueError(f"the angiography volume has no int8 band tables: matmul_precision "
                         f"{precision!r} is not supported; use 'highest' or 'default'")


def check_repeats(frames: int, repeats: int) -> None:
    if frames % repeats:
        raise ValueError(f"{frames} frames are not whole groups of {repeats} repeats: "
                         "a block must hold every repeat of its positions")


def ssada(mags: torch.Tensor, repeats: int, bands: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(structure, decorrelation), each (P, rows, ndisp), from the
    magnitudes (F, rows, (1 + B)·ndisp) of F = P·N position-major frames."""
    f, rows, cols = mags.shape
    m = mags.view(f // repeats, repeats, rows, 1 + bands, cols // (1 + bands))
    structure = m[:, :, :, 0].mean(dim=1)
    a = m[:, :, :, 1:]
    total = None
    for n in range(repeats - 1):
        x, y = a[:, n], a[:, n + 1]
        den = x * x + y * y
        term = torch.where(den > 0, (x - y).square_() / den, 0.0).sum(dim=2)
        total = term if total is None else total.add_(term)
    return structure, total.div_((repeats - 1) * bands)


def kernel_applies(yr: torch.Tensor, op: SplitSpectrumOperator, precision: str) -> bool:
    """Whether :func:`ratio_ssada` takes the magnitudes from
    :func:`~fdoct_tpu_torch.ops.kernels.split_spectrum_mags`: at 'highest'
    (a float32 operator), on CUDA, on a float32 ratio.  Everywhere else
    (the bf16 products of 'default', the CPU, float64) the product runs in
    ``pipeline._op_matmul_pair``."""
    return (precision == "highest" and yr.device.type == "cuda"
            and yr.dtype == torch.float32 and op.op_re.dtype == torch.float32)


def _band_mags(yr: torch.Tensor, op: SplitSpectrumOperator,
               precision: str) -> tuple[torch.Tensor, int, int]:
    """The magnitudes (F, rows, (1 + B)·ndisp) of the ratio stack's product
    with the stacked operator, the device bytes the product wrote and the
    frames the kernel computed: the kernel's where :func:`kernel_applies`,
    else the operator pair's, formed in the real part's memory."""
    if kernel_applies(yr, op, precision):
        mags = split_spectrum_mags(yr.contiguous(), op.op_re, op.op_im, op.op_tf32)
        return mags, mags.nbytes, yr.shape[0]
    re, im = _op_matmul_pair(yr, op, precision)
    return re.mul_(re).addcmul_(im, im).sqrt_(), re.nbytes + im.nbytes, 0


def ratio_ssada(yr: torch.Tensor, op: SplitSpectrumOperator, acfg: AngioConfig,
                precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(structure, decorrelation), each (P, rows, ndisp), of a ratio stack
    (F, rows, W): the magnitudes of one product with the stacked operator,
    then :func:`ssada`."""
    check_precision(precision)
    check_repeats(yr.shape[0], acfg.repeats)
    with span("angio.products"):
        mags, written, kernel_frames = _band_mags(yr, op, precision)
    count("angio.product_bytes", written)
    count("angio.kernel_frames", kernel_frames)
    with span("angio.decorrelation"):
        return ssada(mags, acfg.repeats, acfg.bands)


def angiogram(structure: torch.Tensor, decorr: torch.Tensor) -> torch.Tensor:
    """The decorrelation where the structure exceeds :data:`FLOOR_FRAC` of
    its B-scan's maximum, else 0; (P, ndisp, H) volumes."""
    peak = structure.amax(dim=(-2, -1), keepdim=True)
    return torch.where(structure > FLOOR_FRAC * peak, decorr, 0.0)


def angio_views(structure: torch.Tensor, decorr: torch.Tensor,
                compat: bool = True) -> dict[str, torch.Tensor]:
    """What ``cscan --angio`` shows of the volumes, each (P, H) uint8: the
    en-face angiogram (the masked decorrelation projected over depth, DC
    depths excluded, min-max scaled) and the structural dB MIP (as the
    C-scan's en-face MIP)."""
    ang = enface_projection(angiogram(structure, decorr), "max")
    db = to_db(structure + 1e-5, eps=0.0, compat=compat)
    return {"angio_enface": to_uint8(normalize_minmax(ang)),
            "structure_mip": to_uint8(normalize_minmax(enface_projection(db, "max")))}
