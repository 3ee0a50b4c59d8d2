"""The fused group-reconstruction kernels and their plain versions.

Hopper counterparts of the four Pallas kernels of ``fdoct_tpu/ops/pallas_kernels.py``:

- :func:`fused_recon_raw_accumulate`: Σ_b |((raw[b] − y_p)·(1/y_b)) @ M| from
  raw uint8 or uint16 frames, the ratio formed on the tile;
- :func:`fused_recon_accumulate`: Σ_b |yr[b] @ M| from a float32 ratio stack;
- :func:`fused_recon_resident`: the first with a bfloat16 operator (the TPU
  kernel keeps it resident in VMEM);
- :func:`int8_bscan_display_fused`: the int8-direct group step, s8 frames
  against a quantized operator with the display epilogue fused.

and, with no TPU counterpart (the JAX package leaves it to XLA),
:func:`split_spectrum_mags`: |yr @ (op_re + i·op_im)| of an angiography
volume's ratio rows against the wide split-spectrum operator, the
'highest' route of ``angio.ratio_ssada``.

The first three are ``csrc/fused_recon.cu``, the fourth is
``csrc/int8_bscan.cu``, the fifth ``csrc/angio_product.cu``;
:mod:`fdoct_tpu_torch.ops._build` builds them.  All
run on the tensor cores.  With a bfloat16 operator (the 'default'
precision on CUDA, and the resident kernel) the first three run one
warp-specialised schedule: a producer warpgroup brings every tile by TMA
into a ring of shared-memory stages, a third warpgroup forms the bf16
ratio once a stage into a shared-memory A tile and two consumer warpgroups
run ``wgmma`` (m64n128k16, one warpgroup a half of the depths) on it, each
round of
``ws::ROUND_STAGES`` stages into a fragment of its own that is added to the
float32 sums in round-to-nearest (the tensor cores truncate their sums).
With a float32 operator (the 'highest' precision) the
first two run the same shape of schedule as three TF32 products (3xTF32):
the consumers split the ratio into two TF32 parts in registers (wgmma's A
from registers), the operator comes already split and K-major (:func:`pack_tf32_operator`, built once per
``Calibration``), and each k8 step runs ``wgmma`` m64n128k8 tf32 three
times.  Where TMA cannot address the inputs both run the ``mma.sync``
schedule instead (:func:`bf16_schedule` and :func:`f32_schedule` mirror the
C rules); each pair of schedules computes the same sums bit for bit.  The
fourth runs the same shape of schedule on the s8 tensor cores (``wgmma``
m64n256k32 s8, frames and the packed operator both brought K-major by TMA),
or ``mma.sync`` s8 where TMA cannot address the frames (:func:`int8_schedule`),
every output bit for bit alike.  M = op_re + i·op_im is float32 or bfloat16;
with bfloat16 the ratio is rounded to bfloat16 before the product and the
sums stay float32; with float32 each operand is split into two TF32 parts
and the three largest cross products are summed in float32
(:func:`split_tf32`).  A wrapper given CPU tensors computes the plain
version beside it (``*_reference``); given CUDA tensors it launches the
kernel, or raises.  :data:`LAUNCHES` counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from fdoct_tpu_torch.ops import _build

#: kernel launches per wrapper since the last reset (CPU calls do not count)
LAUNCHES = {"fused_recon_raw_accumulate": 0, "fused_recon_accumulate": 0,
            "fused_recon_resident": 0, "int8_bscan_display_fused": 0,
            "split_spectrum_mags": 0}

#: tile (rows, depths) of the int8 kernel's min/max partials: one pair per
#: tile of db
INT8_TILE = (32, 32)

#: spectral samples per pipeline stage of the int8 kernel; the packed
#: operator's n_in is padded to a multiple of it
INT8_K_TILE = 64

#: one block of the bf16 instances' wgmma schedule: (row, frame) pairs x
#: depths (ws::BM, ws::BN of csrc/fused_recon.cu): the M of one wgmma by two
#: consumer warpgroups of 64 depths each (re and im make each N = 128)
WGMMA_TILE = (64, 128)

#: the edges of the tensor-core schedule (B, rows, n_in, ndisp), at which
#: the tests and chip_smoke.py hold every instance to its plain version: rows
#: not a multiple of a block's rows, n_in not a multiple of 16 (element
#: staging) or of a stage, ndisp not a multiple of 8, and 1 to 40 frames
EDGE_SHAPES = {"rows-ragged": (8, 70, 300, 100), "k-tail": (8, 37, 48, 80),
               "one-frame": (1, 65, 64, 64), "forty-frames": (40, 9, 96, 24),
               "three-frames": (3, 20, 100, 13), "two-frames": (2, 130, 512, 136)}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _magnitudes(yr: torch.Tensor, op_re: torch.Tensor, op_im: torch.Tensor) -> torch.Tensor:
    """|yr @ (op_re + i·op_im)| in torch ops.  A bfloat16 operator rounds yr
    to bfloat16 and multiplies in float32 (torch's bf16 @ bf16 would round
    the products' sums to bfloat16)."""
    if op_re.dtype == torch.bfloat16:
        yr = yr.to(torch.bfloat16).float()
        op_re, op_im = op_re.float(), op_im.float()
    re = torch.matmul(yr, op_re)
    im = torch.matmul(yr, op_im)
    return torch.sqrt(re * re + im * im)


def _magnitude_sum(yr: torch.Tensor, op_re: torch.Tensor,
                   op_im: torch.Tensor) -> torch.Tensor:
    """Σ_b |yr[b] @ (op_re + i·op_im)| in torch ops (:func:`_magnitudes`)."""
    return _magnitudes(yr, op_re, op_im).sum(dim=0)


def fused_recon_raw_accumulate_reference(raw, pi_frame, inv_background, op_re, op_im):
    """Plain version of :func:`fused_recon_raw_accumulate`."""
    yr = (raw.to(pi_frame.dtype) - pi_frame) * inv_background
    return _magnitude_sum(yr, op_re, op_im)


def fused_recon_accumulate_reference(yr, op_re, op_im):
    """Plain version of :func:`fused_recon_accumulate`."""
    return _magnitude_sum(yr, op_re, op_im)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The two TF32 parts (float32, low 13 mantissa bits zero) of a float32
    tensor, as the float32-operator kernels split each operand: hi rounds x
    to the nearest TF32 (ties away from zero), lo truncates the exact
    remainder x − hi, so |x − hi − lo| ≤ 2⁻²¹·|x|.  The kernels then sum
    lo_a·hi_b + hi_a·lo_b + hi_a·hi_b in float32 (3xTF32)."""
    if x.dtype != torch.float32:
        raise TypeError(f"split_tf32 takes float32, got {x.dtype}")
    mask = torch.tensor(-0x2000, dtype=torch.int32)          # 0xffffe000
    hi = ((x.view(torch.int32) + 0x1000) & mask).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & mask).view(torch.float32)
    return hi, lo


def pack_tf32_operator(op_re: torch.Tensor, op_im: torch.Tensor) -> torch.Tensor:
    """The float32 operator as the f32-operator kernels' wgmma schedule takes
    it: (2, 2, ndisp, n_in) float32, ``[0]`` the hi and ``[1]`` the lo
    :func:`split_tf32` part of ``(op_re.T, op_im.T)``, each depth's samples
    contiguous (wgmma takes tf32 operands K-major only).  Built once per
    ``Calibration`` (its ``op_tf32``); 16 MiB at the flagship's 2048 × 512."""
    if op_re.dtype != torch.float32 or op_im.dtype != torch.float32:
        raise TypeError(f"the TF32 table packs a float32 operator, got "
                        f"{op_re.dtype}/{op_im.dtype}")
    if op_re.shape != op_im.shape or op_re.ndim != 2:
        raise ValueError(f"operator shapes {tuple(op_re.shape)}/{tuple(op_im.shape)}")
    hi, lo = split_tf32(torch.stack((op_re.T, op_im.T)).contiguous())
    return torch.stack((hi, lo))


def _ratio_dtype(op_re: torch.Tensor) -> torch.dtype:
    """The float type the ratio is formed in for this operator."""
    return torch.float32 if op_re.dtype == torch.bfloat16 else op_re.dtype


def _check_operator(op_re: torch.Tensor, op_im: torch.Tensor, n_in: int,
                    device: torch.device) -> int:
    if op_re.shape != op_im.shape or op_re.ndim != 2 or op_re.shape[0] != n_in:
        raise ValueError(f"operator shapes {tuple(op_re.shape)}/{tuple(op_im.shape)} "
                         f"do not match n_in={n_in}")
    if op_re.dtype != op_im.dtype:
        raise TypeError(f"op_re is {op_re.dtype} but op_im is {op_im.dtype}")
    if op_re.device != device or op_im.device != device:
        raise ValueError(f"operator on {op_re.device}/{op_im.device}, input on {device}")
    if not (op_re.is_contiguous() and op_im.is_contiguous()):
        raise ValueError("operator must be contiguous")
    if device.type == "cuda" and op_re.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the CUDA kernel takes a float32 or bfloat16 operator, "
                        f"not {op_re.dtype}")
    return op_re.shape[1]


def _check_stack(x: torch.Tensor, name: str) -> tuple[int, int, int]:
    if x.ndim != 3 or 0 in x.shape:
        raise ValueError(f"{name} must be a non-empty (B, rows, n_in) stack, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} on {x.device}: only cpu and cuda are supported")
    return x.shape


def _check_ratio_terms(pi_frame: torch.Tensor, inv_background: torch.Tensor, rows: int,
                       n_in: int, device: torch.device, dtype: torch.dtype) -> None:
    for t, name in ((pi_frame, "pi_frame"), (inv_background, "inv_background")):
        if t.shape != (rows, n_in) or t.device != device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({rows}, {n_in}) tensor "
                             f"on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} is {t.dtype}; here it must be {dtype}")


def _check_tf32_table(op_tf32: torch.Tensor, op_re: torch.Tensor, n_in: int, ndisp: int,
                      device: torch.device) -> None:
    if op_re.dtype != torch.float32:
        raise TypeError(f"op_tf32 goes with a float32 operator, not {op_re.dtype}")
    shape = (2, 2, ndisp, n_in)
    if op_tf32.dtype != torch.float32:
        raise TypeError(f"op_tf32 must be float32, got {op_tf32.dtype}")
    if tuple(op_tf32.shape) != shape or op_tf32.device != device or not op_tf32.is_contiguous():
        raise ValueError(f"op_tf32 must be a contiguous {shape} tensor on {device}, got "
                         f"{tuple(op_tf32.shape)} on {op_tf32.device}")


def _operator_args(op_re: torch.Tensor, op_im: torch.Tensor,
                   op_tf32: torch.Tensor | None) -> list:
    """The operator arguments of a C entry: op_re, op_im and, with a float32
    operator, the TF32 table (packed here when the caller has none)."""
    if op_re.dtype == torch.bfloat16:
        return [op_re, op_im]
    return [op_re, op_im, pack_tf32_operator(op_re, op_im) if op_tf32 is None else op_tf32]


#: the C entry stem of kernel 1 for each frame type it takes
RAW_ENTRY = {torch.uint8: "fdoct_recon_raw_u8", torch.uint16: "fdoct_recon_raw_u16"}


def _launch(name: str, fn_stem: str, args: list, dims: tuple, op_re: torch.Tensor,
            out: torch.Tensor) -> torch.Tensor:
    lib = _build.load()
    suffix = "bf16" if op_re.dtype == torch.bfloat16 else "f32"
    fn = getattr(lib, f"{fn_stem}_{suffix}")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = fn(*(t.data_ptr() for t in args), out.data_ptr(), *dims, stream)
    if rc != 0:
        raise RuntimeError(f"{fn_stem}_{suffix} launch failed: cudaError {rc}")
    LAUNCHES[name] += 1
    return out


def fused_recon_raw_accumulate(raw: torch.Tensor, pi_frame: torch.Tensor,
                               inv_background: torch.Tensor, op_re: torch.Tensor,
                               op_im: torch.Tensor,
                               op_tf32: torch.Tensor | None = None) -> torch.Tensor:
    """Σ_b |((raw[b] − pi_frame)·inv_background) @ (op_re + i·op_im)|.

    raw: (B, rows, n_in) uint8 or uint16 (the TPU kernel's "raw uint8/uint16
    frames"); pi_frame, inv_background: (rows, n_in), float32 (float64 with
    a float64 operator, CPU only); op_re, op_im: (n_in, ndisp) float32 or
    bfloat16.  Returns (rows, ndisp).  Replaces the TPU kernel
    ``fused_recon_raw_accumulate`` (pallas_kernels.py:126-160).
    On CUDA a block holds all frames of its rows, forms their ratio on chip
    and stages pi_frame, inv_background and each operator tile once for all
    of them.  With a bfloat16 operator the warp-specialised schedule runs
    where TMA can address the inputs (:func:`bf16_schedule`): a producer
    warpgroup brings the tiles by TMA, another forms the bf16 ratio into
    shared memory and two consumer warpgroups run ``wgmma`` m64n128k16 on it
    (float32 sums, rounded to nearest every 128 samples); elsewhere ``mma.sync``
    m16n8k16, the same sums bit for bit.  With
    a float32 operator the products run on the TF32 tensor cores as three
    products of the operands' TF32 parts (float32 sums; see
    :func:`split_tf32`): the same warp-specialised schedule,
    ``wgmma`` m64n128k8 tf32, on ``op_tf32`` (:func:`pack_tf32_operator` of
    the operator: a ``Calibration``'s ``op_tf32``, or packed here per call
    when not given) where :func:`f32_schedule` says ``"wgmma"``, else
    ``mma.sync`` m16n8k8 on op_re and op_im, the same sums bit for bit.
    ``op_tf32`` is checked wherever it is given and read only on CUDA.
    What bounds either form is the consumers' forming of A beside the
    tensor cores (``csrc/fused_recon.cu``).
    """
    B, rows, n_in = _check_stack(raw, "raw")
    if raw.dtype not in RAW_ENTRY:
        raise TypeError(f"raw must be uint8 or uint16, got {raw.dtype}")
    ndisp = _check_operator(op_re, op_im, n_in, raw.device)
    _check_ratio_terms(pi_frame, inv_background, rows, n_in, raw.device, _ratio_dtype(op_re))
    if op_tf32 is not None:
        _check_tf32_table(op_tf32, op_re, n_in, ndisp, raw.device)
    if raw.device.type == "cpu":
        return fused_recon_raw_accumulate_reference(raw, pi_frame, inv_background,
                                                    op_re, op_im)
    out = torch.empty((rows, ndisp), dtype=torch.float32, device=raw.device)
    return _launch("fused_recon_raw_accumulate", RAW_ENTRY[raw.dtype],
                   [raw, pi_frame, inv_background, *_operator_args(op_re, op_im, op_tf32)],
                   (B, rows, n_in, ndisp), op_re, out)


def fused_recon_accumulate(yr: torch.Tensor, op_re: torch.Tensor, op_im: torch.Tensor,
                           op_tf32: torch.Tensor | None = None) -> torch.Tensor:
    """Σ_b |yr[b] @ (op_re + i·op_im)|.

    yr: (B, rows, n_in) float32 (float64 with a float64 operator, CPU only);
    op_re, op_im: (n_in, ndisp) float32 or bfloat16.  Returns (rows, ndisp).
    Replaces the TPU kernel ``fused_recon_accumulate``
    (pallas_kernels.py:275-308).  On CUDA it runs the schedules of
    :func:`fused_recon_raw_accumulate` with the ratio read instead of
    formed: rounded to bfloat16 for a bfloat16 operator (the
    warp-specialised ``wgmma`` schedule where TMA can address the stack,
    n_in % 4 == 0, else ``mma.sync``), split into TF32 parts for a float32
    one (the warp-specialised 3xTF32 schedule on ``op_tf32`` where
    :func:`f32_schedule` says ``"wgmma"``, else ``mma.sync``).
    """
    B, rows, n_in = _check_stack(yr, "yr")
    ndisp = _check_operator(op_re, op_im, n_in, yr.device)
    if yr.dtype != _ratio_dtype(op_re):
        raise TypeError(f"yr is {yr.dtype}; with a {op_re.dtype} operator it must "
                        f"be {_ratio_dtype(op_re)}")
    if op_tf32 is not None:
        _check_tf32_table(op_tf32, op_re, n_in, ndisp, yr.device)
    if yr.device.type == "cpu":
        return fused_recon_accumulate_reference(yr, op_re, op_im)
    out = torch.empty((rows, ndisp), dtype=torch.float32, device=yr.device)
    return _launch("fused_recon_accumulate", "fdoct_recon_yr_f32",
                   [yr, *_operator_args(op_re, op_im, op_tf32)], (B, rows, n_in, ndisp),
                   op_re, out)


def bf16_schedule(dtype: torch.dtype, n_in: int, ndisp: int, ptrs) -> str:
    """The schedule a bfloat16-operator instance runs for input rows of
    ``dtype`` (uint8 or uint16 frames, float32 ratio), as its C entry
    chooses it (``ws_applies`` of ``csrc/fused_recon.cu``) before the
    launch: ``"wgmma"`` (the warp-specialised TMA + ``wgmma`` schedule)
    where TMA can address every input, else ``"mma.sync"``.  TMA needs
    16-byte row strides, n_in % 16 (uint8), % 8 (uint16) or % 4 (float32)
    and ndisp % 8, and 16-byte aligned bases; ``ptrs`` are the data
    pointers of the inputs, the operator's among them.  The number of
    frames and rows enters neither rule: ragged rows and any number of
    frames run on both."""
    per_16 = {torch.uint8: 16, torch.uint16: 8, torch.float32: 4}[dtype]
    aligned = all(int(p) % 16 == 0 for p in ptrs)
    return "wgmma" if n_in % per_16 == 0 and ndisp % 8 == 0 and aligned else "mma.sync"


def f32_schedule(dtype: torch.dtype, n_in: int, ndisp: int, ptrs) -> str:
    """The schedule a float32-operator instance runs, as its C entry chooses
    it (``ws32_applies`` of ``csrc/fused_recon.cu``) before the launch:
    ``"wgmma"`` (the warp-specialised 3xTF32 schedule on the TF32 table)
    where TMA can address every input, else ``"mma.sync"``.  TMA needs
    16-byte row strides of the input rows, n_in % 16 (uint8), % 8 (uint16)
    or % 4 (float32), and of the K-major table, n_in % 4, and 16-byte
    aligned bases; ``ptrs`` are the data pointers of the input rows, the
    table and (raw frames) pi and inv_background.  The table's depths are
    its rows, so ndisp enters no rule (it is taken to match
    :func:`bf16_schedule`'s call)."""
    per_16 = {torch.uint8: 16, torch.uint16: 8, torch.float32: 4}[dtype]
    aligned = all(int(p) % 16 == 0 for p in ptrs)
    return "wgmma" if n_in % per_16 == 0 and n_in % 4 == 0 and aligned else "mma.sync"


def split_spectrum_mags_reference(yr, op_re, op_im):
    """Plain version of :func:`split_spectrum_mags`."""
    return _magnitudes(yr, op_re, op_im)


def split_spectrum_mags(yr: torch.Tensor, op_re: torch.Tensor, op_im: torch.Tensor,
                        op_tf32: torch.Tensor | None = None) -> torch.Tensor:
    """|yr @ (op_re + i·op_im)|, row by row.

    yr: (..., n_in) float32 ratio rows (float64 with a float64 operator, CPU
    only), contiguous; op_re, op_im: (n_in, ncols) float32.  Returns (...,
    ncols) float32.  Replaces no TPU kernel: the angiography volume's
    split-spectrum product (:mod:`fdoct_tpu_torch.angio`, every frame's rows
    against [M | M₁ … M_B], 3,200 columns at the OCTA-500 shape) and the
    magnitudes the volume keeps of it, which cuBLAS's two f32 products and
    their magnitude passes computed in 8.2 GB of intermediates.

    On CUDA the products run as three TF32 products on the tensor cores
    (float32 sums, each stage's added in round-to-nearest; see
    :func:`split_tf32`), from ``op_tf32`` (:func:`pack_tf32_operator` of the
    operator, a ``SplitSpectrumOperator``'s ``op_tf32``, or packed here per
    call when not given): a warp-specialised TMA + ``wgmma`` m64n128k8 tf32
    schedule of persistent blocks over tiles of 128 rows x 64 columns where
    :func:`f32_schedule` says ``"wgmma"``, else the ``mma.sync`` template of
    :func:`fused_recon_accumulate` at B = 1 on op_re and op_im; both give
    the sums of :func:`fused_recon_accumulate`'s f32 instances at B = 1, bit
    for bit (``csrc/angio_product.cu``).
    """
    if yr.ndim < 1 or yr.numel() == 0:
        raise ValueError(f"yr must be non-empty (..., n_in) rows, got {tuple(yr.shape)}")
    if not yr.is_contiguous():
        raise ValueError("yr must be contiguous")
    if yr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"yr on {yr.device}: only cpu and cuda are supported")
    n_in = yr.shape[-1]
    ncols = _check_operator(op_re, op_im, n_in, yr.device)
    if yr.dtype != op_re.dtype or op_re.dtype == torch.bfloat16:
        raise TypeError(f"yr is {yr.dtype} and the operator {op_re.dtype}; both must be "
                        "float32 (or float64 on the CPU)")
    if op_tf32 is not None:
        _check_tf32_table(op_tf32, op_re, n_in, ncols, yr.device)
    if yr.device.type == "cpu":
        return split_spectrum_mags_reference(yr, op_re, op_im)
    rows = yr.numel() // n_in
    mags = torch.empty((*yr.shape[:-1], ncols), dtype=torch.float32, device=yr.device)
    table = pack_tf32_operator(op_re, op_im) if op_tf32 is None else op_tf32
    with torch.cuda.device(yr.device):
        stream = torch.cuda.current_stream(yr.device).cuda_stream
        rc = _build.load().fdoct_split_spectrum_mags_f32(
            *(t.data_ptr() for t in (yr, op_re, op_im, table, mags)), rows, n_in, ncols, stream)
    if rc != 0:
        raise RuntimeError(f"fdoct_split_spectrum_mags_f32 launch failed: cudaError {rc}")
    LAUNCHES["split_spectrum_mags"] += 1
    return mags


def fused_recon_resident_reference(raw, pi_frame, inv_background, op_re, op_im):
    """Plain version of :func:`fused_recon_resident`: the raw-input plain
    version with the operator rounded to bfloat16."""
    return fused_recon_raw_accumulate_reference(raw, pi_frame, inv_background,
                                                op_re.to(torch.bfloat16),
                                                op_im.to(torch.bfloat16))


def fused_recon_resident(raw: torch.Tensor, pi_frame: torch.Tensor,
                         inv_background: torch.Tensor, op_re: torch.Tensor,
                         op_im: torch.Tensor) -> torch.Tensor:
    """Σ_b |bf16((raw[b] − pi_frame)·inv_background) @ bf16(op_re + i·op_im)|,
    float32 sums.

    raw: (B, rows, n_in) uint8; pi_frame, inv_background: (rows, n_in)
    float32; op_re, op_im: (n_in, ndisp), cast to bfloat16 whatever their
    type, as the TPU kernel casts them.  Returns (rows, ndisp) float32.
    Replaces the TPU kernel ``fused_recon_resident`` (pallas_kernels.py:90-123),
    whose operator stays in VMEM for the whole grid while each frame streams
    through once.  On CUDA its C entry runs kernel 1 u8's bf16 schedules (the
    warp-specialised TMA + ``wgmma`` one where :func:`bf16_schedule` says
    ``"wgmma"``, else ``mma.sync``): on Hopper the operator stays hot in the
    50 MB L2, and the same schedule serves both entries.
    """
    B, rows, n_in = _check_stack(raw, "raw")
    if raw.dtype != torch.uint8:
        raise TypeError(f"raw must be uint8, got {raw.dtype}")
    ndisp = _check_operator(op_re, op_im, n_in, raw.device)
    _check_ratio_terms(pi_frame, inv_background, rows, n_in, raw.device, torch.float32)
    op_re, op_im = op_re.to(torch.bfloat16), op_im.to(torch.bfloat16)
    if raw.device.type == "cpu":
        return fused_recon_resident_reference(raw, pi_frame, inv_background, op_re, op_im)
    out = torch.empty((rows, ndisp), dtype=torch.float32, device=raw.device)
    return _launch("fused_recon_resident", "fdoct_recon_resident_u8",
                   [raw, pi_frame, inv_background, op_re, op_im],
                   (B, rows, n_in, ndisp), op_re, out)


# --------------------------------------------------------------------------
# int8-direct: s8 frames against a quantized operator, display epilogue fused


def cuda_int_mm_takes(m: int, k: int, n: int, ptr_a: int, ptr_b: int) -> bool:
    """Whether ``torch._int_mm`` runs an (m, k) @ (k, n) product on CUDA.

    torch itself checks only m > 16 and k, n multiples of 8, and cuBLASLt
    then refuses some of those shapes (CUBLAS_STATUS_NOT_SUPPORTED on an
    H100 for (m, k, n) = (296, 48, 80) and (65, 64, 64), and for operands
    that are not 16-byte aligned).  Taken only where all three are
    multiples of 32 and both operands 16-byte aligned, as the flagship's
    (4096, 2048, 512) is."""
    return (m >= 32 and m % 32 == 0 and k % 32 == 0 and n % 32 == 0
            and ptr_a % 16 == 0 and ptr_b % 16 == 0)


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact s8 × s8 → s32 product of a (..., k) stack and a (k, n) matrix.

    ``torch._int_mm`` on a 2-D view where it takes the shapes (always on the
    CPU; on CUDA see :func:`cuda_int_mm_takes`); elsewhere the float64
    product, which is exact here (|sum| ≤ k·128·127 < 2^53), cast to int32."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError(f"int8_matmul takes int8 operands, got {a.dtype} and {b.dtype}")
    lead, k = a.shape[:-1], a.shape[-1]
    a2 = a.reshape(-1, k)
    n = b.shape[1]
    if a.device.type == "cpu" or cuda_int_mm_takes(a2.shape[0], k, n, a2.data_ptr(),
                                                   b.data_ptr()):
        out = torch._int_mm(a2, b)
    else:
        out = (a2.double() @ b.double()).to(torch.int32)
    return out.reshape(*lead, n)


def int8_schedule(n_in: int, ptrs) -> str:
    """The schedule :func:`int8_bscan_display_fused` runs, as its C entry
    ``fdoct_int8_bscan`` chooses it (``i8ws_applies`` of
    ``csrc/int8_bscan.cu``) before the launch: ``"wgmma"`` (the
    warp-specialised TMA + s8 ``wgmma`` schedule) where TMA can address the
    frames and the packed operator, else ``"mma.sync"``.  TMA needs 16-byte
    row strides of the frames, n_in % 16 (the packed operator's rows are a
    multiple of INT8_K_TILE long), and 16-byte aligned bases; ``ptrs`` are
    the data pointers of the frames and the packed operator.  The number of
    frames, rows and depths enters no rule."""
    aligned = all(int(p) % 16 == 0 for p in ptrs)
    return "wgmma" if n_in % 16 == 0 and aligned else "mma.sync"


class Int8BscanOutputs(NamedTuple):
    """What :func:`int8_bscan_display_fused` returns, all float32."""
    db: torch.Tensor              # (rows, ndisp) dB, DC columns masked, untransposed
    mn: torch.Tensor              # (row tiles, depth tiles) min of max(db, thresh)
    mx: torch.Tensor              # (row tiles, depth tiles) max of max(db, thresh)
    linear: torch.Tensor | None   # (rows, ndisp) sum/N + eps, when asked for


def pack_int8_operator(oq_re: torch.Tensor, oq_im: torch.Tensor,
                       k_tile: int = INT8_K_TILE) -> torch.Tensor:
    """The int8 operator K-major, as the s8 tensor cores take it:
    (2, ndisp, n_in_pad) int8, ``[0] = oq_re.T`` and ``[1] = oq_im.T``, each
    depth's samples contiguous, n_in zero-padded to a multiple of
    ``k_tile`` (zeros add nothing to an s32 sum).  Built once per plan."""
    if oq_re.dtype != torch.int8 or oq_im.dtype != torch.int8:
        raise TypeError(f"the int8 operator must be int8, got {oq_re.dtype}/{oq_im.dtype}")
    if oq_re.shape != oq_im.shape or oq_re.ndim != 2:
        raise ValueError(f"operator shapes {tuple(oq_re.shape)}/{tuple(oq_im.shape)}")
    n_in, ndisp = oq_re.shape
    packed = torch.zeros((2, ndisp, -(-n_in // k_tile) * k_tile), dtype=torch.int8,
                         device=oq_re.device)
    packed[0, :, :n_in] = oq_re.T
    packed[1, :, :n_in] = oq_im.T
    return packed


def _tile_minmax(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-INT8_TILE min and max of a (rows, ndisp) image; the padding of
    ragged edge tiles enters neither."""
    tm, tn = INT8_TILE
    rows, ndisp = x.shape
    pad = (0, -ndisp % tn, 0, -rows % tm)
    shape = ((rows + pad[3]) // tm, tm, (ndisp + pad[1]) // tn, tn)
    lo = torch.nn.functional.pad(x, pad, value=math.inf).reshape(shape).amin(dim=(1, 3))
    hi = torch.nn.functional.pad(x, pad, value=-math.inf).reshape(shape).amax(dim=(1, 3))
    return lo, hi


def int8_bscan_display_fused_reference(frames_s8, oq_re, oq_im, s_re, s_im, row_gain,
                                       const_re, const_im, thresh: float, averages: float,
                                       eps: float = 1e-5, denom: float = 2.303,
                                       with_linear: bool = False) -> Int8BscanOutputs:
    """Plain version of :func:`int8_bscan_display_fused`."""
    f32 = torch.float32
    re = (int8_matmul(frames_s8, oq_re).to(f32) * s_re) * row_gain + const_re
    im = (int8_matmul(frames_s8, oq_im).to(f32) * s_im) * row_gain + const_im
    lin = torch.sqrt(re * re + im * im).sum(dim=0) / averages + eps
    db = 20.0 * torch.log(lin) / denom
    depth = torch.arange(db.shape[-1], device=db.device)
    db = torch.where(depth < 2, db[:, 4:5], db)               # DC cols ← col 4
    mn, mx = _tile_minmax(torch.clamp_min(db, thresh))
    return Int8BscanOutputs(db, mn, mx, lin if with_linear else None)


def int8_bscan_display_fused(frames_s8: torch.Tensor, oq_re: torch.Tensor,
                             oq_im: torch.Tensor, s_re: torch.Tensor, s_im: torch.Tensor,
                             row_gain: torch.Tensor, const_re: torch.Tensor,
                             const_im: torch.Tensor, thresh: float, averages: float,
                             eps: float = 1e-5, denom: float = 2.303,
                             with_linear: bool = False,
                             oq_packed: torch.Tensor | None = None) -> Int8BscanOutputs:
    """One averaged int8-direct B-scan, display epilogue fused.

    frames_s8: (B, rows, n_in) int8 bias-shifted counts; oq_re, oq_im:
    (n_in, ndisp) int8, ndisp ≥ 5; s_re, s_im: (ndisp,) float32; row_gain:
    (rows, 1) float32; const_re, const_im: (rows, ndisp) float32; thresh,
    averages, eps, denom: numbers.  Per frame the s8 products are
    dequantised as (acc·s)·row_gain + const, their magnitudes summed over
    the group, then ÷averages, +eps, 20·ln(·)/denom, depth columns 0-1 ←
    column 4, and the per-tile min/max of max(db, thresh).  ``with_linear``
    also returns the linear sum/averages + eps.  Replaces the TPU kernel
    ``int8_bscan_display_fused`` (pallas_kernels.py:212-272).

    On CUDA the products run on the s8 tensor cores (exact s32 sums),
    which take the operator K-major: ``oq_packed`` is
    :func:`pack_int8_operator` of (oq_re, oq_im), packed here when not given
    (an ``Int8DirectPlan`` carries it).  Where :func:`int8_schedule` says
    ``"wgmma"`` (n_in % 16 == 0 and 16-byte aligned frames) a
    warp-specialised schedule runs: a producer warpgroup brings the frames
    and the packed operator by TMA, two consumer warpgroups run ``wgmma``
    m64n256k32 s8 on them as they lie in shared memory; elsewhere
    ``mma.sync`` m16n8k32.  Both give every output bit for bit alike.  The
    min/max partials are per INT8_TILE of db whatever the kernel's block.
    """
    B, rows, n_in = _check_stack(frames_s8, "frames_s8")
    if frames_s8.dtype != torch.int8:
        raise TypeError(f"frames_s8 must be int8, got {frames_s8.dtype}")
    dev = frames_s8.device
    if oq_re.shape != oq_im.shape or oq_re.ndim != 2 or oq_re.shape[0] != n_in:
        raise ValueError(f"operator shapes {tuple(oq_re.shape)}/{tuple(oq_im.shape)} "
                         f"do not match n_in={n_in}")
    ndisp = oq_re.shape[1]
    if ndisp < 5:
        raise ValueError(f"the DC mask copies depth column 4; ndisp={ndisp} < 5")
    expect = {"oq_re": (oq_re, torch.int8, (n_in, ndisp)),
              "oq_im": (oq_im, torch.int8, (n_in, ndisp)),
              "s_re": (s_re, torch.float32, (ndisp,)), "s_im": (s_im, torch.float32, (ndisp,)),
              "row_gain": (row_gain, torch.float32, (rows, 1)),
              "const_re": (const_re, torch.float32, (rows, ndisp)),
              "const_im": (const_im, torch.float32, (rows, ndisp))}
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != shape or t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} tensor on {dev}, "
                             f"got {tuple(t.shape)} on {t.device}")
    if oq_packed is not None:
        shape = (2, ndisp, -(-n_in // INT8_K_TILE) * INT8_K_TILE)
        if (oq_packed.dtype != torch.int8 or tuple(oq_packed.shape) != shape
                or oq_packed.device != dev or not oq_packed.is_contiguous()):
            raise ValueError(f"oq_packed must be a contiguous int8 {shape} tensor on {dev}, "
                             f"got {oq_packed.dtype} {tuple(oq_packed.shape)} on "
                             f"{oq_packed.device}")
    thresh, averages, eps, denom = (float(v) for v in (thresh, averages, eps, denom))
    if dev.type == "cpu":
        return int8_bscan_display_fused_reference(frames_s8, oq_re, oq_im, s_re, s_im,
                                                  row_gain, const_re, const_im, thresh,
                                                  averages, eps, denom, with_linear)
    if oq_packed is None:
        oq_packed = pack_int8_operator(oq_re, oq_im)
    if oq_packed.data_ptr() % 16:
        raise ValueError("oq_packed must be 16-byte aligned")
    tm, tn = INT8_TILE
    db = torch.empty((rows, ndisp), dtype=torch.float32, device=dev)
    lin = torch.empty_like(db) if with_linear else None
    # the kernel folds each warp's partials in with atomic min / max
    mn = torch.full((-(-rows // tm), -(-ndisp // tn)), math.inf, device=dev)
    mx = torch.full_like(mn, -math.inf)
    fn = _build.load().fdoct_int8_bscan
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(t.data_ptr() for t in (frames_s8, oq_packed, s_re, s_im, row_gain,
                                         const_re, const_im)),
                *(ctypes.c_float(v) for v in (thresh, averages, eps, denom)),
                db.data_ptr(), None if lin is None else lin.data_ptr(),
                mn.data_ptr(), mx.data_ptr(), B, rows, n_in, ndisp, oq_packed.shape[2],
                stream)
    if rc != 0:
        raise RuntimeError(f"fdoct_int8_bscan launch failed: cudaError {rc}")
    LAUNCHES["int8_bscan_display_fused"] += 1
    return Int8BscanOutputs(db, mn, mx, lin)
