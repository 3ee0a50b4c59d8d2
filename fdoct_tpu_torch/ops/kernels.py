"""The fused group-reconstruction kernels and their plain versions.

Hopper counterparts of the four Pallas kernels of ``fdoct_tpu/ops/pallas_kernels.py``:

- :func:`fused_recon_raw_accumulate`: Σ_b |((raw[b] − y_p)·(1/y_b)) @ M| from
  raw uint8 frames, the ratio formed on the tile;
- :func:`fused_recon_accumulate`: Σ_b |yr[b] @ M| from a float32 ratio stack;
- :func:`fused_recon_resident`: the first with a bfloat16 operator, in the
  schedule that reads each frame byte from device memory once;
- :func:`int8_bscan_display_fused`: the int8-direct group step, s8 frames
  against a quantized operator with the display epilogue fused.

The first three are ``csrc/fused_recon.cu``, the fourth is
``csrc/int8_bscan.cu``; :mod:`fdoct_tpu_torch.ops._build` builds both.  All
run on the tensor cores: the first two and the fourth on ``mma.sync`` (bf16
with a bfloat16 operator, three TF32 products (3xTF32) with a float32 one,
s8 for the fourth), the resident kernel on ``wgmma`` fed by TMA
(:func:`resident_schedule`).
M = op_re + i·op_im is float32 or bfloat16; with bfloat16 the ratio is
rounded to bfloat16 before the product and the sums stay float32; with
float32 each operand is split into two TF32 parts and the three largest
cross products are summed in float32 (:func:`split_tf32`).  A wrapper
given CPU tensors computes the plain version beside it (``*_reference``);
given CUDA tensors it launches the kernel, or raises.  :data:`LAUNCHES`
counts kernel launches, and only those.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from fdoct_tpu_torch.ops import _build

#: kernel launches per wrapper since the last reset (CPU calls do not count)
LAUNCHES = {"fused_recon_raw_accumulate": 0, "fused_recon_accumulate": 0,
            "fused_recon_resident": 0, "int8_bscan_display_fused": 0}

#: tile (rows, depths) of the int8 kernel's min/max partials: one pair per
#: tile of db
INT8_TILE = (32, 32)

#: spectral samples per pipeline stage of the int8 kernel; the packed
#: operator's n_in is padded to a multiple of it
INT8_K_TILE = 64

#: one block of the resident kernel's wgmma schedule: (row, frame) pairs x
#: depths (res::BM, res::BN of csrc/fused_recon.cu)
RESIDENT_TILE = (128, 128)

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


def _magnitude_sum(yr: torch.Tensor, op_re: torch.Tensor,
                   op_im: torch.Tensor) -> torch.Tensor:
    """Σ_b |yr[b] @ (op_re + i·op_im)| in torch ops.  A bfloat16 operator
    rounds yr to bfloat16 and multiplies in float32 (torch's bf16 @ bf16
    would round the products' sums to bfloat16)."""
    if op_re.dtype == torch.bfloat16:
        yr = yr.to(torch.bfloat16).float()
        op_re, op_im = op_re.float(), op_im.float()
    re = torch.matmul(yr, op_re)
    im = torch.matmul(yr, op_im)
    return torch.sqrt(re * re + im * im).sum(dim=0)


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
                               op_im: torch.Tensor) -> torch.Tensor:
    """Σ_b |((raw[b] − pi_frame)·inv_background) @ (op_re + i·op_im)|.

    raw: (B, rows, n_in) uint8; pi_frame, inv_background: (rows, n_in),
    float32 (float64 with a float64 operator, CPU only); op_re, op_im:
    (n_in, ndisp) float32 or bfloat16.  Returns (rows, ndisp).  Replaces the
    TPU kernel ``fused_recon_raw_accumulate`` (pallas_kernels.py:126-160).
    On CUDA a block holds all frames of its rows, forms their ratio on chip
    and stages pi_frame, inv_background and each operator tile once for all
    of them.  With a bfloat16 operator the products run on the bf16 tensor
    cores (``mma.sync`` m16n8k16, float32 sums); with a float32 operator on
    the TF32 tensor cores as three products of the operands' TF32 parts
    (``mma.sync`` m16n8k8, float32 sums; see :func:`split_tf32`).
    """
    B, rows, n_in = _check_stack(raw, "raw")
    if raw.dtype != torch.uint8:
        raise TypeError(f"raw must be uint8, got {raw.dtype}")
    ndisp = _check_operator(op_re, op_im, n_in, raw.device)
    _check_ratio_terms(pi_frame, inv_background, rows, n_in, raw.device, _ratio_dtype(op_re))
    if raw.device.type == "cpu":
        return fused_recon_raw_accumulate_reference(raw, pi_frame, inv_background,
                                                    op_re, op_im)
    out = torch.empty((rows, ndisp), dtype=torch.float32, device=raw.device)
    return _launch("fused_recon_raw_accumulate", "fdoct_recon_raw_u8",
                   [raw, pi_frame, inv_background, op_re, op_im],
                   (B, rows, n_in, ndisp), op_re, out)


def fused_recon_accumulate(yr: torch.Tensor, op_re: torch.Tensor,
                           op_im: torch.Tensor) -> torch.Tensor:
    """Σ_b |yr[b] @ (op_re + i·op_im)|.

    yr: (B, rows, n_in) float32 (float64 with a float64 operator, CPU only);
    op_re, op_im: (n_in, ndisp) float32 or bfloat16.  Returns (rows, ndisp).
    Replaces the TPU kernel ``fused_recon_accumulate``
    (pallas_kernels.py:275-308).  On CUDA it runs the schedule of
    :func:`fused_recon_raw_accumulate` with the ratio read instead of
    formed: rounded to bfloat16 for a bfloat16 operator, split into TF32
    parts for a float32 one.
    """
    B, rows, n_in = _check_stack(yr, "yr")
    ndisp = _check_operator(op_re, op_im, n_in, yr.device)
    if yr.dtype != _ratio_dtype(op_re):
        raise TypeError(f"yr is {yr.dtype}; with a {op_re.dtype} operator it must "
                        f"be {_ratio_dtype(op_re)}")
    if yr.device.type == "cpu":
        return fused_recon_accumulate_reference(yr, op_re, op_im)
    out = torch.empty((rows, ndisp), dtype=torch.float32, device=yr.device)
    return _launch("fused_recon_accumulate", "fdoct_recon_yr_f32",
                   [yr, op_re, op_im], (B, rows, n_in, ndisp), op_re, out)


def resident_schedule(B: int, rows: int, n_in: int, ndisp: int, ptrs) -> str:
    """The schedule the resident kernel runs for these shapes and base
    addresses (``ptrs``: the data pointers of raw, pi_frame, inv_background,
    op_re and op_im), as the C entry chooses it: ``"wgmma"`` (TMA-fed
    ``wgmma``) where TMA can address every input (n_in % 16 == 0, ndisp %
    8 == 0, 16-byte aligned bases), else ``"mma.sync"`` (kernel 1 bf16's
    schedule).  B and rows enter neither: ragged rows and any number of
    frames run on both."""
    del B, rows
    aligned = all(int(p) % 16 == 0 for p in ptrs)
    return "wgmma" if n_in % 16 == 0 and ndisp % 8 == 0 and aligned else "mma.sync"


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
    through once.  On CUDA (``csrc/fused_recon.cu``) TMA brings operator,
    frame, pi_frame and inv_background tiles into a shared-memory ring and
    ``wgmma`` (m64n256k16, bf16, float32 sums) takes the bf16 ratio, formed
    in registers, as its A operand; shapes TMA cannot address run kernel 1
    bf16's ``mma.sync`` schedule (:func:`resident_schedule`).
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

    On CUDA the products run on the s8 tensor cores (``mma.sync``
    m16n8k32, exact s32 sums), which take the operator K-major:
    ``oq_packed`` is :func:`pack_int8_operator` of (oq_re, oq_im), packed
    here when not given (an ``Int8DirectPlan`` carries it).  The min/max
    partials are per INT8_TILE of db whatever the kernel's block.
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
