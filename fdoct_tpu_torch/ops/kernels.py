"""The fused group-reconstruction kernels and their plain versions.

Hopper counterparts of two Pallas kernels of ``fdoct_tpu/ops/pallas_kernels.py``:

- :func:`fused_recon_raw_accumulate`: Σ_b |((raw[b] − y_p)·(1/y_b)) @ M| from
  raw uint8 frames, the ratio formed on the tile;
- :func:`fused_recon_accumulate`: Σ_b |yr[b] @ M| from a float32 ratio stack.

Both are one CUDA C++ template (``csrc/fused_recon.cu``), built by
:mod:`fdoct_tpu_torch.ops._build`.  M = op_re + i·op_im is float32 or
bfloat16; with bfloat16 the ratio is rounded to bfloat16 before the product
and the sums stay float32.  A wrapper given CPU tensors computes the plain
version beside it (``*_reference``); given CUDA tensors it launches the
kernel, or raises.  :data:`LAUNCHES` counts kernel launches, and only those.
"""

from __future__ import annotations

import torch

from fdoct_tpu_torch.ops import _build

#: kernel launches per wrapper since the last reset (CPU calls do not count)
LAUNCHES = {"fused_recon_raw_accumulate": 0, "fused_recon_accumulate": 0}


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
    """
    B, rows, n_in = _check_stack(raw, "raw")
    if raw.dtype != torch.uint8:
        raise TypeError(f"raw must be uint8, got {raw.dtype}")
    ndisp = _check_operator(op_re, op_im, n_in, raw.device)
    for t, name in ((pi_frame, "pi_frame"), (inv_background, "inv_background")):
        if t.shape != (rows, n_in) or t.device != raw.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({rows}, {n_in}) tensor "
                             f"on {raw.device}")
        if t.dtype != _ratio_dtype(op_re):
            raise TypeError(f"{name} is {t.dtype}; with a {op_re.dtype} operator "
                            f"it must be {_ratio_dtype(op_re)}")
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
    (pallas_kernels.py:275-308).
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
