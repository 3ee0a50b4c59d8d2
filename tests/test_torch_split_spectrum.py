"""The angiography volume's split-spectrum product kernel
(``ops.kernels.split_spectrum_mags``, ``csrc/angio_product.cu``).

    python -m pytest tests/test_torch_split_spectrum.py -q

On the CPU: the wrapper's plain version against the magnitudes of
``pipeline._op_matmul_pair`` in float64 (ragged rows, a K tail, columns off
the tile), what the wrapper refuses, the C entry's dispatch and its rule
against ``f32_schedule``, and the persistent blocks' walk over the tiles.
Its ``cuda`` cases, on the card (``python -m pytest --noconftest -m cuda
tests/test_torch_split_spectrum.py``): the kernel against the float64
product at F64_TOL (rtol = atol/max 5e-6, the limit kernels 1 and 2's f32
instances are held to) at edge shapes and a scaled-down angiography shape,
and bit for bit ``fused_recon_accumulate``'s f32 instance at B = 1 and the
mma.sync form.  This file imports no JAX.
"""

from __future__ import annotations

import re

import numpy as np
import pytest
import torch

from fdoct_tpu_torch import angio
from fdoct_tpu_torch.ops import _build
from fdoct_tpu_torch.ops.kernels import (
    LAUNCHES, f32_schedule, fused_recon_accumulate, pack_tf32_operator, split_spectrum_mags,
    split_spectrum_mags_reference,
)
from fdoct_tpu_torch.pipeline import _op_matmul_pair

SOURCE = _build.PACKAGE_ROOT / "csrc" / "angio_product.cu"
#: rtol = atol/max of the float32-grade products against the float64 one
F64_TOL = 5e-6
#: (rows, n_in, ncols): ragged rows (not a multiple of 128), a K tail (n_in
#: not a multiple of the 32-sample stage), columns off the 64-column tile,
#: one row, and n_in % 4 != 0 (the mma.sync form on the card)
EDGES = {"rows-ragged": (130, 64, 128), "k-tail": (37, 100, 64), "cols-off-tile": (64, 32, 65),
         "one-row": (1, 48, 30), "all-ragged": (257, 300, 200), "k-unaligned": (20, 302, 70)}


def problem(shape, seed, dtype=torch.float64, device="cpu"):
    rows, n_in, ncols = shape
    rng = np.random.default_rng(seed)
    yr, op_re, op_im = (torch.as_tensor(rng.normal(size=s)).to(device, dtype)
                        for s in ((rows, n_in), (n_in, ncols), (n_in, ncols)))
    return yr, op_re, op_im


def operator(op_re, op_im):
    return angio.SplitSpectrumOperator(op_re=op_re, op_im=op_im,
                                       op_re_bf16=op_re.to(torch.bfloat16),
                                       op_im_bf16=op_im.to(torch.bfloat16))


@pytest.mark.parametrize("shape", list(EDGES.values()), ids=list(EDGES))
def test_plain_version_is_the_pair_magnitudes(shape):
    yr, op_re, op_im = problem(shape, sum(shape))
    re_, im_ = _op_matmul_pair(yr, operator(op_re, op_im), "highest")
    want = re_.mul_(re_).addcmul_(im_, im_).sqrt_()
    got = split_spectrum_mags(yr, op_re, op_im)
    assert got.dtype == torch.float64 and got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=1e-13, atol=1e-13 * float(want.max()))
    assert torch.equal(got, split_spectrum_mags_reference(yr, op_re, op_im))


def test_leading_dimensions_are_kept_and_float32_is_float32_grade():
    yr, op_re, op_im = problem((6 * 10, 96, 70), 7)
    stack = yr.float().view(6, 10, 96)
    before = dict(LAUNCHES)
    got = split_spectrum_mags(stack, op_re.float(), op_im.float(),
                              pack_tf32_operator(op_re.float(), op_im.float()))
    assert got.shape == (6, 10, 70) and got.dtype == torch.float32
    assert LAUNCHES == before                       # a CPU call launches nothing
    want = split_spectrum_mags(yr, op_re, op_im).view(6, 10, 70)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=F64_TOL,
                               atol=F64_TOL * float(want.max()))


@pytest.mark.parametrize("case,error,match", [
    ("bf16-operator", TypeError, "both must be float32"),
    ("mixed-types", TypeError, "both must be float32"),
    ("not-contiguous", ValueError, "contiguous"),
    ("operator-rows", ValueError, "do not match n_in"),
    ("table-shape", ValueError, "op_tf32 must be a contiguous"),
    ("empty", ValueError, "non-empty"),
])
def test_the_wrapper_refuses(case, error, match):
    yr, op_re, op_im = (t.float() for t in problem((8, 32, 16), 1))
    kw = {}
    if case == "bf16-operator":
        op_re, op_im = op_re.to(torch.bfloat16), op_im.to(torch.bfloat16)
    elif case == "mixed-types":
        yr = yr.double()
    elif case == "not-contiguous":
        yr = yr.t().contiguous().t()
    elif case == "operator-rows":
        op_re, op_im = op_re[:-4], op_im[:-4]
    elif case == "table-shape":
        kw["op_tf32"] = pack_tf32_operator(op_re[:, :8].contiguous(), op_im[:, :8].contiguous())
    elif case == "empty":
        yr = yr[:0]
    with pytest.raises(error, match=match):
        split_spectrum_mags(yr, op_re, op_im, **kw)


def _entry_body(text: str, name: str) -> str:
    body = text[text.index(f"int {name}("):]
    return body[:body.index("\n}\n")]


def test_the_entry_takes_wgmma_where_f32_schedule_says_so_else_kernel_2():
    """The C entry runs the persistent wgmma schedule where TMA can address
    the ratio and the table (ssm_applies: the f32 ratio's rule of
    ws32_applies), else kernel 2's f32 entry at B = 1, whose rule then fails
    too: the mma.sync form; f32_schedule mirrors both rules."""
    text = SOURCE.read_text()
    body = _entry_body(text, "fdoct_split_spectrum_mags_f32")
    assert body.count("ssm_applies(yr, op_tf32, n_in)") == 1
    assert body.count("launch_ssm(") == 1
    assert body.count("fdoct_recon_yr_f32_f32(yr, op_re, op_im, op_tf32, mags, 1, ") == 1
    rule = text[text.index("bool ssm_applies("):]
    assert "return n_in % 4 == 0 && aligned(yr) && aligned(op_tf32);" in rule[:rule.index("\n}\n")]
    assert text.count("wgmma_m64n128k8_tf32_rs(part, ") == 3
    assert "tc::add_magnitude(" in text and "__fadd_rn(acc[i], part[i])" in text
    assert f32_schedule(torch.float32, 2048, 3200, [0, 0]) == "wgmma"
    for n_in, ptrs in ((2046, [0, 0]), (2048, [4, 0]), (2048, [0, 8])):
        assert f32_schedule(torch.float32, n_in, 3200, ptrs) == "mma.sync"
    assert _build.SIGNATURES["fdoct_split_spectrum_mags_f32"] == [_build._PTR] * 5 + \
        [_build._INT] * 3 + [_build._PTR]
    assert "split_spectrum_mags" in LAUNCHES


def _const(text: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


@pytest.mark.parametrize("rows,ncols", [(320_000, 3200), (129, 65), (2048, 64), (128 * 37, 640)])
def test_the_tile_walk_covers_each_tile_once(rows, ncols):
    """ssm_tile's walk, emulated: groups of GROUP row tiles (the last one
    short), column-tile-major inside a group, every tile exactly once."""
    text = SOURCE.read_text()
    bm, bn, group = (_const(text, n) for n in ("BM", "BN", "GROUP"))
    assert (bm, bn) == (128, 64)
    assert 128 * _const(text, "PRODUCER_REGS") + 256 * _const(text, "CONSUMER_REGS") <= 65536
    nrt, nct = -(-rows // bm), -(-ncols // bn)
    seen = []
    for tile in range(nrt * nct):
        g, idx = divmod(tile, group * nct)
        in_group = min(group, nrt - g * group)
        seen.append((g * group + idx % in_group, idx // in_group))
    assert sorted(seen) == [(r, c) for r in range(nrt) for c in range(nct)]
    # the tiles of one column tile of a group follow each other
    first = seen[:min(group, nrt)]
    assert {c for _, c in first} == {0}


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def misaligned(x):
    """The same values through a view one element past an aligned buffer."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.flatten()
    return flat[1:].view(x.shape)


def angio_problem(dev, frames=16):
    """A scaled-down angiography volume's ratio rows (``frames`` frames of
    the OCTA-500 cell's 400 A-lines x 2048 samples) against the cell's
    split-spectrum operator (3,200 columns)."""
    import json

    from fdoct_tpu_torch.config import PipelineConfig
    cfg = PipelineConfig(**json.loads((_build.PACKAGE_ROOT.parent / "oct_bench" / "configs" /
                                       "octa500-6mm-ssada.json").read_text())["pipeline"])
    op = angio.SplitSpectrumOperator.create(cfg, angio.AngioConfig(), dev)
    g = torch.Generator(device=dev).manual_seed(11)
    yr = torch.randn((frames * cfg.height, cfg.width), generator=g, device=dev)
    return yr, op.op_re, op.op_im, op.op_tf32


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(EDGES) + ["angio-16-frames"])
def test_cuda_kernel_is_float32_grade_and_kernel_2_bit_for_bit(cuda, shape):
    if shape == "angio-16-frames":
        yr, op_re, op_im, table = angio_problem(cuda)
    else:
        yr, op_re, op_im = problem(EDGES[shape], 3, torch.float32, cuda)
        table = pack_tf32_operator(op_re, op_im)
    rows, n_in = yr.shape
    before = LAUNCHES["split_spectrum_mags"]
    got = split_spectrum_mags(yr, op_re, op_im, table)
    torch.cuda.synchronize()
    assert LAUNCHES["split_spectrum_mags"] == before + 1
    sched = f32_schedule(torch.float32, n_in, op_re.shape[1], [yr.data_ptr(), table.data_ptr()])
    assert sched == ("mma.sync" if n_in % 4 else "wgmma")
    y = yr.double()
    want = torch.sqrt((y @ op_re.double()) ** 2 + (y @ op_im.double()) ** 2)
    np.testing.assert_allclose(got.double().cpu().numpy(), want.cpu().numpy(), rtol=F64_TOL,
                               atol=F64_TOL * float(want.max()))
    assert torch.equal(got, fused_recon_accumulate(yr[None], op_re, op_im, op_tf32=table))
    assert torch.equal(got, split_spectrum_mags(misaligned(yr), op_re, op_im, table))
    assert torch.equal(got, split_spectrum_mags(yr, op_re, op_im))   # the table packed per call


@pytest.mark.cuda
def test_cuda_the_tf32_control_fails_the_limit(cuda):
    """One TF32 product per multiply-add (cuBLAS with TF32 on) at the
    scaled-down angiography shape fails F64_TOL, which the kernel holds."""
    yr, op_re, op_im, _ = angio_problem(cuda, frames=4)
    y = yr.double()
    want = torch.sqrt((y @ op_re.double()) ** 2 + (y @ op_im.double()) ** 2)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        tf32 = torch.sqrt((yr @ op_re) ** 2 + (yr @ op_im) ** 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert float((tf32.double() - want).abs().max()) > F64_TOL * float(want.max())
