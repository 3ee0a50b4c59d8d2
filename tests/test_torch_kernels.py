"""The fused group-reconstruction kernels: their plain versions against the
JAX Pallas kernels (interpret mode, as tests/test_pallas.py runs them), the
wrappers' checks and dispatch, and on a GPU the CUDA kernels against their
plain versions.

Tolerances (as tests/test_pallas.py): a float32 operator rtol 1e-4, atol
1e-4·max (summation order); a bfloat16 operator rtol 2e-2, atol 2e-2·max
(the port rounds the ratio to bf16, the Pallas raw kernel keeps it f32).
The bf16 tensor-core kernel against its plain version on the card: rtol
1e-5, atol 1e-5·max, since both round the same float32 ratio to bf16 and
only the order of the float32 sums differs.  The C entry points of
``csrc/*.cu`` are held to the ctypes signatures of ``ops._build``.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from fdoct_tpu_torch.ops import _build, kernels
from fdoct_tpu_torch.ops.kernels import (
    INT8_K_TILE, INT8_TILE, LAUNCHES, RESIDENT_TILE, fused_recon_accumulate,
    fused_recon_accumulate_reference, fused_recon_raw_accumulate,
    fused_recon_raw_accumulate_reference,
)

TOL = {"f32": 1e-4, "bf16": 2e-2}
TC_TOL = 1e-5
SHAPES = {"tiled": (3, 16, 64, 32), "ragged": (3, 10, 30, 7)}
#: the bf16 tensor-core kernel's edges (B, rows, n_in, ndisp): rows not a
#: multiple of a block's rows, n_in not a multiple of 16 (element staging)
#: or of the 32-sample stage, ndisp not a multiple of 8, and 1 to 40 frames
EDGE_SHAPES = {"rows-ragged": (8, 70, 300, 100), "k-tail": (8, 37, 48, 80),
               "one-frame": (1, 65, 64, 64), "forty-frames": (40, 9, 96, 24),
               "three-frames": (3, 20, 100, 13), "two-frames": (2, 130, 512, 136)}


def make_problem(shape, seed=0):
    B, rows, n_in, ndisp = shape
    rng = np.random.default_rng(seed)
    return dict(
        raw=rng.integers(0, 255, (B, rows, n_in)).astype(np.uint8),
        yr=rng.normal(size=(B, rows, n_in)).astype(np.float32),
        bg=rng.uniform(50, 200, (rows, n_in)).astype(np.float32),
        pi=rng.uniform(0, 50, (rows, n_in)).astype(np.float32),
        mr=rng.normal(size=(n_in, ndisp)).astype(np.float32),
        mi=rng.normal(size=(n_in, ndisp)).astype(np.float32),
    )


def torch_op(p, op, device="cpu"):
    dt = torch.bfloat16 if op == "bf16" else torch.float32
    return (torch.as_tensor(p["mr"]).to(device=device, dtype=dt),
            torch.as_tensor(p["mi"]).to(device=device, dtype=dt))


def assert_close(got, want, op):
    tol = TOL[op]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


@pytest.fixture
def pallas():
    """The JAX Pallas kernels, imported here so that the CUDA cases below can
    run where JAX is not installed (``--noconftest -m cuda``)."""
    import jax.numpy as jnp
    from fdoct_tpu.ops import pallas_kernels
    return jnp, pallas_kernels


def tiles(shape):
    _, rows, _, ndisp = shape
    return dict(tile_rows=8 if rows % 8 == 0 else rows,
                tile_depth=16 if ndisp % 16 == 0 else ndisp)


@pytest.mark.parametrize("op", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_raw_plain_matches_pallas_kernel(pallas, shape, op):
    jnp, pk = pallas
    p = make_problem(shape)
    jdt = jnp.bfloat16 if op == "bf16" else jnp.float32
    want = np.asarray(pk.fused_recon_raw_accumulate(
        jnp.asarray(p["raw"]), jnp.asarray(p["pi"]), jnp.asarray(1.0 / p["bg"]),
        jnp.asarray(p["mr"], jdt), jnp.asarray(p["mi"], jdt),
        interpret=True, **tiles(shape)))
    got = fused_recon_raw_accumulate(
        torch.as_tensor(p["raw"]), torch.as_tensor(p["pi"]),
        torch.as_tensor(1.0 / p["bg"]), *torch_op(p, op))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert_close(got.numpy(), want, op)


@pytest.mark.parametrize("op", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_yr_plain_matches_pallas_kernel(pallas, shape, op):
    jnp, pk = pallas
    p = make_problem(shape)
    jdt = jnp.bfloat16 if op == "bf16" else jnp.float32
    want = np.asarray(pk.fused_recon_accumulate(
        jnp.asarray(p["yr"], jdt), jnp.asarray(p["mr"], jdt), jnp.asarray(p["mi"], jdt),
        interpret=True, **tiles(shape)))
    got = fused_recon_accumulate(torch.as_tensor(p["yr"]), *torch_op(p, op))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert_close(got.numpy(), want, op)


def test_plain_versions_match_float64_numpy():
    p = make_problem(SHAPES["ragged"], seed=1)
    yr = (p["raw"].astype(np.float64) - p["pi"]) * (1.0 / p["bg"].astype(np.float64))
    want = np.abs(yr @ (p["mr"] + 1j * p["mi"]).astype(np.complex128)).sum(0)
    f64 = {k: torch.as_tensor(v.astype(np.float64)) for k, v in p.items() if k != "raw"}
    got = fused_recon_raw_accumulate(torch.as_tensor(p["raw"]), f64["pi"], 1.0 / f64["bg"],
                                     f64["mr"], f64["mi"])
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12)
    got_yr = fused_recon_accumulate(torch.as_tensor(yr), f64["mr"], f64["mi"])
    np.testing.assert_allclose(got_yr.numpy(), want, rtol=1e-12)


def test_bf16_operator_rounds_the_ratio():
    p = make_problem(SHAPES["tiled"], seed=2)
    op_re, op_im = torch_op(p, "bf16")
    yr = torch.as_tensor(p["yr"])
    z = yr.to(torch.bfloat16).double()
    re, im = z @ op_re.double(), z @ op_im.double()
    want = torch.sqrt(re * re + im * im).sum(0)
    got = fused_recon_accumulate(yr, op_re, op_im)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)


def test_cpu_calls_count_no_launch():
    p = make_problem(SHAPES["ragged"])
    before = dict(LAUNCHES)
    fused_recon_raw_accumulate(torch.as_tensor(p["raw"]), torch.as_tensor(p["pi"]),
                               torch.as_tensor(1.0 / p["bg"]), *torch_op(p, "f32"))
    fused_recon_accumulate(torch.as_tensor(p["yr"]), *torch_op(p, "bf16"))
    assert LAUNCHES == before


def test_reset_launches():
    LAUNCHES["fused_recon_accumulate"] += 2
    kernels.reset_launches()
    assert set(LAUNCHES.values()) == {0}


def _raw_args(p):
    return [torch.as_tensor(p["raw"]), torch.as_tensor(p["pi"]),
            torch.as_tensor(1.0 / p["bg"]), *torch_op(p, "f32")]


@pytest.mark.parametrize("mutate,exc,match", [
    (lambda a: a.__setitem__(0, a[0].float()), TypeError, "uint8"),
    (lambda a: a.__setitem__(0, a[0][:, :, :-1]), ValueError, "contiguous"),
    (lambda a: a.__setitem__(0, a[0][:0]), ValueError, "non-empty"),
    (lambda a: a.__setitem__(1, a[1][:-1]), ValueError, "pi_frame"),
    (lambda a: a.__setitem__(2, a[2].double()), TypeError, "inv_background"),
    (lambda a: a.__setitem__(3, a[3][:-1]), ValueError, "operator shapes"),
    (lambda a: a.__setitem__(4, a[4].to(torch.bfloat16)), TypeError, "op_im"),
    (lambda a: a.__setitem__(3, a[3].t().contiguous().t()), ValueError, "contiguous"),
], ids=["dtype", "strided", "empty", "pi-shape", "inv-dtype", "op-shape",
        "op-mixed", "op-strided"])
def test_raw_wrapper_rejects(mutate, exc, match):
    args = _raw_args(make_problem(SHAPES["tiled"]))
    mutate(args)
    with pytest.raises(exc, match=match):
        fused_recon_raw_accumulate(*args)


def test_yr_wrapper_rejects_mismatched_dtype():
    p = make_problem(SHAPES["tiled"])
    with pytest.raises(TypeError, match="yr is torch.float64"):
        fused_recon_accumulate(torch.as_tensor(p["yr"]).double(), *torch_op(p, "bf16"))
    with pytest.raises(ValueError, match="B, rows, n_in"):
        fused_recon_accumulate(torch.as_tensor(p["yr"][0]), *torch_op(p, "f32"))


# --------------------------------------------------------------------------
# the C entry points against their ctypes signatures


_C_TYPES = {"const void*": ctypes.c_void_p, "void*": ctypes.c_void_p,
            "int": ctypes.c_int, "float": ctypes.c_float}


def c_entry_points() -> dict[str, list]:
    """name → ctypes argument types of every ``fdoct_*`` function defined
    in csrc/*.cu (all of them inside ``extern "C"``)."""
    found = {}
    for src in _build.SOURCES:
        text = src.read_text()
        assert 'extern "C"' in text, src.name
        for name, params in re.findall(r"\bint\s+(fdoct_\w+)\s*\(([^)]*)\)\s*\{", text):
            # "const void* frames" -> "const void*"
            found[name] = [_C_TYPES[" ".join(p.split()[:-1])] for p in params.split(",")]
    return found


def test_every_signature_has_a_c_entry_point_and_back():
    assert set(c_entry_points()) == set(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_c_entry_point_matches_its_ctypes_signature(name):
    assert c_entry_points()[name] == _build.SIGNATURES[name]


def test_tile_constants_match_the_sources():
    """The Python tile constants are the ones the kernels are built with."""
    text = {src.name: src.read_text() for src in _build.SOURCES + _build.HEADERS}

    def const(file, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text[file]).group(1))

    assert const("hopper_mma.cuh", "KT") == INT8_K_TILE           # namespace tc
    assert "using tc::KT;" in text["int8_bscan.cu"]
    assert INT8_TILE == (32, 32) and "32 x 32 tile" in text["int8_bscan.cu"]
    assert RESIDENT_TILE == (const("fused_recon.cu", "RES_VROWS"),
                             const("fused_recon.cu", "RES_TD"))


def test_build_hashes_the_shared_header():
    assert [h.name for h in _build.HEADERS] == ["hopper_mma.cuh"]
    for src in _build.SOURCES:
        assert '#include "hopper_mma.cuh"' in src.read_text(), src.name


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["f32", "bf16"])
@pytest.mark.parametrize("shape", list(SHAPES.values()) + [(2, 70, 300, 100)],
                         ids=list(SHAPES) + ["wide"])
def test_cuda_kernels_match_plain(cuda, shape, op):
    p = make_problem(shape, seed=5)
    t = {k: torch.as_tensor(v).to(cuda) for k, v in p.items()}
    op_re, op_im = torch_op(p, op, cuda)
    inv = (1.0 / t["bg"]).contiguous()
    before = dict(LAUNCHES)
    got = fused_recon_raw_accumulate(t["raw"], t["pi"], inv, op_re, op_im)
    got_yr = fused_recon_accumulate(t["yr"], op_re, op_im)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_recon_raw_accumulate"] == before["fused_recon_raw_accumulate"] + 1
    assert LAUNCHES["fused_recon_accumulate"] == before["fused_recon_accumulate"] + 1
    want = fused_recon_raw_accumulate_reference(t["raw"], t["pi"], inv, op_re, op_im)
    want_yr = fused_recon_accumulate_reference(t["yr"], op_re, op_im)
    assert_close(got.cpu().numpy(), want.cpu().numpy(), op)
    assert_close(got_yr.cpu().numpy(), want_yr.cpu().numpy(), op)


@pytest.mark.cuda
def test_cuda_rejects_float64_operator(cuda):
    p = make_problem(SHAPES["tiled"])
    yr = torch.as_tensor(p["yr"]).double().to(cuda)
    op = torch.as_tensor(p["mr"]).double().to(cuda)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_recon_accumulate(yr, op, op)


def assert_tc_close(got, want):
    np.testing.assert_allclose(got, want, rtol=TC_TOL, atol=TC_TOL * np.abs(want).max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(EDGE_SHAPES.values()), ids=list(EDGE_SHAPES))
def test_cuda_bf16_tensor_core_edges(cuda, shape):
    p = make_problem(shape, seed=7)
    t = {k: torch.as_tensor(v).to(cuda) for k, v in p.items()}
    op = torch_op(p, "bf16", cuda)
    inv = (1.0 / t["bg"]).contiguous()
    before = LAUNCHES["fused_recon_raw_accumulate"]
    got = fused_recon_raw_accumulate(t["raw"], t["pi"], inv, *op)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_recon_raw_accumulate"] == before + 1
    want = fused_recon_raw_accumulate_reference(t["raw"], t["pi"], inv, *op)
    assert_tc_close(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_cuda_bf16_tensor_core_unaligned(cuda):
    """An operator view that is not 16-byte aligned takes the element loads."""
    shape = (4, 16, 64, 32)
    p = make_problem(shape, seed=8)
    t = {k: torch.as_tensor(v).to(cuda) for k, v in p.items()}
    op_re, op_im = torch_op(p, "bf16", cuda)
    flat = torch.empty(op_re.numel() + 1, dtype=torch.bfloat16, device=cuda)
    flat[1:] = op_re.flatten()
    op_re = flat[1:].view(op_re.shape)
    inv = (1.0 / t["bg"]).contiguous()
    got = fused_recon_raw_accumulate(t["raw"], t["pi"], inv, op_re, op_im)
    want = fused_recon_raw_accumulate_reference(t["raw"], t["pi"], inv, op_re, op_im)
    assert_tc_close(got.cpu().numpy(), want.cpu().numpy())
