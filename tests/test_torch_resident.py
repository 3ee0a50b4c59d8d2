"""The resident kernel (``fused_recon_resident``) and its benchmark.

On the CPU: the plain version against the JAX Pallas kernel in interpret
mode (as tests/test_pallas.py runs it) and against float64 numpy of the
bf16-rounded operands, the wrapper's checks and dispatch, and
``bench_resident`` at a small size, and which schedule the C entry takes
(:func:`resident_schedule`).  On a GPU (cases marked ``cuda``): the CUDA
kernel against its plain version and against kernel 1's bf16 instance, in
both schedules (``wgmma`` + TMA, and ``mma.sync`` where TMA cannot address
the inputs), with ragged tails of every tile.

Tolerance rtol 1e-5, atol 1e-5·max: the Pallas kernel, the plain version and
the CUDA kernel round the same float32 ratio and the same operator to bf16,
and bf16 × bf16 products are exact in float32, so only the order of the
float32 sums differs.
"""

import numpy as np
import pytest
import torch

from fdoct_tpu_torch import bench_resident
from fdoct_tpu_torch.ops.kernels import (
    EDGE_SHAPES, LAUNCHES, RESIDENT_TILE, fused_recon_raw_accumulate, fused_recon_resident,
    fused_recon_resident_reference, resident_schedule,
)

RTOL = 1e-5
SHAPES = {"tiled": ((3, 16, 64, 32), 8), "ragged": ((3, 10, 30, 7), 10)}


def make_problem(shape, seed=0):
    B, rows, n_in, ndisp = shape
    rng = np.random.default_rng(seed)
    return dict(
        raw=rng.integers(0, 255, (B, rows, n_in)).astype(np.uint8),
        pi=rng.uniform(0, 50, (rows, n_in)).astype(np.float32),
        inv=(1.0 / rng.uniform(50, 200, (rows, n_in))).astype(np.float32),
        mr=rng.normal(size=(n_in, ndisp)).astype(np.float32),
        mi=rng.normal(size=(n_in, ndisp)).astype(np.float32),
    )


def args(p, op="f32", device="cpu"):
    dt = torch.bfloat16 if op == "bf16" else torch.float32
    return [torch.as_tensor(p["raw"]).to(device), torch.as_tensor(p["pi"]).to(device),
            torch.as_tensor(p["inv"]).to(device),
            torch.as_tensor(p["mr"]).to(device, dt), torch.as_tensor(p["mi"]).to(device, dt)]


def assert_close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())


@pytest.fixture
def pallas():
    """The JAX Pallas kernels, imported here so that the CUDA cases below can
    run where JAX is not installed (``--noconftest -m cuda``)."""
    import jax.numpy as jnp
    from fdoct_tpu.ops import pallas_kernels
    return jnp, pallas_kernels


@pytest.mark.parametrize("op", ["f32", "bf16"])
@pytest.mark.parametrize("shape,tile_rows", list(SHAPES.values()), ids=list(SHAPES))
def test_plain_matches_pallas_resident(pallas, shape, tile_rows, op):
    jnp, pk = pallas
    p = make_problem(shape)
    jdt = jnp.bfloat16 if op == "bf16" else jnp.float32
    want = np.asarray(pk.fused_recon_resident(
        jnp.asarray(p["raw"]), jnp.asarray(p["pi"]), jnp.asarray(p["inv"]),
        jnp.asarray(p["mr"], jdt), jnp.asarray(p["mi"], jdt),
        tile_rows=tile_rows, interpret=True))
    got = fused_recon_resident(*args(p, op))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert_close(got.numpy(), want)


@pytest.mark.parametrize("shape", [s for s, _ in SHAPES.values()], ids=list(SHAPES))
def test_plain_matches_float64_numpy(shape):
    p = make_problem(shape, seed=1)
    bf16 = lambda x: torch.as_tensor(x).to(torch.bfloat16).double().numpy()   # noqa: E731
    ratio = bf16((p["raw"].astype(np.float32) - p["pi"]) * p["inv"])
    want = np.abs(ratio @ (bf16(p["mr"]) + 1j * bf16(p["mi"]))).sum(0)
    got = fused_recon_resident(*args(p, "f32"))
    assert_close(got.numpy(), want)


def test_float32_operator_is_cast_to_bf16():
    p = make_problem(SHAPES["tiled"][0], seed=2)
    np.testing.assert_array_equal(fused_recon_resident(*args(p, "f32")).numpy(),
                                  fused_recon_resident(*args(p, "bf16")).numpy())
    np.testing.assert_array_equal(fused_recon_resident(*args(p, "f32")).numpy(),
                                  fused_recon_resident_reference(*args(p, "f32")).numpy())


def test_equals_raw_plain_version_with_bf16_operator():
    p = make_problem(SHAPES["ragged"][0], seed=3)
    np.testing.assert_array_equal(fused_recon_resident(*args(p, "bf16")).numpy(),
                                  fused_recon_raw_accumulate(*args(p, "bf16")).numpy())


def test_cpu_calls_count_no_launch():
    before = dict(LAUNCHES)
    fused_recon_resident(*args(make_problem(SHAPES["ragged"][0])))
    assert LAUNCHES == before
    assert "fused_recon_resident" in LAUNCHES


FLAGSHIP = (8, 512, 2048, 512)


@pytest.mark.parametrize("shape,ptrs,want", [
    (FLAGSHIP, (0, 256, 512, 1024, 4096), "wgmma"),
    ((8, 512, 2048, 100), (0,) * 5, "mma.sync"),            # ndisp % 8: bf16 rows not 16 B
    ((8, 512, 300, 512), (0,) * 5, "mma.sync"),             # n_in % 16: u8 rows not 16 B
    (FLAGSHIP, (0, 0, 0, 2, 0), "mma.sync"),                # an operator view off 16 B
    (FLAGSHIP, (0, 8, 0, 0, 0), "mma.sync"),                # pi_frame off 16 B
    ((1, 512, 2048, 512), (0,) * 5, "wgmma"),               # B enters neither rule
    ((3, 37, 208, 136), (0,) * 5, "wgmma"),
    ((40, 9, 96, 24), (0,) * 5, "wgmma"),
    ((8, 70, 1040, 200), (0,) * 5, "wgmma"),                # ragged tails: TMA fills zeros
    ((1, 1, 16, 8), (0,) * 5, "wgmma"),                     # the least strides TMA takes
    ((8, 512, 8, 512), (0,) * 5, "mma.sync"),               # n_in 8: u8 rows of 8 bytes
    ((8, 512, 2048, 4), (0,) * 5, "mma.sync"),              # ndisp 4: bf16 rows of 8 bytes
    (FLAGSHIP, (1, 0, 0, 0, 0), "mma.sync"),                # raw off 16 B
    (FLAGSHIP, (0, 0, 4, 0, 0), "mma.sync"),                # inv_background off 16 B
    (FLAGSHIP, (0, 0, 0, 0, 8), "mma.sync"),                # op_im off 16 B
], ids=["flagship", "ndisp-100", "n_in-300", "op-unaligned", "pi-unaligned", "B1", "B3",
        "B40", "ragged-tails", "least-strides", "n_in-8", "ndisp-4", "raw-unaligned",
        "inv-unaligned", "op_im-unaligned"])
def test_resident_schedule(shape, ptrs, want):
    assert resident_schedule(*shape, ptrs) == want


def test_resident_tile_is_two_warpgroups_by_re_and_im():
    """128 (row, frame) pairs (two wgmma m64 warpgroups) x 128 depths (re and
    im side by side make wgmma's N of 256)."""
    pairs, depths = RESIDENT_TILE
    assert pairs == 2 * 64 and 2 * depths == 256


def _meta(t):
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


@pytest.mark.parametrize("mutate,exc,match", [
    (lambda a: a.__setitem__(0, a[0].to(torch.int16)), TypeError, "uint8"),
    (lambda a: a.__setitem__(0, a[0][:, :, :-1]), ValueError, "contiguous"),
    (lambda a: a.__setitem__(0, a[0][0]), ValueError, "B, rows, n_in"),
    (lambda a: a.__setitem__(1, a[1][:-1]), ValueError, "pi_frame"),
    (lambda a: a.__setitem__(2, a[2].double()), TypeError, "inv_background"),
    (lambda a: a.__setitem__(3, a[3][:-1]), ValueError, "operator shapes"),
    (lambda a: a.__setitem__(4, a[4][:, :-1]), ValueError, "operator shapes"),
    (lambda a: a.__setitem__(4, a[4].to(torch.bfloat16)), TypeError, "op_im"),
    (lambda a: a.__setitem__(1, _meta(a[1])), ValueError, "pi_frame"),
    (lambda a: a.__setitem__(3, _meta(a[3])), ValueError, "operator on"),
    (lambda a: a.__setitem__(0, _meta(a[0])), ValueError, "only cpu and cuda"),
], ids=["dtype", "strided", "rank", "pi-shape", "inv-dtype", "op-rows", "op-mismatch",
        "op-mixed", "pi-device", "op-device", "raw-device"])
def test_wrapper_rejects(mutate, exc, match):
    a = args(make_problem(SHAPES["tiled"][0]))
    mutate(a)
    with pytest.raises(exc, match=match):
        fused_recon_resident(*a)


# --------------------------------------------------------------------------
# the benchmark on the CPU


@pytest.fixture(scope="module")
def bench_rows():
    lines = []
    return bench_resident.run("cpu", small=True, log=lines.append), lines


def test_bench_every_row_runs_and_passes(bench_rows):
    rows, lines = bench_rows
    assert list(rows) == ["fused_f32", "fused_default", "int8", "int8_direct", "bf16", "yr",
                          "raw_f32", "raw_bf16", "resident"]
    shape = (bench_resident.SMALL["height"], bench_resident.SMALL["numdisplaypoints"])
    for row in rows.values():
        assert row.out.shape == shape and bool(torch.isfinite(row.out).all())
        assert row.err < bench_resident.RTOL
        assert row.hot is None and row.streamed is None      # no times on the CPU
    assert rows["fused_f32"].err == 0.0
    assert sum("not measured" in ln for ln in lines) == len(rows)


def test_bench_resident_row_equals_plain_version(bench_rows):
    rows, _ = bench_rows
    np.testing.assert_array_equal(rows["resident"].out.numpy(), rows["bf16"].out.numpy())
    np.testing.assert_array_equal(rows["raw_bf16"].out.numpy(), rows["bf16"].out.numpy())


def test_bench_quick_and_main(capsys):
    assert bench_resident.main(["--device", "cpu", "--small", "--quick"]) == 0
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ": max rel err" in ln]
    assert [ln.split()[1].rstrip(":") for ln in printed] == \
        ["fused_f32", "fused_default", "int8", "int8_direct"]
    assert len(printed) == bench_resident.QUICK_ROWS


def test_bench_fails_on_a_mismatched_row(monkeypatch):
    monkeypatch.setattr(bench_resident, "fused_recon_resident",
                        lambda raw, *a: torch.zeros(raw.shape[1], 128))
    with pytest.raises(RuntimeError, match=r"\['resident'\]"):
        bench_resident.run("cpu", small=True, log=lambda s: None)


def test_bench_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert bench_resident.main([]) == 1


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def assert_resident_case(a):
    """One launch on the card, held to the plain version and to kernel 1's
    bf16 instance at RTOL."""
    before = LAUNCHES["fused_recon_resident"]
    got = fused_recon_resident(*a)
    torch.cuda.synchronize()
    assert LAUNCHES["fused_recon_resident"] == before + 1
    want = fused_recon_resident_reference(*a)
    assert_close(got.cpu().numpy(), want.cpu().numpy())
    kernel1 = fused_recon_raw_accumulate(*a[:3], a[3].to(torch.bfloat16), a[4].to(torch.bfloat16))
    assert_close(got.cpu().numpy(), kernel1.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [
    (3, 16, 64, 32), (3, 10, 30, 7), (8, 70, 300, 100), (8, 9, 1100, 256),
    (40, 5, 200, 136), (1, 33, 520, 8)],
    ids=["tiled", "ragged", "wide", "slabs", "frame-chunks", "one-frame"])
def test_cuda_resident_matches_plain(cuda, shape, op):
    assert_resident_case(args(make_problem(shape, seed=5), op, cuda))


#: ragged tails inside the wgmma schedule (rows % 16, n_in % 64, ndisp % 128
#: not 0 at strides TMA takes), and the flagship
WGMMA_SHAPES = {"flagship": FLAGSHIP, "tails": (8, 70, 1040, 200), "tails-b3": (3, 37, 208, 136),
                "tails-b16": (16, 33, 128, 72), "one-stage": (8, 16, 64, 128)}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(EDGE_SHAPES.values()) + list(WGMMA_SHAPES.values()),
                         ids=list(EDGE_SHAPES) + list(WGMMA_SHAPES))
def test_cuda_resident_edges_and_tails(cuda, shape):
    a = args(make_problem(shape, seed=11), "bf16", cuda)
    if shape in WGMMA_SHAPES.values():
        assert resident_schedule(*shape, [t.data_ptr() for t in a]) == "wgmma"
    assert_resident_case(a)


@pytest.mark.cuda
def test_cuda_resident_misaligned_operator(cuda):
    """An operator view that is not 16-byte aligned takes the mma.sync
    schedule."""
    p = make_problem((3, 12, 40, 16), seed=6)
    a = args(p, "bf16", cuda)
    flat = torch.empty(a[3].numel() + 1, dtype=torch.bfloat16, device=cuda)
    flat[1:] = a[3].flatten()
    a[3] = flat[1:].view(a[3].shape)
    assert resident_schedule(3, 12, 40, 16, [t.data_ptr() for t in a]) == "mma.sync"
    got = fused_recon_resident(*a)
    assert_close(got.cpu().numpy(), fused_recon_resident_reference(*a).cpu().numpy())


@pytest.mark.cuda
def test_cuda_resident_unaligned_operator_at_a_wgmma_shape(cuda):
    """The same at a shape the wgmma schedule takes when aligned."""
    a = args(make_problem((8, 70, 1040, 200), seed=13), "bf16", cuda)
    flat = torch.empty(a[4].numel() + 1, dtype=torch.bfloat16, device=cuda)
    flat[1:] = a[4].flatten()
    a[4] = flat[1:].view(a[4].shape)
    assert resident_schedule(8, 70, 1040, 200, [t.data_ptr() for t in a]) == "mma.sync"
    assert_resident_case(a)
