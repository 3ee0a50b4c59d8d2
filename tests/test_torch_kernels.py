"""The fused group-reconstruction kernels: their plain versions against the
JAX Pallas kernels (interpret mode, as tests/test_pallas.py runs them), the
wrappers' checks and dispatch, and on a GPU the CUDA kernels against their
plain versions.

Tolerances (as tests/test_pallas.py): a float32 operator rtol 1e-4, atol
1e-4·max (summation order); a bfloat16 operator rtol 2e-2, atol 2e-2·max
(the port rounds the ratio to bf16, the Pallas raw kernel keeps it f32).
The bf16 tensor-core instances (raw frames and a float32 ratio) against
their plain versions on the card: rtol 1e-5, atol 1e-5·max, since both
round the same float32 ratio to bf16 and only the order of the float32 sums
differs.  The float32-operator instances (3xTF32 on the tensor cores)
against their float32 plain versions at the float32 tolerance and against
the float64 product at rtol 5e-6, atol 5e-6·max, a limit that one TF32
product fails; on the CPU the 3xTF32 split emulated in torch against the
float64 product at both.  The C entry points of ``csrc/*.cu`` are held to
the ctypes signatures of ``ops._build``.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from fdoct_tpu_torch.ops import _build, kernels
from fdoct_tpu_torch.ops.kernels import (
    EDGE_SHAPES, INT8_K_TILE, INT8_TILE, LAUNCHES, WGMMA_TILE, fused_recon_accumulate,
    fused_recon_accumulate_reference, fused_recon_raw_accumulate,
    fused_recon_raw_accumulate_reference, split_tf32,
)

TOL = {"f32": 1e-4, "bf16": 2e-2}
TC_TOL = 1e-5
#: the float32-operator instances against the float64 product of the same
#: float32 ratio and operator (chip_smoke.py's F64_TOL): float32-grade
#: products pass, one TF32 product per multiply-add does not
F64_TOL = 5e-6
SHAPES = {"tiled": (3, 16, 64, 32), "ragged": (3, 10, 30, 7)}


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
        raw16=rng.integers(0, 65536, (B, rows, n_in)).astype(np.uint16),
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


def test_split_tf32_parts():
    x = torch.as_tensor(np.random.default_rng(3).normal(size=4096) *
                        np.exp(np.random.default_rng(4).normal(size=4096) * 8)).float()
    hi, lo = split_tf32(x)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()        # TF32: 10 mantissa bits
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -11).all()           # hi: round to nearest
    assert ((x.double() - hi.double() - lo.double()).abs() <= x.abs().double() * 2.0 ** -21).all()
    assert torch.equal(split_tf32(torch.tensor([1.0 + 2.0 ** -11]))[0], torch.tensor([1.0 + 2.0 ** -10]))


def ratio32(t, inp):
    """The float32 ratio an instance takes (yr) or forms (raw), rounded as
    the kernel forms it."""
    if inp in ("raw", "raw16"):
        return (t[inp].float() - t["pi"]) * (1.0 / t["bg"])
    return t["yr"]


def f64_magnitude_sum(x32, op_re, op_im):
    x = x32.double()
    return torch.hypot(x @ op_re.double(), x @ op_im.double()).sum(0)


def assert_f64_close(got, x32, op_re, op_im):
    """A float32-operator result against the float64 product of its float32
    ratio and operator, at F64_TOL."""
    want = f64_magnitude_sum(x32, op_re, op_im).cpu().numpy()
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=F64_TOL,
                               atol=F64_TOL * np.abs(want).max())


@pytest.mark.parametrize("shape", list(SHAPES.values()) + list(EDGE_SHAPES.values()),
                         ids=list(SHAPES) + list(EDGE_SHAPES))
def test_f64_limit_passes_f32_and_rejects_one_tf32_product(shape):
    """At every shape where the card's float32-operator instances are held to
    F64_TOL, the float32 product and the emulated 3xTF32 split pass it and
    one TF32 product (the operands' hi parts) fails it."""
    p = make_problem(shape, seed=9)
    t = {k: torch.as_tensor(v) for k, v in p.items()}
    op_re, op_im = torch_op(p, "f32")
    for inp in ("raw", "yr"):
        x32 = ratio32(t, inp)
        assert_f64_close(fused_recon_accumulate_reference(x32, op_re, op_im), x32, op_re, op_im)
        assert_f64_close(_tf32x3_magnitude_sum(x32, op_re, op_im), x32, op_re, op_im)
        one = torch.hypot(*(split_tf32(x32)[0] @ split_tf32(o)[0] for o in (op_re, op_im))).sum(0)
        with pytest.raises(AssertionError):
            assert_f64_close(one, x32, op_re, op_im)


def _tf32x3_magnitude_sum(yr, op_re, op_im):
    """Σ_b |yr[b] @ M| with each product as the float32-operator kernels form
    it: lo·hi + hi·lo + hi·hi of the operands' TF32 parts, float32 sums."""
    (yh, yl), parts = split_tf32(yr), [split_tf32(op_re), split_tf32(op_im)]
    re, im = ((yl @ oh) + (yh @ ol) + (yh @ oh) for oh, ol in parts)
    return torch.sqrt(re * re + im * im).sum(dim=0)


@pytest.fixture(scope="module")
def flagship_like():
    """8 frames of 64 rows x 2048 samples from the synthetic source, against
    the flagship operator (2048 x 512) of Calibration.create."""
    from fdoct_tpu_torch.calibration import Calibration
    from fdoct_tpu_torch.config import PipelineConfig
    from fdoct_tpu_torch.sources.synthetic import SyntheticSource
    cfg = PipelineConfig(width=2048, height=64, averages=8, numfftpoints=2048,
                         numdisplaypoints=512, lambdamin=816e-9, lambdamax=884e-9)
    calib = Calibration.create(cfg, torch.device("cpu"))
    src = SyntheticSource(height=64, width=2048, lambda0=cfg.lambda0,
                          dlambda=cfg.lambdabw * 2.3548 / 4.0, noise=0.02, seed=0)
    it = src.frames()
    raw = torch.as_tensor(np.stack([next(it) for _ in range(8)]))
    bg = torch.as_tensor(np.maximum(src.background(), 1)).float()
    pi = torch.as_tensor(src.pi_frame()).float()
    yr = (raw.float() - pi) * (1.0 / bg)
    return yr, calib.op_re, calib.op_im


def test_tf32x3_split_keeps_the_f32_tolerance(flagship_like):
    """The numerics of the float32-operator kernels at a flagship-like shape:
    within a hundredth of rtol = atol/max = 1e-4 of the float64 product and
    within twice the float32 product's error; one TF32 product (hi·hi alone)
    errs a hundred times more, which is why the split is taken.  F64_TOL
    tells the two apart: the split and float32 pass it, TF32 alone fails."""
    yr, op_re, op_im = flagship_like
    y64 = yr.double()
    want = torch.hypot(y64 @ op_re.double(), y64 @ op_im.double()).sum(0)

    def share(got, tol=TOL["f32"]):
        return float(((got.double() - want).abs() / (tol * want.abs() + tol * want.abs().max())
                      ).max())

    got = {"split": _tf32x3_magnitude_sum(yr, op_re, op_im),
           "plain": fused_recon_accumulate_reference(yr, op_re, op_im),      # float32
           "one": torch.hypot(*(split_tf32(yr)[0] @ split_tf32(o)[0] for o in (op_re, op_im))
                              ).sum(0)}
    split, plain, one = (share(g) for g in got.values())
    assert split <= 0.01 and split <= 2 * plain, (split, plain)     # as good as float32
    assert one >= 100 * split, (one, split)     # TF32 alone: ~3 digits, not 'highest's'
    f64 = {k: share(g, F64_TOL) for k, g in got.items()}
    assert f64["split"] <= 0.1 and f64["plain"] <= 0.1 and f64["one"] > 1.0, f64



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


#: 16-bit frames: the full range, and Mono16 as cameras and the session make
#: it (12-bit counts << 4)
U16_VALUES = {"full": lambda rng, shape: rng.integers(0, 65536, shape),
              "mono16": lambda rng, shape: rng.integers(0, 4096, shape) << 4}


@pytest.mark.parametrize("values", list(U16_VALUES))
@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_raw_u16_plain_matches_pallas_kernel(pallas, shape, values):
    """16-bit frames, which the TPU kernel takes ("raw uint8/uint16"), with a
    float32 operator: the port's plain version against the Pallas kernel in
    interpret mode at rtol 1e-5, atol 1e-5 of the peak."""
    jnp, pk = pallas
    p = make_problem(shape, seed=11)
    raw = U16_VALUES[values](np.random.default_rng(12), shape[:3]).astype(np.uint16)
    want = np.asarray(pk.fused_recon_raw_accumulate(
        jnp.asarray(raw), jnp.asarray(p["pi"]), jnp.asarray(1.0 / p["bg"]),
        jnp.asarray(p["mr"]), jnp.asarray(p["mi"]), interpret=True, **tiles(shape)))
    got = fused_recon_raw_accumulate(torch.as_tensor(raw), torch.as_tensor(p["pi"]),
                                     torch.as_tensor(1.0 / p["bg"]), *torch_op(p, "f32"))
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
def test_raw_u16_plain_matches_pallas_kernel_bf16_operator(pallas, shape):
    """16-bit frames with a bfloat16 operator at rtol 1e-5, atol 1e-5 of the
    peak.  The port rounds the ratio to bf16, the Pallas kernel keeps it
    float32 (the 2e-2 of the u8 case above), so the ratio here is one that
    bf16 holds exactly: 8-bit counts << 8 (the session's Mono16 of 8-bit
    frames), π = 0 and 1/y_b a power of two."""
    jnp, pk = pallas
    p = make_problem(shape, seed=13)
    raw = p["raw"].astype(np.uint16) << 8
    pi = np.zeros_like(p["pi"])
    inv = np.full_like(p["bg"], 2.0 ** -7)
    op = torch_op(p, "bf16")
    want = np.asarray(pk.fused_recon_raw_accumulate(
        jnp.asarray(raw), jnp.asarray(pi), jnp.asarray(inv),
        jnp.asarray(p["mr"], jnp.bfloat16), jnp.asarray(p["mi"], jnp.bfloat16),
        interpret=True, **tiles(shape)))
    got = fused_recon_raw_accumulate(torch.as_tensor(raw), torch.as_tensor(pi),
                                     torch.as_tensor(inv), *op)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # the 16-bit counts give the u8 counts' sums, 256 times over
    u8 = fused_recon_raw_accumulate(torch.as_tensor(p["raw"]), torch.as_tensor(pi),
                                    torch.as_tensor(inv), *op)
    np.testing.assert_allclose(got.numpy(), 256 * u8.numpy(), rtol=1e-6)


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32, torch.int8])
def test_raw_wrapper_takes_only_u8_and_u16(dtype):
    args = _raw_args(make_problem(SHAPES["tiled"]))
    args[0] = args[0].to(dtype)
    with pytest.raises(TypeError, match="raw must be uint8 or uint16, got torch.int"):
        fused_recon_raw_accumulate(*args)


def test_u16_entries_are_kernel_1s_template():
    """Kernel 1's wrapper picks its C entry by the frame type, and both u16
    entries run kernel 1's schedules on uint16_t frames: the f32 one the
    f32 instances' dispatch (the warp-specialised 3xTF32 schedule, or the
    mma.sync template), the bf16 one the bf16 instances' dispatch (the
    warp-specialised schedule, or the mma.sync template); LAUNCHES keeps
    one key per TPU kernel, and one each for the angiography product and
    the C-scan volume's, which replace none."""
    text = (_build.PACKAGE_ROOT / "csrc" / "fused_recon.cu").read_text()
    assert kernels.RAW_ENTRY == {torch.uint8: "fdoct_recon_raw_u8",
                                 torch.uint16: "fdoct_recon_raw_u16"}
    for op in ("f32", "bf16"):
        for stem in kernels.RAW_ENTRY.values():
            assert f"{stem}_{op}" in _build.SIGNATURES
    for name, call in {"raw_u16_f32": "launch_f32<uint16_t>",
                       "raw_u16_bf16": "launch_bf16<uint16_t>"}.items():
        body = text[text.index(f"int fdoct_recon_{name}("):]
        assert body[:body.index("}")].count(f"{call}(") == 1, name
    assert set(LAUNCHES) == {"fused_recon_raw_accumulate", "fused_recon_accumulate",
                             "fused_recon_resident", "int8_bscan_display_fused",
                             "split_spectrum_mags", "cscan_volume_mags"}


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
    # the bf16 instances' warp-specialised schedule (namespace ws): 64 pairs
    # (the M of one wgmma) x 128 depths (two consumer warpgroups of 64, re
    # and im making each N = 128), 64 samples a stage, a warpgroup forming A
    # and a producer warpgroup beside them, and registers moved to the
    # consumers within the register file
    assert "namespace ws {" in text["fused_recon.cu"]
    assert WGMMA_TILE == (const("fused_recon.cu", "BM"), const("fused_recon.cu", "BN"))
    assert WGMMA_TILE == (64, 2 * 64)
    assert const("fused_recon.cu", "KT") == 64 and const("fused_recon.cu", "THREADS") == 4 * 128
    producer, former, consumer = (const("fused_recon.cu", n)
                                  for n in ("PRODUCER_REGS", "FORMER_REGS", "CONSUMER_REGS"))
    assert 128 * (producer + former) + 256 * consumer <= 65536
    assert producer % 8 == former % 8 == consumer % 8 == 0
    # the float32-operator instances stage KT / 2 samples (two blocks fit an
    # SM), rows padded to 36 and 136 floats: lane (g, t) of a fragment load
    # reads A row g, sample t and the operator at sample t, depth g, on 32
    # distinct banks each
    f32 = text["fused_recon.cu"]
    assert "static constexpr int KT = tc::KT / 2;" in f32
    assert "static constexpr int A_LD = KT * 4 + 16;" in f32
    assert "static constexpr int OP_LD = 2 * tc::BN * 4 + 32;" in f32
    assert len({(g * 36 + t) % 32 for g in range(8) for t in range(4)}) == 32
    assert len({(t * 136 + g) % 32 for g in range(8) for t in range(4)}) == 32


def _entry_body(text: str, name: str) -> str:
    body = text[text.index(f"int {name}("):]
    return body[:body.index("\n}\n")]


def test_every_entry_point_runs_the_tensor_core_kernel():
    """No entry point of fused_recon.cu is SIMT: the float32-operator ones
    run the warp-specialised 3xTF32 wgmma schedule, the bf16-operator ones
    (the resident entry among them) the warp-specialised bf16 wgmma
    schedule, each or, where TMA cannot address the inputs, the mma.sync
    template; the resident entry has no schedule of its own."""
    text = (_build.PACKAGE_ROOT / "csrc" / "fused_recon.cu").read_text()
    assert "fused_recon_kernel<" not in text and "launch<" not in text
    assert "OpChunk" not in text and "fmaf(" not in text           # the SIMT resident form
    assert "fused_recon_resident_kernel" not in text and "namespace res {" not in text
    dispatch = _entry_body(text, "launch_bf16")
    assert "ws_applies<In>(" in dispatch and dispatch.count("launch_ws<In>(") == 1
    assert dispatch.count("launch_tc<In, __nv_bfloat16>(") == 1
    for name, x in {"raw_u8_bf16": "uint8_t", "raw_u16_bf16": "uint16_t", "yr_f32_bf16": "float",
                    "resident_u8_bf16": "uint8_t"}.items():
        assert _entry_body(text, f"fdoct_recon_{name}").count(f"launch_bf16<{x}>(") == 1, name
    dispatch = _entry_body(text, "launch_f32")
    assert "ws32_applies<In>(" in dispatch and dispatch.count("launch_ws32<In>(") == 1
    assert dispatch.count("launch_tc<In, float>(") == 1
    for name, x in {"raw_u8_f32": "uint8_t", "raw_u16_f32": "uint16_t",
                    "yr_f32_f32": "float"}.items():
        assert _entry_body(text, f"fdoct_recon_{name}").count(f"launch_f32<{x}>(") == 1, name
    assert "wgmma_m64n128k16_ss(part, " in text and "setmaxnreg_inc<" in text
    assert text.count("wgmma_m64n128k8_tf32_rs(part, ") == 3
    assert "tma_load_3d(" in text and "fence_proxy_async()" in text


def test_resident_schedule_mirrors_the_c_rule():
    """ops.kernels.bf16_schedule and ws_applies of fused_recon.cu take the
    wgmma schedule on the same conditions, for each input type of the bf16
    instances; the float32-operator entries dispatch by ws32_applies
    (ops.kernels.f32_schedule, tests/test_torch_tf32_schedule.py)."""
    text = (_build.PACKAGE_ROOT / "csrc" / "fused_recon.cu").read_text()
    body = text[text.index("bool ws_applies("):]
    body = body[:body.index("\n}\n")]
    assert "tma_applies<In>(n_in, ndisp, {x, op_re, op_im})" in body
    assert "(!ws::raw<In>() || tma_applies<In>(n_in, ndisp, {pi, inv_bg}))" in body
    header = (_build.PACKAGE_ROOT / "csrc" / "hopper_mma.cuh").read_text()
    rule = header[header.index("bool tma_applies("):]
    rule = rule[:rule.index("\n}\n")]
    assert "reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;" in rule
    assert "n_in % (16 / static_cast<int>(sizeof(In))) == 0 && ndisp % 8 == 0" in rule
    for dtype, per_16 in {torch.uint8: 16, torch.uint16: 8, torch.float32: 4}.items():
        assert kernels.bf16_schedule(dtype, 2048, 512, [0] * 5) == "wgmma"
        assert kernels.bf16_schedule(dtype, per_16, 8, [0] * 3) == "wgmma"
        for n_in, ndisp, ptrs in ((per_16 * 127 + per_16 // 2, 512, [0] * 5), (2048, 508, [0] * 5),
                                  (2048, 512, [0, 0, 4, 0, 0]), (2048, 512, [0, 0, 0, 0, 8])):
            assert kernels.bf16_schedule(dtype, n_in, ndisp, ptrs) == "mma.sync", (dtype, n_in)
    for name, x in {"raw_u8_f32": "uint8_t", "raw_u16_f32": "uint16_t",
                    "yr_f32_f32": "float"}.items():
        assert _entry_body(text, f"fdoct_recon_{name}").count(f"launch_f32<{x}>(") == 1, name


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
    if op == "f32":
        assert_f64_close(got, ratio32(t, "raw"), op_re, op_im)
        assert_f64_close(got_yr, ratio32(t, "yr"), op_re, op_im)


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


#: the instances redesigned on kernel 1 bf16's tensor-core schedule: the
#: wrapper's input and the operator type
TC_INSTANCES = {"raw-f32": ("raw", "f32"), "yr-f32": ("yr", "f32"), "yr-bf16": ("yr", "bf16"),
                "raw16-bf16": ("raw16", "bf16"), "raw16-f32": ("raw16", "f32")}


def run_instance(t, inp, op, kernel=True):
    """One instance on the problem ``t`` (tensors) with operator ``op``."""
    if inp in ("raw", "raw16"):
        fn = fused_recon_raw_accumulate if kernel else fused_recon_raw_accumulate_reference
        return fn(t[inp], t["pi"], (1.0 / t["bg"]).contiguous(), *op)
    fn = fused_recon_accumulate if kernel else fused_recon_accumulate_reference
    return fn(t["yr"], *op)


def assert_instance_close(got, t, inp, op, op_name):
    """Against the plain version: bf16 at TC_TOL, both round the same ratio;
    f32 at the float32 tolerance, and against the float64 product at
    F64_TOL."""
    want = run_instance(t, inp, op, kernel=False)
    tol = TC_TOL if op_name == "bf16" else TOL["f32"]
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=tol,
                               atol=tol * float(want.abs().max()))
    if op_name == "f32":
        assert_f64_close(got, ratio32(t, inp), *op)


@pytest.mark.cuda
@pytest.mark.parametrize("instance", list(TC_INSTANCES))
@pytest.mark.parametrize("shape", list(EDGE_SHAPES.values()), ids=list(EDGE_SHAPES))
def test_cuda_tensor_core_instance_edges(cuda, shape, instance):
    inp, op_name = TC_INSTANCES[instance]
    p = make_problem(shape, seed=9)
    t = {k: torch.as_tensor(v).to(cuda) for k, v in p.items()}
    op = torch_op(p, op_name, cuda)
    key = "fused_recon_raw_accumulate" if inp.startswith("raw") else "fused_recon_accumulate"
    before = LAUNCHES[key]
    got = run_instance(t, inp, op)
    torch.cuda.synchronize()
    assert LAUNCHES[key] == before + 1
    assert_instance_close(got, t, inp, op, op_name)


@pytest.mark.cuda
@pytest.mark.parametrize("instance", list(TC_INSTANCES))
@pytest.mark.parametrize("which", ["operator", "input"])
def test_cuda_tensor_core_instance_unaligned(cuda, instance, which):
    """An operator or an input view that is not 16-byte aligned takes the
    element loads."""
    inp, op_name = TC_INSTANCES[instance]
    p = make_problem((4, 16, 64, 32), seed=10)
    t = {k: torch.as_tensor(v).to(cuda) for k, v in p.items()}
    op_re, op_im = torch_op(p, op_name, cuda)

    def shifted(x):
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)
        flat[1:] = x.flatten()
        return flat[1:].view(x.shape)

    if which == "operator":
        op_re = shifted(op_re)
    else:
        t[inp] = shifted(t[inp])
    got = run_instance(t, inp, (op_re, op_im))
    assert_instance_close(got, t, inp, (op_re, op_im), op_name)
