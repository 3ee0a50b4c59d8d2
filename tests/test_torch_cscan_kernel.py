"""The C-scan volume's kernels (``ops.kernels.cscan_volume_mags``,
``csrc/cscan_volume.cu``, and ``split_spectrum_mags`` at 'highest') and the
route of ``parallel.sharded_cscan_volume`` on one card that picks them.

    python -m pytest tests/test_torch_cscan_kernel.py -q

On the CPU: the wrapper's plain version against the chain it replaces
(``ascan_mags(apodize_ratio(preprocess(...)))`` on bf16-rounded operands),
what the wrapper refuses, the route rule over precision, device, frame type,
method and preprocess (and ``pipeline.kernel_operator``, the operator rule
it shares with the group routes), both routes taken on the CPU (the wrappers' plain
versions) against the chain, the counters ``cscan.frames`` and
``cscan.kernel_frames`` and the reader ``cscan.kernel_frame_share``, and the
C source's rule, rounding and tile walk.  Its ``cuda`` cases, on the card
(``python -m pytest --noconftest -m cuda tests/test_torch_cscan_kernel.py``):
the kernel on u8 and u16 frames against the float64 product of its rounded
operands at chip_smoke.py's BF16_F64_TOL and against its plain version, at
edge shapes; the wgmma schedule bit for bit the mma.sync form and kernel 1
at B = 1; the 'highest' route bit for bit ``split_spectrum_mags``; the
volume against the chain on scaled-down flagship and FLIR volumes, one
launch a volume.  This file imports no JAX.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.ops import _build
from fdoct_tpu_torch.ops.kernels import (
    LAUNCHES, bf16_schedule, cscan_volume_mags, cscan_volume_mags_reference,
    fused_recon_raw_accumulate, split_spectrum_mags,
)
from fdoct_tpu_torch.parallel import sharded
from fdoct_tpu_torch.parallel.sharded import cscan_kernel_route, sharded_cscan_volume
from fdoct_tpu_torch.pipeline import apodize_ratio, ascan_mags, preprocess
from fdoct_tpu_torch.utils import profiling
from fdoct_tpu_torch.utils.profiling import StageTimer

_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               _build.PACKAGE_ROOT.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

ROOT = Path(__file__).resolve().parents[1]
SOURCE = _build.PACKAGE_ROOT / "csrc" / "cscan_volume.cu"
#: rtol = atol/max of the kernel against its plain version (cuBLAS f32 on
#: the same rounded operands, summed in another order) and against the
#: float64 product of its rounded operands
TOL, F64_TOL = chip_smoke.TOL["bf16"], chip_smoke.BF16_F64_TOL
SMALL = dict(width=256, height=40, numfftpoints=256, numdisplaypoints=96, averages=1,
             dtype="float32", donotnormalize=True)
#: (F, rows, n_in, ndisp) on the CPU: a tile of 16 frames x 8 rows cut by
#: ragged frames and rows, a K tail, depths off the 64-depth tile
EDGES = {"rows-70": (3, 70, 96, 100), "one-frame": (1, 9, 64, 64),
         "frames-40": (40, 20, 48, 24), "rows-400": (2, 400, 32, 13)}


def cfg_of(**kw) -> PipelineConfig:
    return PipelineConfig(**{**SMALL, **kw}).validate()


def problem(shape, seed, dtype=torch.uint8, device="cpu"):
    """Seeded frames of ``dtype``, π, 1/S(k) and a bf16 operator."""
    F, rows, n_in, ndisp = shape
    rng = np.random.default_rng(seed)
    top = 255 if dtype == torch.uint8 else 65535
    raw = torch.as_tensor(rng.integers(0, top + 1, (F, rows, n_in)).astype(np.int64)).to(dtype)
    bg = torch.as_tensor(rng.uniform(0.2, 1.2, (rows, n_in)) * top, dtype=torch.float32)
    pi = torch.as_tensor(rng.uniform(0.0, 0.1, (rows, n_in)) * top, dtype=torch.float32)
    op_re, op_im = (torch.as_tensor(rng.normal(size=(n_in, ndisp)) / n_in ** 0.5,
                                    dtype=torch.float32).to(torch.bfloat16) for _ in range(2))
    return tuple(t.to(device) for t in (raw, pi, 1.0 / bg, op_re, op_im))


def chain(raw, pi, inv, op_re, op_im):
    """What sharded_cscan_volume ran before the kernel, on the wrapper's
    arguments: the f32 ratio (y − π)·(1/S) rounded to bf16 and back, the f32
    products with the bf16 operator, the magnitudes, transposed."""
    yr = (raw.float() - pi) * inv
    yr = yr.to(torch.bfloat16).float()
    re, im = yr @ op_re.float(), yr @ op_im.float()
    return torch.sqrt(re * re + im * im).transpose(-1, -2)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=["u8", "u16"])
@pytest.mark.parametrize("shape", list(EDGES.values()), ids=list(EDGES))
def test_plain_version_is_the_chain(shape, dtype):
    args = problem(shape, sum(shape), dtype)
    got = cscan_volume_mags(*args)
    F, rows, _, ndisp = shape
    assert got.shape == (F, ndisp, rows) and got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got, cscan_volume_mags_reference(*args))
    want = chain(*args)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6 * float(want.max()))


@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=["u8", "u16"])
def test_plain_version_is_todays_volume_at_default(dtype):
    """The wrapper on the raw frames, π and 1/S(k) against the volume's old
    chain at 'default' on the card (bf16 operands, float32 products):
    ``ascan_mags(apodize_ratio(preprocess(raw)))``, transposed.  The ratio
    divides there and multiplies by 1/S(k) here, which can round a bf16
    operand the other way: TOL["bf16"]."""
    cfg = cfg_of(bpp=8 if dtype == torch.uint8 else 16)
    calib = Calibration.create(cfg, "cpu")
    raw, pi, inv, _, _ = problem((4, cfg.height, cfg.width, 1), 5, dtype)
    bg = 1.0 / inv
    want = ascan_mags(apodize_ratio(preprocess(raw, cfg), bg, pi, cfg), calib, "fused",
                      "bf16").transpose(-1, -2)
    got = cscan_volume_mags(raw, pi, 1.0 / bg, calib.op_re_bf16, calib.op_im_bf16)
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL * float(want.max()))


@pytest.mark.parametrize("case,error,match", [
    ("f32-operator", TypeError, "must be bfloat16"),
    ("float-frames", TypeError, "uint8 or uint16"),
    ("not-contiguous", ValueError, "contiguous"),
    ("one-frame-2d", ValueError, "non-empty"),
    ("pi-float64", TypeError, "pi_frame is torch.float64"),
    ("pi-rows", ValueError, "pi_frame must be a contiguous"),
    ("operator-rows", ValueError, "do not match n_in"),
])
def test_the_wrapper_refuses(case, error, match):
    raw, pi, inv, op_re, op_im = problem((2, 16, 32, 24), 1)
    if case == "f32-operator":
        op_re, op_im = op_re.float(), op_im.float()
    elif case == "float-frames":
        raw = raw.float()
    elif case == "not-contiguous":
        raw = raw.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "one-frame-2d":
        raw = raw[0]
    elif case == "pi-float64":
        pi = pi.double()
    elif case == "pi-rows":
        pi = pi[:-1]
    elif case == "operator-rows":
        op_re, op_im = op_re[:-4], op_im[:-4]
    with pytest.raises(error, match=match):
        cscan_volume_mags(raw, pi, inv, op_re, op_im)


# --------------------------------------------------------------------------
# the route


def frames_on(device: str, dtype: torch.dtype):
    """What cscan_kernel_route reads of the frames: device, type, rank."""
    return SimpleNamespace(device=torch.device(device), dtype=dtype, ndim=3)


def expected_route(device, dtype, precision, method, preprocess_kw, cfg_dtype):
    if device != "cuda" or method in ("gather", "hilbert") or cfg_dtype != "float32":
        return None
    if precision == "highest" or method == "fused_exact":
        return "f32"
    identity = preprocess_kw == {}
    return "bf16" if identity and dtype in (torch.uint8, torch.uint16) else None


PREPROCESS = {"identity": {}, "median": {"mediann": 3}, "binned": {"binvalue": 2},
              "normalized": {"donotnormalize": False}}


DTYPES = {"u8": torch.uint8, "u16": torch.uint16, "f32": torch.float32}
#: (device, frames, precision, method, preprocess, config dtype): every
#: device, frame type, precision and method on the identity preprocess, and
#: every preprocess and config dtype at each precision on u8 frames on CUDA
ROUTE_CASES = (
    [(dev, dt, prec, meth, "identity", "float32") for dev in ("cuda", "cpu") for dt in DTYPES
     for prec in ("default", "bf16", "highest")
     for meth in ("fused", "fused_exact", "gather", "hilbert")]
    + [("cuda", "u8", prec, "fused", pre, cdt) for prec in ("default", "bf16", "highest")
       for pre in PREPROCESS for cdt in ("float32", "float64")
       if (pre, cdt) != ("identity", "float32")])


@pytest.mark.parametrize("device,dtype,precision,method,pre,cfg_dtype", ROUTE_CASES,
                         ids=["-".join(c) for c in ROUTE_CASES])
def test_the_route_takes_a_kernel_only_where_one_applies(device, dtype, precision, method, pre,
                                                         cfg_dtype):
    dtype = DTYPES[dtype]
    cfg = cfg_of(matmul_precision=precision, dtype=cfg_dtype, **PREPROCESS[pre])
    calib = Calibration.create(cfg, "cpu")
    want = expected_route(device, dtype, precision, method, PREPROCESS[pre], cfg_dtype)
    assert cscan_kernel_route(frames_on(device, dtype), calib, cfg, method) == want


def test_the_int8_tables_keep_the_chain():
    """'int8' with the calibration's int8 tables multiplies in s8 on the
    chain; without them its products are bf16 ones, the kernel's."""
    cfg = cfg_of(matmul_precision="int8")
    calib = Calibration.create(cfg, "cpu")
    assert calib.op_re_q is not None
    assert cscan_kernel_route(frames_on("cuda", torch.uint8), calib, cfg) is None
    bare = Calibration.create(cfg_of(), "cpu")
    assert cscan_kernel_route(frames_on("cuda", torch.uint8), bare, cfg) == "bf16"
    with pytest.raises(ValueError, match="unknown matmul_precision"):
        cscan_kernel_route(frames_on("cuda", torch.uint8), bare,
                           SimpleNamespace(matmul_precision="fp8", dtype="float32"))


#: (precision, method, config dtype, device) → the operator kernel_operator
#: names for the group routes and the volume alike
OPERATOR_CASES = {
    ("default", "fused", "float32", "cuda"): "bf16", ("default", "fused", "float32", "cpu"): "f32",
    ("bf16", "fused", "float32", "cpu"): "bf16", ("highest", "fused", "float32", "cuda"): "f32",
    ("default", "fused_exact", "float32", "cuda"): "f32",
    ("default", "gather", "float32", "cuda"): None, ("highest", "hilbert", "float32", "cpu"): None,
    ("default", "fused", "float64", "cuda"): None, ("highest", "fused", "float64", "cpu"): None,
    ("int8", "fused", "float32", "cuda"): None}


@pytest.mark.parametrize("case", list(OPERATOR_CASES), ids=["-".join(c) for c in OPERATOR_CASES])
def test_one_operator_rule_for_the_group_routes_and_the_volume(case):
    """pipeline.kernel_operator: 'int8' with the calibration's int8 tables,
    a stepwise method and a float64 operator keep the chain."""
    from fdoct_tpu_torch.pipeline import kernel_operator
    precision, method, cfg_dtype, device = case
    cfg = cfg_of(matmul_precision=precision, dtype=cfg_dtype)
    calib = Calibration.create(cfg, "cpu")
    assert kernel_operator(method, cfg, calib, torch.device(device)) == OPERATOR_CASES[case]


# --------------------------------------------------------------------------
# the volume on each route, and its counters


@pytest.fixture
def spans(monkeypatch):
    fresh = StageTimer()
    monkeypatch.setattr(profiling, "SPANS", fresh)
    return fresh


def volume_inputs(cfg, n=5, seed=7):
    raw, pi, inv, _, _ = problem((n, cfg.height, cfg.width, 1), seed,
                                 torch.uint8 if cfg.bpp <= 8 else torch.uint16)
    return raw, 1.0 / inv, pi


def test_the_cpu_volume_counts_its_frames_and_no_kernel_frame(spans):
    cfg = cfg_of()
    calib = Calibration.create(cfg, "cpu")
    raw, bg, pi = volume_inputs(cfg)
    sharded_cscan_volume(raw, bg, pi, calib, cfg)
    assert spans.snapshot()["counters"] == {}                 # nothing recorded off a profiler
    with profile(activities=[ProfilerActivity.CPU]):
        sharded_cscan_volume(raw, bg, pi, calib, cfg)
        sharded_cscan_volume(raw[:2], bg, pi, calib, cfg, method="gather")
    assert spans.snapshot()["counters"] == {"cscan.frames": 7, "cscan.kernel_frames": 0}


@pytest.mark.parametrize("route,precision,bpp", [("bf16", "bf16", 8), ("bf16", "bf16", 16),
                                                 ("f32", "highest", 16)])
def test_each_route_on_the_cpu_gives_the_chain_and_counts_its_frames(monkeypatch, spans, route,
                                                                     precision, bpp):
    """A route taken on the CPU (the wrappers' plain versions): no
    ascan_mags, one wrapper call a volume, the volume of the chain, and its
    frames counted as the kernel's."""
    cfg = cfg_of(matmul_precision=precision, bpp=bpp)
    calib = Calibration.create(cfg, "cpu")
    raw, bg, pi = volume_inputs(cfg)
    want = sharded_cscan_volume(raw, bg, pi, calib, cfg)
    calls = []
    wrapper = "cscan_volume_mags" if route == "bf16" else "split_spectrum_mags"
    real = getattr(sharded, wrapper)
    monkeypatch.setattr(sharded, wrapper, lambda *a: calls.append(a) or real(*a))
    monkeypatch.setattr(sharded, "cscan_kernel_route", lambda *a: route)
    monkeypatch.setattr(sharded, "ascan_mags", None)           # never called on a route
    with profile(activities=[ProfilerActivity.CPU]):
        got = sharded_cscan_volume(raw, bg, pi, calib, cfg)
    assert len(calls) == 1
    assert got.shape == want.shape == (5, 96, cfg.height) and got.is_contiguous()
    rtol = TOL if route == "bf16" else 1e-6
    torch.testing.assert_close(got, want, rtol=rtol, atol=rtol * float(want.max()))
    assert spans.snapshot()["counters"] == {"cscan.frames": 5, "cscan.kernel_frames": 5}


def test_the_reader_reads_the_counters(spans):
    from oct_bench.catalog import Catalog
    share = Catalog(ROOT).reader("cscan.kernel_frame_share")
    layer = {"kind": "cscan", "trace": {"units": 3, "kernel_us": 10.0}, "bound_s": 1e-3}
    assert share(layer) is None                                 # no frames recorded
    spans.add("cscan.frames", 1536)
    assert share(layer) is None                                 # a program that counts none
    spans.add("cscan.kernel_frames", 0)
    assert share(layer) == 0.0                                  # no kernel took them
    spans.add("cscan.kernel_frames", 1536)
    assert share(layer) == 1.0
    assert share(dict(layer, kind="angio")) is None and share(dict(layer, trace=None)) is None
    assert share(dict(layer, trace={"units": 0})) is None


def test_the_benchmark_lists_the_reader_for_both_cscan_cells():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (entry,) = [m for m in bench["per_layer"] if m["name"] == "cscan.kernel_frame_share"]
    assert entry == {"name": "cscan.kernel_frame_share", "unit": "share", "better": "higher",
                     "source": "program_counter", "layer": "C-scan volume",
                     "moves": "cscan_frames_per_s",
                     "workloads": ["flagship-cscan512", "flir-cscan512"]}


# --------------------------------------------------------------------------
# the C source


def _const(name: str, text: str | None = None) -> int:
    text = SOURCE.read_text() if text is None else text
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_the_entries_take_wgmma_where_bf16_schedule_says_so_else_kernel_1_a_frame():
    text = SOURCE.read_text()
    body = text[text.index("int launch_volume("):]
    body = body[:body.index("\n}\n")]
    # kernel 1's rule for raw frames (hopper_mma.cuh's tma_applies, which
    # tests/test_torch_kernels.py holds to bf16_schedule) on all five inputs
    assert body.count("tma_applies<In>(n_in, ndisp, {raw, pi, inv_bg, op_re, op_im})") == 1
    assert body.count("launch_cv<In>(") == 1 and body.count("launch_frames<In>(") == 1
    frames = text[text.index("int launch_frames("):]
    frames = frames[:frames.index("\n}\n")]
    assert "fdoct_recon_raw_u8_bf16 : fdoct_recon_raw_u16_bf16" in frames
    assert "scratch, 1, rows, n_in, ndisp, stream)" in frames
    for name, stem in (("u8", torch.uint8), ("u16", torch.uint16)):
        assert _build.SIGNATURES[f"fdoct_cscan_mags_{name}_bf16"] == \
            [_build._PTR] * 7 + [_build._INT] * 4 + [_build._PTR]
        assert f"launch_volume<uint{8 if name == 'u8' else 16}_t>(" in text
        assert bf16_schedule(stem, 720, 360, [0, 16, 32, 48, 64]) == "wgmma"
    assert bf16_schedule(torch.uint8, 720, 360, [0, 0, 0, 0, 0]) == "wgmma"
    for dtype, n_in, ndisp, ptrs in ((torch.uint8, 300, 360, [0]), (torch.uint16, 300, 360, [0]),
                                     (torch.uint8, 720, 100, [0]), (torch.uint8, 720, 360, [1])):
        assert bf16_schedule(dtype, n_in, ndisp, ptrs) == "mma.sync"
    assert "cscan_volume_mags" in LAUNCHES


def test_the_sums_are_rounded_as_kernel_1_rounds_them():
    """The same interval of rounded rounds as the bf16 instances of
    fused_recon.cu (their sums at B = 1 are this kernel's, bit for bit), a
    fragment zeroed at each round's first k16 step and added in
    round-to-nearest, and the magnitude tc::add_magnitude's."""
    text = SOURCE.read_text()
    ws = (_build.PACKAGE_ROOT / "csrc" / "fused_recon.cu").read_text()
    ws = ws[ws.index("namespace ws {"):ws.index("}  // namespace ws")]
    assert _const("ROUND_STAGES") == _const("ROUND_STAGES", ws) == 2
    assert _const("KT") == _const("KT", ws) == 64
    assert text.count("acc[i] = __fadd_rn(acc[i], part[i]);") == 2
    assert "!fresh || kk > 0" in text and "tc::add_magnitude(v, " in text
    assert "__floats2bfloat162_rn(__fmul_rn(__fsub_rn(" in text
    producer, former, consumer = (_const(n) for n in ("PRODUCER_REGS", "FORMER_REGS",
                                                      "CONSUMER_REGS"))
    assert 128 * (producer + former) + 256 * consumer <= 65536
    assert _const("RT") * _const("FT") == 128 and _const("BN") == 64


def test_the_epilogue_stores_each_output_of_a_tile_once():
    """The epilogue's map of a consumer lane's sums (warpgroup, warp, lane,
    h, j, e) to (frame, depth, row) of a tile: every one of its 16 frames x
    64 depths x 8 rows once."""
    rt, ft, bn = _const("RT"), _const("FT"), _const("BN")
    wg, warp, lane, h, j, e = np.meshgrid(np.arange(2), np.arange(4), np.arange(32),
                                          np.arange(2), np.arange(8), np.arange(2),
                                          indexing="ij")
    f, r, d = 8 * wg + 2 * warp + h, lane >> 2, 8 * j + 2 * (lane & 3) + e
    seen = np.zeros((ft, bn, rt), dtype=np.int64)
    np.add.at(seen, (f.ravel(), d.ravel(), r.ravel()), 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("F,rows,ndisp", [(512, 512, 512), (40, 70, 100), (1, 9, 13),
                                          (3, 400, 360)])
def test_the_tile_walk_covers_each_tile_once(F, rows, ndisp):
    """cv_tile's walk, emulated: every (frame, row, depth) tile once, the
    depth tiles of a pair tile one after another."""
    rt, ft, bn = _const("RT"), _const("FT"), _const("BN")
    nrt, nft, nct = -(-rows // rt), -(-F // ft), -(-ndisp // bn)
    tiles = np.arange(nrt * nft * nct)
    pt = tiles // nct
    d0, r0, f0 = (tiles - pt * nct) * bn, (pt % nrt) * rt, (pt // nrt) * ft
    assert len(set(zip(f0.tolist(), r0.tolist(), d0.tolist()))) == len(tiles)
    assert f0.max() < F and r0.max() < rows and d0.max() < ndisp
    assert set(zip(f0[:nct].tolist(), r0[:nct].tolist())) == {(0, 0)}


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


#: (F, rows, n_in, ndisp) on the card: tiles that straddle frames (rows 480,
#: 400, 70), n_in 720 (wgmma) and 300 (mma.sync: not a whole number of
#: 16-byte rows), ndisp 360 and 100, 1, 3 and 40 frames
CUDA_SHAPES = {"flir-rows": (3, 480, 720, 360), "octa-rows": (1, 400, 720, 104),
               "rows-70": (40, 70, 720, 360), "n_in-300": (3, 70, 300, 360),
               "ndisp-100": (40, 400, 720, 100), "k-tail": (3, 480, 304, 360)}


def f64_product(raw, pi, inv, op_re, op_im):
    """The float64 magnitudes of the kernel's rounded operands, transposed."""
    yr = ((raw.float() - pi) * inv).to(torch.bfloat16).double()
    return torch.hypot(yr @ op_re.double(), yr @ op_im.double()).transpose(-1, -2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.uint16], ids=["u8", "u16"])
@pytest.mark.parametrize("shape", list(CUDA_SHAPES))
def test_cuda_kernel_against_float64_plain_and_kernel_1(cuda, shape, dtype):
    F, rows, n_in, ndisp = CUDA_SHAPES[shape]
    args = problem(CUDA_SHAPES[shape], 11, dtype, cuda)
    before = LAUNCHES["cscan_volume_mags"]
    got = cscan_volume_mags(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["cscan_volume_mags"] == before + 1
    assert got.shape == (F, ndisp, rows) and bool(torch.isfinite(got).all())
    want = f64_product(*args)
    np.testing.assert_allclose(got.double().cpu().numpy(), want.cpu().numpy(), rtol=F64_TOL,
                               atol=F64_TOL * float(want.max()))
    plain = cscan_volume_mags_reference(*args)
    torch.testing.assert_close(got, plain, rtol=TOL, atol=TOL * float(plain.max()))
    sched = bf16_schedule(dtype, n_in, ndisp, [t.data_ptr() for t in args])
    assert sched == ("wgmma" if n_in % (16 // dtype.itemsize) == 0 and ndisp % 8 == 0
                     else "mma.sync")
    raw, pi, inv, op_re, op_im = args
    other = cscan_volume_mags(misaligned(raw), pi, inv, op_re, op_im)   # the mma.sync form
    assert torch.equal(got, other)
    for f in sorted({0, F // 2, F - 1}):
        one = fused_recon_raw_accumulate(raw[f:f + 1], pi, inv, op_re, op_im)
        assert torch.equal(got[f], one.T), f


def config(name: str, **kw) -> PipelineConfig:
    path = ROOT / "oct_bench" / "configs" / f"{name}.json"
    return PipelineConfig(**{**json.loads(path.read_text())["pipeline"], **kw})


def cell_volume(cfg, n, dev):
    from oct_bench import frames as bench_frames
    g = bench_frames.generator(3_000_000_019, dev)
    raw = bench_frames.sample_frames(cfg, n, g, dev)
    bg = torch.clamp_min(preprocess(bench_frames.background_frames(cfg, 1, g, dev)[0], cfg), 1.0)
    return raw, bg, torch.rand(bg.shape, generator=g, device=dev) * 4.0


@pytest.mark.cuda
@pytest.mark.parametrize("name,route,wrapper", [
    ("flagship-2048-u8", "bf16", "cscan_volume_mags"),
    ("flir-spinjnt-720-u16", "f32", "split_spectrum_mags")])
def test_cuda_volume_takes_its_kernel_once_and_matches_the_chain(cuda, name, route, wrapper):
    """Scaled-down volumes (8 frames) of the C-scan cells' configurations:
    the route, one launch a volume and no other, the volume of the chain
    within its precision's tolerance; at 'highest' bit for bit
    split_spectrum_mags of the ratio."""
    cfg = config(name)
    calib = Calibration.create(cfg, cuda)
    raw, bg, pi = cell_volume(cfg, 8, cuda)
    assert cscan_kernel_route(raw, calib, cfg) == route
    from fdoct_tpu_torch.ops import kernels
    kernels.reset_launches()
    got = sharded_cscan_volume(raw, bg, pi, calib, cfg)
    torch.cuda.synchronize()
    assert {k: v for k, v in LAUNCHES.items() if v} == {wrapper: 1}
    yr = apodize_ratio(preprocess(raw, cfg), bg, pi, cfg)
    want = ascan_mags(yr, calib, "fused", cfg.matmul_precision).transpose(-1, -2)
    tol = TOL if route == "bf16" else chip_smoke.TOL["f32"]
    torch.testing.assert_close(got, want, rtol=tol, atol=tol * float(want.max()))
    if route == "f32":
        mags = split_spectrum_mags(yr.contiguous(), calib.op_re, calib.op_im, calib.op_tf32)
        assert torch.equal(got, mags.transpose(-1, -2).contiguous())
    else:
        assert torch.equal(got, cscan_volume_mags(raw, pi, 1.0 / bg, calib.op_re_bf16,
                                                  calib.op_im_bf16))
