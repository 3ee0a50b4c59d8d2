"""The f32-operator instances' warp-specialised 3xTF32 schedule (namespace
ws32 of ``csrc/fused_recon.cu``), the K-major TF32 table it reads and the
rule that chooses it.

On the CPU: :func:`ops.kernels.pack_tf32_operator` against ``split_tf32`` of
the transposed operator, bit for bit; ``Calibration`` carrying that table
for a float32 M (from ``create`` and from the JAX package's leaves) and None
for a float64 one; :func:`ops.kernels.f32_schedule` against the C rule
(``ws32_applies``); the ring's stage count from the source's constants at
1, 8 and 40 frames; the wrappers' checks of ``op_tf32``; the plain versions
(which the wrappers run on CPU tensors, the table ignored) against the JAX
Pallas kernels in interpret mode; ``pipeline`` handing the calibration's
table to the wrappers, and a 'highest' ``reconstruct_group`` against the
JAX package.  On a GPU (cases marked ``cuda``): each f32 instance against
its plain version at TOL["f32"] and against the float64 product at
F64_TOL at the flagship, RESIDENT_RAGGED, every ``EDGE_SHAPES`` entry and
groups of 1, 3, 8 and 12 frames, the schedule it takes, and equal bit for
bit to its ``mma.sync`` form on the same values through a misaligned view.

Tolerances: TOL["f32"] (rtol 1e-4, atol 1e-4·max) is the float32 tolerance
of tests/test_torch_kernels.py (summation order); F64_TOL (rtol 5e-6, atol
5e-6·max) is chip_smoke.py's limit against the float64 product of the same
float32 ratio and operator, which float32-grade products pass and one TF32
product per multiply-add fails.
"""

import re

import numpy as np
import pytest
import torch

from fdoct_tpu_torch import pipeline as tp
from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.ops import _build
from fdoct_tpu_torch.ops.kernels import (
    EDGE_SHAPES, LAUNCHES, f32_schedule, fused_recon_accumulate,
    fused_recon_accumulate_reference, fused_recon_raw_accumulate,
    fused_recon_raw_accumulate_reference, pack_tf32_operator, split_tf32,
)

TOL = {"f32": 1e-4}
F64_TOL = 5e-6
FLAGSHIP = (8, 512, 2048, 512)
RESIDENT_RAGGED = (8, 70, 1040, 200)
#: the input rows of each f32 instance: its type and the n_in % that TMA's
#: 16-byte row strides need
INSTANCES = {"raw-u8": (torch.uint8, 16), "raw-u16": (torch.uint16, 8),
             "yr-f32": (torch.float32, 4)}
SMALL = dict(width=256, height=32, averages=4, numfftpoints=512, numdisplaypoints=128,
             lambdamin=816e-9, lambdamax=884e-9)
SOURCE = _build.PACKAGE_ROOT / "csrc" / "fused_recon.cu"


def operator(n_in, ndisp, seed=0, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    # magnitudes over many octaves, so that the split's rounding is exercised
    scale = np.exp(rng.normal(size=(2, n_in, ndisp)) * 4)
    op = torch.as_tensor(rng.normal(size=(2, n_in, ndisp)) * scale).to(dtype)
    return op[0].contiguous(), op[1].contiguous()


# --------------------------------------------------------------------------
# the table


@pytest.mark.parametrize("shape", [(2048, 512), (300, 77), (64, 8), (1, 1)],
                         ids=["flagship", "ragged", "small", "one"])
def test_pack_is_the_split_of_the_transposed_operator(shape):
    op_re, op_im = operator(*shape, seed=1)
    t = pack_tf32_operator(op_re, op_im)
    n_in, ndisp = shape
    assert t.shape == (2, 2, ndisp, n_in) and t.dtype == torch.float32 and t.is_contiguous()
    for j, op in enumerate((op_re, op_im)):
        hi, lo = split_tf32(op.T.contiguous())
        assert torch.equal(t[0, j].view(torch.int32), hi.view(torch.int32))
        assert torch.equal(t[1, j].view(torch.int32), lo.view(torch.int32))
        assert not (t[:, j].view(torch.int32) & 0x1FFF).any()          # TF32 bit patterns
        err = (op.T.double() - t[0, j].double() - t[1, j].double()).abs()
        assert (err <= op.T.abs().double() * 2.0 ** -21).all()


@pytest.mark.parametrize("bad,exc", [
    (lambda re, im: (re.double(), im.double()), TypeError),
    (lambda re, im: (re.to(torch.bfloat16), im.to(torch.bfloat16)), TypeError),
    (lambda re, im: (re, im[:-1]), ValueError),
    (lambda re, im: (re[0], im[0]), ValueError),
], ids=["float64", "bf16", "mismatched", "1-d"])
def test_pack_rejects(bad, exc):
    with pytest.raises(exc):
        pack_tf32_operator(*bad(*operator(16, 8)))


def test_calibration_carries_the_table():
    cfg = PipelineConfig(**SMALL)
    cal = Calibration.create(cfg, "cpu")
    assert cal.op_re.dtype == torch.float32
    assert torch.equal(cal.op_tf32, pack_tf32_operator(cal.op_re, cal.op_im))
    assert cal.op_tf32.shape == (2, 2, cal.ndisp, cal.n_raw)
    assert Calibration.create(cfg.replace(dtype="float64"), "cpu").op_tf32 is None
    assert Calibration.create(cfg, "cpu", torch.float64).op_tf32 is None


def test_calibration_from_jax_leaves_carries_the_table():
    pytest.importorskip("jax")
    from fdoct_tpu.calibration import Calibration as JaxCalibration
    from fdoct_tpu.config import PipelineConfig as JaxConfig

    leaves = ("op_re", "op_im", "window", "nearest_idx", "frac", "phase", "lambdas", "k",
              "klinear")
    jcfg = JaxConfig(**SMALL)
    jcal = JaxCalibration.create(jcfg)
    arrays = {n: np.asarray(getattr(jcal, n)) for n in leaves}
    tcfg = PipelineConfig(**SMALL)
    cal = Calibration.from_arrays(arrays, tcfg, "cpu")
    np.testing.assert_array_equal(cal.op_re.numpy(), np.asarray(jcal.op_re))
    assert torch.equal(cal.op_tf32, pack_tf32_operator(cal.op_re, cal.op_im))
    assert Calibration.from_arrays(arrays, tcfg, "cpu", torch.float64).op_tf32 is None


# --------------------------------------------------------------------------
# the rule


@pytest.mark.parametrize("instance", list(INSTANCES))
@pytest.mark.parametrize("n_in,ndisp,ptrs,want", [
    (2048, 512, (0, 256, 512, 1024), "wgmma"),           # the flagship
    (720, 360, (0,) * 4, "wgmma"),                       # the FLIR shape
    (1040, 200, (0,) * 4, "wgmma"),                      # RESIDENT_RAGGED
    (16, 8, (0,) * 4, "wgmma"),                          # the least strides every type takes
    (2048, 100, (0,) * 4, "wgmma"),                      # ndisp enters no rule: the table is K-major
    (2048, 4, (0,) * 4, "wgmma"),
    (2048, 512, (0, 8, 0, 0), "mma.sync"),               # the table's base off 16 B
    (2048, 512, (0, 4, 0, 0), "mma.sync"),
    (2048, 512, (1, 0, 0, 0), "mma.sync"),               # the input rows' base off 16 B
    (2048, 512, (0, 0, 4, 0), "mma.sync"),               # pi_frame's
    (2048, 512, (0, 0, 0, 8), "mma.sync"),               # inv_background's
], ids=["flagship", "flir", "resident-ragged", "least", "ndisp-100", "ndisp-4", "table-off",
        "table-off4", "x-off", "pi-off", "inv-off"])
def test_schedule_follows_the_tma_rule(instance, n_in, ndisp, ptrs, want):
    dtype, _ = INSTANCES[instance]
    assert f32_schedule(dtype, n_in, ndisp, ptrs) == want


@pytest.mark.parametrize("instance", list(INSTANCES))
def test_row_strides_per_input_type(instance):
    """n_in must make an input row and a row of the table a whole number of
    16-byte units: 16 u8 samples, 8 u16 or 4 f32 (the table's 4 f32 follow
    from each)."""
    dtype, per_16 = INSTANCES[instance]
    for n_in in range(1, 20 * per_16 + 1):
        want = "wgmma" if n_in % per_16 == 0 else "mma.sync"
        assert f32_schedule(dtype, n_in, 512, (0,) * 4) == want, n_in
    assert (f32_schedule(dtype, 300, 77, (0,) * 4) == "wgmma") == (dtype == torch.float32)


def _body(text: str, head: str) -> str:
    body = text[text.index(head):]
    return body[:body.index("\n}\n")]


def test_rule_mirrors_the_c_source():
    """f32_schedule's conditions are ws32_applies' and launch_f32 asks it
    before the launch."""
    text = SOURCE.read_text()
    body = _body(text, "bool ws32_applies(")
    assert "n_in % (16 / static_cast<int>(sizeof(In))) == 0 && n_in % 4 == 0" in body
    for name in ("x", "op_tf32"):
        assert f"aligned({name})" in body
    assert "(!ws::raw<In>() || (aligned(pi) && aligned(inv_bg)))" in body
    assert "ndisp" not in body.split("{", 1)[1]
    dispatch = _body(text, "int launch_f32(")
    assert dispatch.index("ws32_applies<In>(") < dispatch.index("launch_ws32<In>(")


@pytest.mark.parametrize("instance", list(INSTANCES))
def test_a_view_one_element_off_takes_mma_sync(instance):
    dtype, _ = INSTANCES[instance]
    x = torch.zeros((2, 4, 64), dtype=dtype)
    table = pack_tf32_operator(*operator(64, 16))
    flat = torch.zeros(x.numel() + 1, dtype=dtype)
    shifted = flat[1:].view(x.shape)
    assert f32_schedule(dtype, 64, 16, [x.data_ptr(), table.data_ptr()]) == "wgmma"
    assert f32_schedule(dtype, 64, 16, [shifted.data_ptr(), table.data_ptr()]) == "mma.sync"


# --------------------------------------------------------------------------
# the ring, from the source's constants


def _constants(ns: str) -> dict:
    text = SOURCE.read_text()
    body = text[text.index(f"namespace {ns} {{"):text.index(f"}}  // namespace {ns}")]
    return {name: int(value) for name, value in re.findall(r"constexpr int (\w+) = (\d+);", body)}


def ws32_stages(dtype: torch.dtype, B: int) -> tuple[int, int]:
    """(stages, shared-memory bytes) of a launch, as launch_ws32 computes
    them: F = 8 frames in flight whatever B is, R = BM / F rows; a stage
    holds the hi and lo table boxes (KT samples x re and im of BN depths),
    the input rows and (raw frames) pi and inv_background; A lives in
    registers."""
    ws, c = _constants("ws"), _constants("ws32")
    esize = torch.empty((), dtype=dtype).element_size()
    R = c["BM"] >> ws["FS"]
    table = 2 * c["KT"] * 2 * c["BN"] * 4
    stage = table + c["BM"] * c["KT"] * esize + (2 * R * c["KT"] * 4 if dtype != torch.float32
                                                 else 0)
    extra = 1024 + 2 * ws["MAX_STAGES"] * 8
    nst = min(ws["MAX_STAGES"], (ws["SMEM_LIMIT"] - extra) // stage)
    return nst, nst * stage + extra


def test_ring_constants_match_the_source():
    c = _constants("ws32")
    assert (c["BM"], c["BN"], c["KT"]) == (128, 64, 32) and "A_TILES" not in c
    text = SOURCE.read_text()
    assert "constexpr int OP_BOX = KT * 2 * BN * 4;" in text
    assert "constexpr int OP_BYTES = 2 * OP_BOX;" in text
    assert "constexpr int fs = ws::FS, R = ws32::BM >> fs;" in text
    body = _body(text, "fused_recon_ws32_kernel(")
    assert "named_barrier_sync" not in body and "fence_proxy_async" not in body
    assert body.count("wgmma_m64n128k8_tf32_rs(part, ") == 3
    # 32 f32 samples make one 128-byte swizzle row, a k8 step 32 bytes
    assert c["KT"] * 4 == 128


@pytest.mark.parametrize("instance", list(INSTANCES))
@pytest.mark.parametrize("B", [1, 8, 40])
def test_at_least_two_stages_fit(instance, B):
    dtype, _ = INSTANCES[instance]
    nst, smem = ws32_stages(dtype, B)
    assert 2 <= nst <= 4 and smem <= 232448, (nst, smem)


def test_flagship_stage_counts():
    """Four stages of 40 KiB for u8 frames, 44 KiB for u16 and 48 KiB for an
    f32 ratio (the ring's most)."""
    assert ws32_stages(torch.uint8, 8) == (4, 4 * 40960 + 1088)
    assert ws32_stages(torch.uint16, 8) == (4, 4 * 45056 + 1088)
    assert ws32_stages(torch.float32, 8) == (4, 4 * 49152 + 1088)


# --------------------------------------------------------------------------
# the wrappers' checks of op_tf32


def _problem(shape=(3, 16, 64, 32), seed=0):
    B, rows, n_in, ndisp = shape
    rng = np.random.default_rng(seed)
    t = {"raw-u8": torch.as_tensor(rng.integers(0, 255, (B, rows, n_in)).astype(np.uint8)),
         "raw-u16": torch.as_tensor(rng.integers(0, 65536, (B, rows, n_in)).astype(np.uint16)),
         "yr-f32": torch.as_tensor(rng.normal(size=(B, rows, n_in)).astype(np.float32)),
         "pi": torch.as_tensor(rng.uniform(0, 50, (rows, n_in)).astype(np.float32)),
         "inv": torch.as_tensor((1.0 / rng.uniform(50, 200, (rows, n_in))).astype(np.float32))}
    t["mr"], t["mi"] = operator(n_in, ndisp, seed)
    t["tf32"] = pack_tf32_operator(t["mr"], t["mi"])
    return t


def _run(t, instance, table=None, kernel=True, op=None):
    op = (t["mr"], t["mi"]) if op is None else op
    if instance == "yr-f32":
        if not kernel:
            return fused_recon_accumulate_reference(t[instance], *op)
        return fused_recon_accumulate(t[instance], *op, op_tf32=table)
    if not kernel:
        return fused_recon_raw_accumulate_reference(t[instance], t["pi"], t["inv"], *op)
    return fused_recon_raw_accumulate(t[instance], t["pi"], t["inv"], *op, op_tf32=table)


@pytest.mark.parametrize("instance", list(INSTANCES))
@pytest.mark.parametrize("bad,exc,match", [
    (lambda t: t[:, :, :, :-1].contiguous(), ValueError, "op_tf32 must be a contiguous"),
    (lambda t: t[0], ValueError, "op_tf32 must be a contiguous"),
    (lambda t: t.transpose(2, 3).contiguous(), ValueError, "op_tf32 must be a contiguous"),
    (lambda t: t.double(), TypeError, "op_tf32 must be float32"),
    (lambda t: t.to(torch.bfloat16), TypeError, "op_tf32 must be float32"),
    (lambda t: t.to("meta"), ValueError, "on cpu"),
    (lambda t: t.transpose(0, 1), ValueError, "op_tf32 must be a contiguous"),
], ids=["misshapen", "one-part", "n-major", "float64", "bf16", "off-device", "non-contiguous"])
def test_wrappers_reject_a_bad_table(instance, bad, exc, match):
    t = _problem()
    table = bad(t["tf32"])
    if match == "op_tf32 must be a contiguous" and table.shape == t["tf32"].shape:
        assert not table.is_contiguous()
    with pytest.raises(exc, match=match):
        _run(t, instance, table)


@pytest.mark.parametrize("instance", list(INSTANCES))
def test_wrappers_reject_a_table_beside_a_bf16_operator(instance):
    t = _problem()
    op = (t["mr"].to(torch.bfloat16), t["mi"].to(torch.bfloat16))
    with pytest.raises(TypeError, match="op_tf32 goes with a float32 operator"):
        _run(t, instance, t["tf32"], op=op)


@pytest.mark.parametrize("instance", list(INSTANCES))
@pytest.mark.parametrize("shape", [(3, 16, 64, 32), (3, 10, 30, 7)], ids=["tiled", "ragged"])
def test_cpu_wrappers_ignore_the_table(instance, shape):
    """On CPU tensors the wrappers run the plain version, table or none, and
    count no launch."""
    t = _problem(shape, seed=2)
    before = dict(LAUNCHES)
    want = _run(t, instance, kernel=False)
    assert torch.equal(_run(t, instance, t["tf32"]), want)
    assert torch.equal(_run(t, instance), want)
    assert LAUNCHES == before


# --------------------------------------------------------------------------
# against the JAX package


@pytest.fixture
def pallas():
    jnp = pytest.importorskip("jax.numpy")
    from fdoct_tpu.ops import pallas_kernels
    return jnp, pallas_kernels


@pytest.mark.parametrize("instance", list(INSTANCES))
@pytest.mark.parametrize("shape", [(3, 16, 64, 32), (3, 10, 30, 7)], ids=["tiled", "ragged"])
def test_plain_with_table_matches_pallas_kernel(pallas, shape, instance):
    """The wrapper given the table on the CPU against the TPU kernel in
    interpret mode (tests/test_pallas.py's way), at the float32 tolerance."""
    jnp, pk = pallas
    t = _problem(shape, seed=3)
    _, rows, _, ndisp = shape
    tiles = dict(tile_rows=8 if rows % 8 == 0 else rows,
                 tile_depth=16 if ndisp % 16 == 0 else ndisp)
    mr, mi = jnp.asarray(t["mr"].numpy()), jnp.asarray(t["mi"].numpy())
    if instance == "yr-f32":
        want = pk.fused_recon_accumulate(jnp.asarray(t[instance].numpy()), mr, mi,
                                         interpret=True, **tiles)
    else:
        want = pk.fused_recon_raw_accumulate(
            jnp.asarray(t[instance].numpy()), jnp.asarray(t["pi"].numpy()),
            jnp.asarray(t["inv"].numpy()), mr, mi, interpret=True, **tiles)
    want = np.asarray(want)
    got = _run(t, instance, t["tf32"]).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL["f32"], atol=TOL["f32"] * np.abs(want).max())


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_pipeline_hands_the_calibrations_table(monkeypatch, bf16):
    """The group step's wrappers get the Calibration's table itself (so no
    session, graph, mesh or bench route packs it per call) with M, and no
    table with the bfloat16 operator."""
    cfg = PipelineConfig(**SMALL, matmul_precision="bf16" if bf16 else "highest")
    cal = Calibration.create(cfg, "cpu")
    seen = []

    def spy(name, real):
        def fn(*args):
            seen.append((name, args[-3], args[-1]))
            return real(*args)
        return fn

    monkeypatch.setattr(tp, "fused_recon_raw_accumulate",
                        spy("raw", tp.fused_recon_raw_accumulate))
    monkeypatch.setattr(tp, "fused_recon_accumulate", spy("yr", tp.fused_recon_accumulate))
    rng = np.random.default_rng(5)
    raw = torch.as_tensor(rng.integers(0, 255, (2, cfg.height, cfg.width)).astype(np.uint8))
    bg = torch.full((cfg.height, cfg.width), 100.0)
    pi = torch.full((cfg.height, cfg.width), 20.0)
    tp.reconstruct_group(raw, bg, pi, cal, cfg)
    tp.ratio_group_sum(torch.rand(2, cfg.height, cfg.width), cal, cfg)
    assert [s[0] for s in seen] == ["raw", "yr"]
    for _, op_re, table in seen:
        if bf16:
            assert op_re is cal.op_re_bf16 and table is None
        else:
            assert op_re is cal.op_re and table is cal.op_tf32


def test_highest_group_matches_jax():
    """A 'highest' float32 group on the CPU against the JAX package's
    per-frame sum on the same M, at the float32 tolerance."""
    jnp = pytest.importorskip("jax.numpy")
    from fdoct_tpu import pipeline as jp
    from fdoct_tpu.calibration import Calibration as JaxCalibration
    from fdoct_tpu.config import PipelineConfig as JaxConfig

    jcfg = JaxConfig(**SMALL, matmul_precision="highest")
    jcal = JaxCalibration.create(jcfg)
    leaves = ("op_re", "op_im", "window", "nearest_idx", "frac", "phase", "lambdas", "k",
              "klinear")
    tcfg = PipelineConfig(**SMALL, matmul_precision="highest")
    tcal = Calibration.from_arrays({n: np.asarray(getattr(jcal, n)) for n in leaves}, tcfg, "cpu")
    rng = np.random.default_rng(6)
    raw = rng.integers(0, 255, (4, jcfg.height, jcfg.width)).astype(np.uint8)
    bg = rng.uniform(50, 200, (jcfg.height, jcfg.width)).astype(np.float32)
    pi = rng.uniform(0, 50, (jcfg.height, jcfg.width)).astype(np.float32)
    want = np.asarray(jp.reconstruct(jnp.asarray(raw), jnp.asarray(bg), jnp.asarray(pi), jcal,
                                     jcfg, method="fused")).sum(0)
    got = tp.reconstruct_group(torch.as_tensor(raw), torch.as_tensor(bg), torch.as_tensor(pi),
                               tcal, tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL["f32"], atol=TOL["f32"] * np.abs(want).max())


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def card_problem(shape, seed, dev):
    """u8 and u16 frames, an f32 ratio, pi, inv_background, an f32 operator
    and its table, of shape (B, rows, n_in, ndisp), drawn with numpy."""
    B, rows, n_in, ndisp = shape
    rng = np.random.default_rng(seed)
    t = {"raw-u8": rng.integers(0, 255, (B, rows, n_in)).astype(np.uint8),
         "raw-u16": (rng.integers(0, 4096, (B, rows, n_in)) << 4).astype(np.uint16),
         "yr-f32": rng.normal(size=(B, rows, n_in)).astype(np.float32),
         "pi": rng.uniform(0, 50, (rows, n_in)).astype(np.float32),
         "inv": (1.0 / rng.uniform(50, 200, (rows, n_in))).astype(np.float32),
         "mr": rng.normal(size=(n_in, ndisp)).astype(np.float32),
         "mi": rng.normal(size=(n_in, ndisp)).astype(np.float32)}
    t = {k: torch.as_tensor(v).to(dev) for k, v in t.items()}
    t["tf32"] = pack_tf32_operator(t["mr"], t["mi"])
    return t


def schedule(t, instance, x=None):
    x = t[instance] if x is None else x
    ptrs = [x.data_ptr(), t["tf32"].data_ptr()]
    if instance != "yr-f32":
        ptrs += [t["pi"].data_ptr(), t["inv"].data_ptr()]
    return f32_schedule(x.dtype, x.shape[-1], t["mr"].shape[1], ptrs)


def misaligned(x):
    """The same values through a view one element past an aligned buffer."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.flatten()
    return flat[1:].view(x.shape)


def run_on(t, instance, x):
    if instance == "yr-f32":
        return fused_recon_accumulate(x, t["mr"], t["mi"], op_tf32=t["tf32"])
    return fused_recon_raw_accumulate(x, t["pi"], t["inv"], t["mr"], t["mi"], op_tf32=t["tf32"])


def assert_f32_grade(got, t, instance):
    """Against the plain version at TOL["f32"] and the float64 product of
    the same float32 ratio at F64_TOL."""
    want = _run(t, instance, kernel=False)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=TOL["f32"],
                               atol=TOL["f32"] * float(want.abs().max()))
    x = t[instance] if instance == "yr-f32" else (t[instance].float() - t["pi"]) * t["inv"]
    x = x.double()
    re, im = x @ t["mr"].double(), x @ t["mi"].double()
    want64 = torch.sqrt(re * re + im * im).sum(0)
    np.testing.assert_allclose(got.double().cpu().numpy(), want64.cpu().numpy(), rtol=F64_TOL,
                               atol=F64_TOL * float(want64.abs().max()))


CUDA_SHAPES = {"flagship": FLAGSHIP, "resident-ragged": RESIDENT_RAGGED, **EDGE_SHAPES}


@pytest.mark.cuda
@pytest.mark.parametrize("instance", list(INSTANCES))
@pytest.mark.parametrize("shape", list(CUDA_SHAPES.values()), ids=list(CUDA_SHAPES))
def test_cuda_instance_is_f32_grade(cuda, shape, instance):
    t = card_problem(shape, 31, cuda)
    if shape in (FLAGSHIP, RESIDENT_RAGGED):
        assert schedule(t, instance) == "wgmma"
    key = "fused_recon_accumulate" if instance == "yr-f32" else "fused_recon_raw_accumulate"
    before = LAUNCHES[key]
    got = run_on(t, instance, t[instance])
    torch.cuda.synchronize()
    assert LAUNCHES[key] == before + 1
    assert_f32_grade(got, t, instance)


@pytest.mark.cuda
@pytest.mark.parametrize("instance", list(INSTANCES))
@pytest.mark.parametrize("shape", [FLAGSHIP, RESIDENT_RAGGED, (1, 70, 1040, 200),
                                   (3, 70, 1040, 200), (12, 70, 1040, 200)],
                         ids=["flagship", "resident-ragged", "B1", "B3", "B12"])
def test_cuda_wgmma_equals_mma_sync_bit_for_bit(cuda, shape, instance):
    """The warp-specialised 3xTF32 schedule and the mma.sync one on the same
    values (the second through a misaligned view): the same sums, bit for
    bit."""
    t = card_problem(shape, 32, cuda)
    x = misaligned(t[instance])
    assert schedule(t, instance) == "wgmma" and schedule(t, instance, x) == "mma.sync"
    got, want = run_on(t, instance, t[instance]), run_on(t, instance, x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("instance", list(INSTANCES))
@pytest.mark.parametrize("B", [1, 3, 8, 12])
def test_cuda_frames_per_group(cuda, B, instance):
    t = card_problem((B, 48, 2048, 512), 33 + B, cuda)
    assert schedule(t, instance) == "wgmma"
    got = run_on(t, instance, t[instance])
    assert_f32_grade(got, t, instance)
    assert torch.equal(got, run_on(t, instance, misaligned(t[instance])))


@pytest.mark.cuda
def test_cuda_wrapper_packs_when_given_no_table(cuda):
    """A direct caller without a table gets the same sums (the wrapper packs
    one for the call)."""
    t = card_problem((8, 64, 2048, 512), 37, cuda)
    for instance in INSTANCES:
        with_table = run_on(t, instance, t[instance])
        without = _run(t, instance, None)
        torch.cuda.synchronize()
        assert torch.equal(with_table, without)


def test_the_trace_edits_apply_to_both_schedules(tmp_path):
    """ws_trace.py's text edits each find their anchor once, in the bf16
    and in the 3xTF32 stage loop, and the shipped source holds no trace."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("ws_trace", _build.PACKAGE_ROOT.parent /
                                                  "ws_trace.py")
    ws_trace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ws_trace)
    traced = (ws_trace.make(tmp_path) / "fdoct_tpu_torch" / "csrc" / "fused_recon.cu").read_text()
    for kernel in ("fused_recon_ws_kernel(", "fused_recon_ws32_kernel("):
        body = traced[traced.index(kernel):]
        body = body[:body.index("\n}\n")]
        assert "WS_TRACE_START;" in body and "WS_TRACE_END(total);" in body, kernel
        assert body.count("WS_MARK(4)") == 1 and body.count("WS_MARK(0)") == 1, kernel
    assert "clock64" not in SOURCE.read_text()

