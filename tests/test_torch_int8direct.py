"""The port's int8-direct path (``fdoct_tpu_torch.int8direct`` and the kernel
``int8_bscan_display_fused``) against ``fdoct_tpu.int8direct`` on the same
numpy inputs, at the size of tests/test_int8direct.py's fixture (32 × 256 →
160 depths, 4 frames, a non-rank-1 background).

Tolerances: the host parts (rank-1 factor, bias shifts, int8 tables) are
exact; float32 tables rtol 1e-6 (float64 sums in another order); magnitudes
rtol 1e-5, atol 1e-5·max (float32 re/im cancel near zero); dB rtol 1e-5,
atol 1e-4 and uint8 within one level, as tests/test_int8direct.py holds the
Pallas kernel against the XLA chain.  Cases marked ``cuda`` hold the kernel
against its plain version on a GPU and skip without one.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from fdoct_tpu_torch import int8direct as ti
from fdoct_tpu_torch import pipeline as tpl
from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.ops import kernels
from fdoct_tpu_torch.ops.kernels import (
    INT8_K_TILE, INT8_TILE, LAUNCHES, int8_bscan_display_fused,
    int8_bscan_display_fused_reference, int8_matmul, pack_int8_operator,
)
from fdoct_tpu_torch.sources.synthetic import SyntheticSource

CAL_LEAVES = ("op_re", "op_im", "window", "nearest_idx", "frac", "phase", "lambdas", "k",
              "klinear")
PLAN_LEAVES = ("oq_re", "oq_im", "s_re", "s_im", "row_gain_inv", "const_re", "const_im",
               "bg_rank1_resid", "oq2_re", "oq2_im", "s2_re", "s2_im", "row_gain2")
KERNEL_SHAPES = {"tiled": (3, 64, 128, 64), "ragged": (3, 100, 300, 77)}
#: the s8 tensor-core kernel's edges (B, rows, n_in, ndisp): rows not a
#: multiple of a block's rows, n_in not a multiple of 16 (byte staging) or
#: of the 64-sample stage, ndisp not a multiple of 8, and 1 to 40 frames
EDGE_SHAPES = {"rows-ragged": (8, 70, 300, 100), "k-tail": (8, 37, 48, 80),
               "one-frame": (1, 65, 64, 64), "forty-frames": (40, 9, 96, 24),
               "three-frames": (3, 20, 100, 13), "two-frames": (2, 130, 512, 136)}


@pytest.fixture(scope="module")
def jx():
    """The JAX package, imported here so that the cuda cases below can run
    where JAX is not installed (``--noconftest -m cuda``)."""
    import jax.numpy as jnp
    from fdoct_tpu import int8direct, pipeline
    from fdoct_tpu.calibration import Calibration as JaxCalibration
    from fdoct_tpu.config import PipelineConfig as JaxConfig
    from fdoct_tpu.ops.pallas_kernels import int8_bscan_display_fused
    return types.SimpleNamespace(jnp=jnp, ji=int8direct, jpl=pipeline,
                                 JaxCalibration=JaxCalibration, JaxConfig=JaxConfig,
                                 pallas_int8_bscan=int8_bscan_display_fused)


@pytest.fixture(scope="module")
def data(jx):
    """tests/test_int8direct.py's fixture: frames, a non-rank-1 background
    (per-row gain and 0.3 % noise) and π, with both packages' configs and
    one operator M (the JAX calibration's leaves)."""
    jcfg = jx.JaxConfig(width=256, height=32, averages=4, numfftpoints=512,
                        numdisplaypoints=160, lambdamin=816e-9, lambdamax=884e-9,
                        dtype="float32", compat=True, matmul_precision="int8_direct")
    src = SyntheticSource(height=32, width=256, depths_um=(40.0, 80.0),
                          reflectivities=(0.5, 0.3), noise=0.01, seed=9)
    it = iter(src.frames())
    frames = np.stack([next(it) for _ in range(4)]).astype(np.uint8)
    rng = np.random.default_rng(3)
    bg = np.maximum(src.background().astype(np.float64), 1.0)
    bg = bg * (1.0 + 0.04 * np.sin(np.linspace(0, 3, 32)))[:, None]
    bg = bg * (1.0 + 0.003 * rng.standard_normal(bg.shape))
    pi = rng.uniform(0.0, 8.0, bg.shape)
    tcfg = PipelineConfig(**dataclasses.asdict(jcfg))
    jcal = jx.JaxCalibration.create(jcfg)
    tcal = Calibration.from_arrays({n: np.asarray(getattr(jcal, n)) for n in CAL_LEAVES},
                                   tcfg, "cpu")
    return dict(ji=jx.ji, jcfg=jcfg, tcfg=tcfg, jcal=jcal, tcal=tcal, frames=frames,
                bg=bg, pi=pi)


def plan_arrays(jplan):
    return {n: None if getattr(jplan, n) is None else np.array(getattr(jplan, n))
            for n in PLAN_LEAVES}


def plans(d, **kw):
    """The JAX plan and the port's, built from the same M."""
    return (d["ji"].Int8DirectPlan.create(d["jcal"], d["jcfg"], d["bg"], d["pi"], **kw),
            ti.Int8DirectPlan.create(d["tcal"], d["tcfg"], d["bg"], d["pi"], **kw))


def assert_plans_match(jplan, tplan):
    for name in PLAN_LEAVES:
        want, got = getattr(jplan, name), getattr(tplan, name)
        if want is None:
            assert got is None, name
            continue
        want, got = np.asarray(want), got.numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        if want.dtype == np.int8:
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=name)
    assert (tplan.oph, tplan.opw, tplan.ndisp) == (jplan.oph, jplan.opw, jplan.ndisp)


def assert_db_close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def assert_u8_close(got, want):
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


# --------------------------------------------------------------------------
# host part


@pytest.mark.parametrize("kind", ["fixture", "random"])
def test_rank1_factor_matches_jax(jx, data, kind):
    bg = data["bg"] if kind == "fixture" else np.random.default_rng(0).uniform(1, 9, (8, 32))
    for want, got in zip(jx.ji.rank1_factor(bg), ti.rank1_factor(bg)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_bias_shifts_are_exact(jx):
    raw = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(ti.to_s8(raw), jx.ji.to_s8(raw))
    got = ti.shift_u8_to_s8(torch.as_tensor(raw))
    assert got.dtype == torch.int8
    want = np.asarray(jx.ji.shift_u8_to_s8(jx.jnp.asarray(raw)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy().astype(int), raw.astype(int) - 128)


def test_bias_shifts_reject_wider_counts():
    with pytest.raises(TypeError, match="uint8"):
        ti.to_s8(np.zeros((2, 2), np.uint16))
    with pytest.raises(TypeError, match="uint8"):
        ti.shift_u8_to_s8(torch.zeros(2, 2, dtype=torch.int16))


@pytest.mark.parametrize("kw", [{}, dict(bpp=16), dict(mediann=3), dict(movavgn=2),
                                dict(binvalue=2), dict(binvaluey=2),
                                dict(rowwisenormalize=True), dict(donotnormalize=False)],
                         ids=["flagship", "bpp16", "median", "movavg", "bin", "biny",
                              "rownorm", "normalize"])
def test_int8_direct_supported_matches_jax(jx, kw):
    jcfg = jx.JaxConfig(width=256, height=32, matmul_precision="int8_direct", **kw)
    assert ti.int8_direct_supported(PipelineConfig(**dataclasses.asdict(jcfg))) \
        == jx.ji.int8_direct_supported(jcfg)


@pytest.mark.parametrize("kw", [dict(rank=1), dict(rank=2), dict(dark=True)],
                         ids=["rank1", "rank2", "dark"])
def test_plan_create_matches_jax(data, kw):
    kw = dict(kw)
    if kw.pop("dark", False):
        kw["dark_frame"] = np.random.default_rng(7).uniform(0.0, 6.0, data["bg"].shape)
    jplan, tplan = plans(data, **kw)
    assert_plans_match(jplan, tplan)
    assert tplan.oq_re.device.type == "cpu"


def test_plan_is_built_from_the_working_dtype_operator(data):
    """The plan folds the calibration's float32 M upcast to float64, as the
    JAX package does: the port's own float32 calibration gives the JAX
    plan's integers."""
    own = Calibration.create(data["tcfg"], "cpu")
    assert own.op_re.dtype == torch.float32
    jplan, _ = plans(data)
    tplan = ti.Int8DirectPlan.create(own, data["tcfg"], data["bg"], data["pi"])
    for name in ("oq_re", "oq_im"):
        np.testing.assert_array_equal(getattr(tplan, name).numpy(),
                                      np.asarray(getattr(jplan, name)))


def test_plan_create_rejects_unsupported(data):
    cfg = data["tcfg"].replace(mediann=3)
    with pytest.raises(ValueError, match="median"):
        ti.Int8DirectPlan.create(data["tcal"], cfg, data["bg"], data["pi"])
    with pytest.raises(ValueError, match="rank"):
        ti.Int8DirectPlan.create(data["tcal"], data["tcfg"], data["bg"], data["pi"], rank=3)


@pytest.mark.parametrize("rank", [1, 2])
def test_plan_from_arrays_round_trips_jax_leaves(data, rank):
    jplan, _ = plans(data, rank=rank)
    arrays = plan_arrays(jplan)
    tplan = ti.Int8DirectPlan.from_arrays(arrays, "cpu")
    for name, want in arrays.items():
        if want is None:
            assert getattr(tplan, name) is None
        else:
            np.testing.assert_array_equal(getattr(tplan, name).numpy(), want)


@pytest.mark.parametrize("n_in,ndisp", [(300, 77), (64, 5), (1, 9), (65, 160), (128, 64)])
def test_pack_int8_operator_is_a_padded_transpose(n_in, ndisp):
    rng = np.random.default_rng(n_in)
    re, im = (rng.integers(-127, 128, (n_in, ndisp)).astype(np.int8) for _ in range(2))
    got = pack_int8_operator(torch.as_tensor(re), torch.as_tensor(im))
    pad = -(-n_in // INT8_K_TILE) * INT8_K_TILE
    assert got.dtype == torch.int8 and got.shape == (2, ndisp, pad) and got.is_contiguous()
    want = np.zeros((2, ndisp, pad), np.int8)
    want[0, :, :n_in], want[1, :, :n_in] = re.T, im.T
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[:, :, n_in:].any()


def test_pack_int8_operator_rejects():
    q = torch.zeros(4, 6, dtype=torch.int8)
    with pytest.raises(TypeError, match="int8"):
        pack_int8_operator(q.float(), q)
    with pytest.raises(ValueError, match="operator shapes"):
        pack_int8_operator(q, q[:, :5])


@pytest.mark.parametrize("how", ["create-rank1", "create-rank2", "from_arrays"])
def test_plan_carries_the_packed_operator(data, how):
    """create and from_arrays both pack (oq_re, oq_im) K-major, once."""
    jplan, tplan = plans(data, rank=2 if how == "create-rank2" else 1)
    if how == "from_arrays":
        tplan = ti.Int8DirectPlan.from_arrays(plan_arrays(jplan), "cpu")
    want = pack_int8_operator(torch.as_tensor(np.array(jplan.oq_re)),
                              torch.as_tensor(np.array(jplan.oq_im)))
    assert tplan.oq_packed is not None and tplan.oq_packed.device.type == "cpu"
    np.testing.assert_array_equal(tplan.oq_packed.numpy(), want.numpy())
    assert "oq_packed" not in PLAN_LEAVES


@pytest.mark.parametrize("with_linear", [False, True], ids=["no-linear", "linear"])
@pytest.mark.parametrize("shape", list(KERNEL_SHAPES.values()), ids=list(KERNEL_SHAPES))
def test_int8_wrapper_same_with_packed_operator(shape, with_linear):
    args = _kernel_args(shape)
    packed = pack_int8_operator(args[1], args[2])
    plain = int8_bscan_display_fused(*args, -30.0, shape[0], with_linear=with_linear)
    given = int8_bscan_display_fused(*args, -30.0, shape[0], with_linear=with_linear,
                                     oq_packed=packed)
    for name in plain._fields:
        a, b = getattr(plain, name), getattr(given, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=name)


@pytest.mark.parametrize("bad", ["shape", "dtype", "strided"])
def test_int8_wrapper_rejects_a_wrong_packed_operator(bad):
    args = _kernel_args()
    packed = pack_int8_operator(args[1], args[2])
    packed = {"shape": packed[:, :, :-INT8_K_TILE], "dtype": packed.to(torch.int16),
              "strided": packed.transpose(1, 2).contiguous().transpose(1, 2)}[bad]
    with pytest.raises(ValueError, match="oq_packed"):
        int8_bscan_display_fused(*args, -30.0, 3, oq_packed=packed)


# --------------------------------------------------------------------------
# device part


@pytest.mark.parametrize("rank", [1, 2])
def test_reconstruct_int8_direct_matches_jax(jx, data, rank):
    jplan, tplan = plans(data, rank=rank)
    s8 = jx.ji.to_s8(data["frames"])
    want = np.asarray(jx.ji.reconstruct_int8_direct(jx.jnp.asarray(s8), jplan))
    got = ti.reconstruct_int8_direct(torch.as_tensor(s8), tplan)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    one = ti.reconstruct_int8_direct(torch.as_tensor(s8[0]), tplan)  # one frame, 2-D
    np.testing.assert_array_equal(one.numpy(), got[0].numpy())


def random_kernel_args(shape, seed=0):
    """A random plan-shaped problem; the operator's scale makes dB values
    of a few tens."""
    B, rows, n_in, ndisp = shape
    rng = np.random.default_rng(seed)
    return dict(
        frames_s8=rng.integers(-128, 128, (B, rows, n_in)).astype(np.int8),
        oq_re=rng.integers(-127, 128, (n_in, ndisp)).astype(np.int8),
        oq_im=rng.integers(-127, 128, (n_in, ndisp)).astype(np.int8),
        s_re=rng.uniform(1e-4, 2e-4, ndisp).astype(np.float32),
        s_im=rng.uniform(1e-4, 2e-4, ndisp).astype(np.float32),
        row_gain=rng.uniform(0.5, 2.0, (rows, 1)).astype(np.float32),
        const_re=rng.normal(0, 0.5, (rows, ndisp)).astype(np.float32),
        const_im=rng.normal(0, 0.5, (rows, ndisp)).astype(np.float32),
    )


def fixture_kernel_args(data):
    jplan, _ = plans(data)
    a = plan_arrays(jplan)
    return dict(frames_s8=ti.to_s8(data["frames"]), oq_re=a["oq_re"], oq_im=a["oq_im"],
                s_re=a["s_re"], s_im=a["s_im"], row_gain=a["row_gain_inv"],
                const_re=a["const_re"], const_im=a["const_im"])


@pytest.mark.parametrize("thresh", [-30.0, -np.inf, 5.0, -0.0])
@pytest.mark.parametrize("problem", ["fixture", "ragged"])
def test_kernel_plain_matches_pallas_kernel(jx, data, problem, thresh):
    """The plain version against the Pallas kernel in interpret mode (as
    tests/test_int8direct.py:276-297 runs it): dB and the global min/max."""
    args = (fixture_kernel_args(data) if problem == "fixture"
            else random_kernel_args((3, 10, 30, 7)))
    B = args["frames_s8"].shape[0]
    j = {k: jx.jnp.asarray(v) for k, v in args.items()}
    db, mn, mx = jx.pallas_int8_bscan(
        j["frames_s8"], j["oq_re"], j["oq_im"], j["s_re"], j["s_im"], j["row_gain"],
        j["const_re"], j["const_im"], jx.jnp.asarray(thresh, jx.jnp.float32), averages=B,
        eps=1e-5, denom=2.303, interpret=True)
    got = int8_bscan_display_fused(*(torch.as_tensor(v) for v in args.values()),
                                   thresh, B, eps=1e-5, denom=2.303)
    assert got.db.shape == db.shape and got.linear is None
    assert_db_close(got.db.numpy(), np.asarray(db))
    np.testing.assert_allclose(float(got.mn.min()), float(jx.jnp.min(mn)),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(float(got.mx.max()), float(jx.jnp.max(mx)),
                               rtol=1e-5, atol=1e-4)


def test_kernel_plain_linear_and_partials():
    """The optional linear image is sum/N + eps with dB = 20·ln/denom of it;
    the per-tile partials cover valid elements only."""
    shape = (2, 40, 48, 45)                       # ragged in rows and depths
    args = {k: torch.as_tensor(v) for k, v in random_kernel_args(shape, seed=3).items()}
    out = int8_bscan_display_fused(*args.values(), -25.0, 2, eps=1e-5, denom=2.303,
                                   with_linear=True)
    assert out.linear.shape == out.db.shape == (40, 45)
    want_db = 20.0 * torch.log(out.linear) / 2.303
    np.testing.assert_allclose(out.db[:, 2:].numpy(), want_db[:, 2:].numpy(), rtol=1e-6)
    np.testing.assert_array_equal(out.db[:, 0].numpy(), out.db[:, 4].numpy())
    np.testing.assert_array_equal(out.db[:, 1].numpy(), out.db[:, 4].numpy())
    tm, tn = INT8_TILE
    assert out.mn.shape == out.mx.shape == (2, 2)
    floor = torch.clamp_min(out.db, -25.0)
    for r in range(2):
        for c in range(2):
            tile = floor[r * tm:(r + 1) * tm, c * tn:(c + 1) * tn]
            assert float(out.mn[r, c]) == float(tile.min())
            assert float(out.mx[r, c]) == float(tile.max())


@pytest.mark.parametrize("compat", [True, False])
def test_reconstruct_bscan_int8_fused_matches_jax(jx, data, compat):
    jplan, tplan = plans(data)
    s8 = jx.ji.to_s8(data["frames"])
    thresh = data["jcfg"].bscanthreshold
    db, u8 = jx.ji.reconstruct_bscan_int8_fused(jx.jnp.asarray(s8), jplan, thresh, averages=4,
                                                compat=compat, interpret=True)
    got_db, got_u8 = ti.reconstruct_bscan_int8_fused(torch.as_tensor(s8), tplan, thresh, 4,
                                                     compat=compat)
    assert got_db.shape == (160, 32)
    assert_db_close(got_db.numpy(), np.asarray(db))
    assert_u8_close(got_u8.numpy(), np.asarray(u8))


def test_fused_bscan_matches_the_plain_chain(jx, data):
    """int8_bscan_outputs equals form_bscan(reconstruct_int8_direct(...).sum(0)),
    linear image included; a rank-2 plan is refused."""
    _, tplan = plans(data)
    s8 = torch.as_tensor(jx.ji.to_s8(data["frames"]))
    want = tpl.form_bscan(ti.reconstruct_int8_direct(s8, tplan).sum(0), data["tcfg"], 4,
                          bscanthreshold=-40.0)
    got = ti.int8_bscan_outputs(s8, tplan, -40.0, 4, compat=True)
    np.testing.assert_allclose(got.bscan.numpy(), want.bscan.numpy(), rtol=1e-6)
    assert_db_close(got.bscandb.numpy(), want.bscandb.numpy())
    assert_u8_close(got.bscandisp.numpy(), want.bscandisp.numpy())
    _, rank2 = plans(data, rank=2)
    with pytest.raises(ValueError, match="rank-1"):
        ti.int8_bscan_outputs(s8, rank2, -40.0, 4)


def test_int8_precision_branch_matches_jax(jx, data):
    """matmul_precision='int8': the calibration's int8 tables and the
    dynamic per-row input quantization against the JAX package."""
    jcfg = data["jcfg"].replace(matmul_precision="int8")
    tcfg = PipelineConfig(**dataclasses.asdict(jcfg))
    jcal, tcal = jx.JaxCalibration.create(jcfg), Calibration.create(tcfg, "cpu")
    for name in ("op_re_q", "op_im_q"):
        np.testing.assert_array_equal(getattr(tcal, name).numpy(), np.asarray(getattr(jcal, name)))
    for name in ("op_scale_re", "op_scale_im"):
        np.testing.assert_allclose(getattr(tcal, name).numpy(), np.asarray(getattr(jcal, name)),
                                   rtol=1e-6)
    arrays = {n: np.asarray(getattr(jcal, n))
              for n in CAL_LEAVES + ("op_re_q", "op_im_q", "op_scale_re", "op_scale_im")}
    tcal = Calibration.from_arrays(arrays, tcfg, "cpu")
    jnp = jx.jnp
    yr = np.array(jx.jpl.apodize_ratio(jx.jpl.preprocess(jnp.asarray(data["frames"]), jcfg),
                                         jnp.asarray(data["bg"], jnp.float32),
                                         jnp.asarray(data["pi"], jnp.float32), jcfg))
    want = np.asarray(jx.jpl.ascan_mags(jx.jnp.asarray(yr), jcal, "fused", "int8"))
    got = tpl.ascan_mags(torch.as_tensor(yr), tcal, "fused", "int8").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    # the group step under 'int8' runs the same chain, summed
    group = tpl.reconstruct_group(torch.as_tensor(data["frames"]),
                                  torch.as_tensor(data["bg"]), torch.as_tensor(data["pi"]),
                                  tcal, tcfg)
    np.testing.assert_allclose(group.numpy(), want.sum(0), rtol=1e-5,
                               atol=1e-5 * np.abs(want).sum(0).max())


@pytest.mark.parametrize("shape", [(5, 7, 3), (2, 20, 16, 24), (17, 64, 8), (1, 3, 40, 9)])
def test_int8_matmul_routes_agree(shape):
    """torch._int_mm and the exact float64 product give identical int32
    results, at shapes _int_mm takes on CUDA and at ragged ones it does not."""
    rng = np.random.default_rng(len(shape))
    *lead, k, n = shape
    a = torch.as_tensor(rng.integers(-128, 128, (*lead, k)).astype(np.int8))
    b = torch.as_tensor(rng.integers(-128, 128, (k, n)).astype(np.int8))
    got = int8_matmul(a, b)
    assert got.dtype == torch.int32 and got.shape == (*lead, n)
    exact = (a.double() @ b.double()).to(torch.int32)
    np.testing.assert_array_equal(got.numpy(), exact.numpy())
    np.testing.assert_array_equal(
        got.numpy(), (a.numpy().astype(np.int64) @ b.numpy().astype(np.int64)))
    with pytest.raises(TypeError, match="int8"):
        int8_matmul(a.to(torch.int16), b)


@pytest.mark.parametrize("m,k,n,ptr_a,ptr_b,takes", [
    (4096, 2048, 512, 0, 256, True), (192, 128, 64, 512, 0, True),
    (296, 48, 80, 0, 0, False), (65, 64, 64, 0, 0, False), (96, 64, 64, 1, 0, False),
    (96, 64, 64, 0, 8, False), (16, 64, 64, 0, 0, False), (40, 16, 24, 0, 0, False)],
    ids=["flagship", "tiled", "k-tail", "odd-rows", "a-unaligned", "b-unaligned", "16-rows",
         "small"])
def test_cuda_int_mm_route(m, k, n, ptr_a, ptr_b, takes):
    """CUDA's torch._int_mm is taken only for shapes cuBLASLt runs; the rest
    (shapes it refused on an H100) take the exact float64 product."""
    assert kernels.cuda_int_mm_takes(m, k, n, ptr_a, ptr_b) is takes


def _kernel_args(shape=KERNEL_SHAPES["tiled"], device="cpu"):
    return [torch.as_tensor(v).to(device) for v in random_kernel_args(shape).values()]


@pytest.mark.parametrize("mutate,exc,match", [
    (lambda a: a.__setitem__(0, a[0].to(torch.uint8)), TypeError, "frames_s8"),
    (lambda a: a.__setitem__(0, a[0][:, :, :-1]), ValueError, "contiguous"),
    (lambda a: a.__setitem__(1, a[1][:, :4].contiguous()), ValueError, "operator shapes"),
    (lambda a: (a.__setitem__(1, a[1][:, :4].contiguous()),
                a.__setitem__(2, a[2][:, :4].contiguous())), ValueError, "ndisp=4 < 5"),
    (lambda a: a.__setitem__(3, a[3].double()), TypeError, "s_re"),
    (lambda a: a.__setitem__(5, a[5][:, 0]), ValueError, "row_gain"),
    (lambda a: a.__setitem__(6, a[6].t().contiguous().t()), ValueError, "const_re"),
], ids=["frames-dtype", "frames-strided", "op-shape", "ndisp", "scale-dtype", "gain-shape",
        "const-strided"])
def test_int8_wrapper_rejects(mutate, exc, match):
    args = _kernel_args()
    mutate(args)
    with pytest.raises(exc, match=match):
        int8_bscan_display_fused(*args, -30.0, 3)


def test_int8_cpu_calls_count_no_launch():
    before = dict(LAUNCHES)
    int8_bscan_display_fused(*_kernel_args(), -30.0, 3)
    assert LAUNCHES == before
    kernels.reset_launches()
    assert LAUNCHES["int8_bscan_display_fused"] == 0


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("with_linear", [False, True], ids=["no-linear", "linear"])
@pytest.mark.parametrize("shape", list(KERNEL_SHAPES.values()), ids=list(KERNEL_SHAPES))
def test_cuda_int8_kernel_matches_plain(cuda, shape, with_linear):
    args = _kernel_args(shape, cuda)
    before = LAUNCHES["int8_bscan_display_fused"]
    got = int8_bscan_display_fused(*args, -30.0, shape[0], with_linear=with_linear)
    torch.cuda.synchronize()
    assert LAUNCHES["int8_bscan_display_fused"] == before + 1
    want = int8_bscan_display_fused_reference(*args, -30.0, shape[0], with_linear=with_linear)
    assert_db_close(got.db.cpu().numpy(), want.db.cpu().numpy())
    np.testing.assert_allclose(got.mn.cpu().numpy(), want.mn.cpu().numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.mx.cpu().numpy(), want.mx.cpu().numpy(), rtol=1e-5, atol=1e-4)
    if with_linear:
        np.testing.assert_allclose(got.linear.cpu().numpy(), want.linear.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
    else:
        assert got.linear is None


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 32, 64, 32), (1, 3, 40, 9)], ids=["int_mm", "float64"])
def test_cuda_int8_matmul_routes_agree(cuda, shape):
    rng = np.random.default_rng(1)
    *lead, k, n = shape
    a = torch.as_tensor(rng.integers(-128, 128, (*lead, k)).astype(np.int8)).to(cuda)
    b = torch.as_tensor(rng.integers(-128, 128, (k, n)).astype(np.int8)).to(cuda)
    np.testing.assert_array_equal(int8_matmul(a, b).cpu().numpy(),
                                  int8_matmul(a.cpu(), b.cpu()).numpy())


def _assert_int8_outputs_close(got, want):
    assert_db_close(got.db.cpu().numpy(), want.db.cpu().numpy())
    np.testing.assert_allclose(got.mn.cpu().numpy(), want.mn.cpu().numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.mx.cpu().numpy(), want.mx.cpu().numpy(), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.linear.cpu().numpy(), want.linear.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(EDGE_SHAPES.values()), ids=list(EDGE_SHAPES))
def test_cuda_int8_tensor_core_edges(cuda, shape):
    """The s8 tensor-core kernel at its tile edges, with and without the
    packed operator passed in."""
    args = _kernel_args(shape, cuda)
    want = int8_bscan_display_fused_reference(*args, -30.0, shape[0], with_linear=True)
    got = int8_bscan_display_fused(*args, -30.0, shape[0], with_linear=True)
    packed = int8_bscan_display_fused(*args, -30.0, shape[0], with_linear=True,
                                      oq_packed=pack_int8_operator(args[1], args[2]))
    torch.cuda.synchronize()
    _assert_int8_outputs_close(got, want)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                      getattr(packed, name).cpu().numpy(), err_msg=name)


@pytest.mark.cuda
@pytest.mark.parametrize("thresh", [-0.0, 0.0], ids=["minus-zero", "plus-zero"])
def test_cuda_int8_partials_at_a_zero_floor(cuda, thresh):
    """A floor of -0 or +0 under a B-scan whose dB are all negative: every
    element clamps to the floor, so every min/max partial is that zero; the
    kernel's atomic min/max order -0 below +0 by the float's bits."""
    shape = (8, 64, 64, 64)                       # 8 warps fold into each partial
    args = _kernel_args(shape, cuda)
    for i in (3, 4, 6, 7):                        # scales and constants: |x| << 1
        args[i] = args[i] * 1e-4
    want = int8_bscan_display_fused_reference(*args, thresh, shape[0])
    assert float(want.db.max()) < 0.0
    got = int8_bscan_display_fused(*args, thresh, shape[0])
    torch.cuda.synchronize()
    assert_db_close(got.db.cpu().numpy(), want.db.cpu().numpy())
    for name in ("mn", "mx"):
        np.testing.assert_array_equal(getattr(got, name).cpu().numpy(),
                                      getattr(want, name).cpu().numpy(), err_msg=name)


@pytest.mark.cuda
def test_cuda_int8_tensor_core_unaligned(cuda):
    """Frames and operator views that are not 16-byte aligned: the frames
    stage byte by byte, the operator is packed into an aligned copy; a
    misaligned packed operator is refused."""
    shape = (4, 24, 64, 40)
    args = _kernel_args(shape, cuda)
    for i in (0, 1):
        flat = torch.empty(args[i].numel() + 1, dtype=torch.int8, device=cuda)
        flat[1:] = args[i].flatten()
        args[i] = flat[1:].view(args[i].shape)
    want = int8_bscan_display_fused_reference(*args, -30.0, shape[0], with_linear=True)
    got = int8_bscan_display_fused(*args, -30.0, shape[0], with_linear=True)
    torch.cuda.synchronize()
    _assert_int8_outputs_close(got, want)
    packed = pack_int8_operator(args[1], args[2])
    flat = torch.empty(packed.numel() + 1, dtype=torch.int8, device=cuda)
    flat[1:] = packed.flatten()
    with pytest.raises(ValueError, match="aligned"):
        int8_bscan_display_fused(*args, -30.0, shape[0], oq_packed=flat[1:].view(packed.shape))
