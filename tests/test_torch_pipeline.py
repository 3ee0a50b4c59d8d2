"""The port's pipeline against ``fdoct_tpu.pipeline`` on the same numpy inputs.

Precision is pinned on both sides: 'highest' (float64 and float32 data) and
'bf16' (float32 data).  'default' is never compared, because it resolves to
different functions on the CPU and on an accelerator.

Tolerances: float64 'highest' agrees to rounding (rtol 1e-9); float32 runs
differ by summation order (magnitudes rtol 1e-4 of the peak) and bf16 also by
where the ratio is rounded: the port forms it as (y − y_p)·(1/y_b), the JAX
package as (y − y_p)/y_b, which can flip single bf16 roundings.  dB values
are compared on pixels within 40 dB of the peak, uint8 displays within one
level.
"""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the JAX reference; without it (a GPU-only host) skip

from fdoct_tpu import pipeline as jp
from fdoct_tpu.calibration import Calibration as JaxCalibration
from fdoct_tpu.config import PipelineConfig as JaxConfig
from fdoct_tpu_torch import pipeline as tp
from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.sources.synthetic import SyntheticSource

BASE = dict(width=256, height=32, averages=4, numfftpoints=512, numdisplaypoints=128,
            lambdamin=816e-9, lambdamax=884e-9, compat=True)
CONFIGS = {
    # identity preprocess: the raw-input kernel's route
    "identity": {},
    # per-frame normalization (what `fdoct sim` runs): the ratio-input route
    "normalize": dict(donotnormalize=False, rowwisenormalize=True),
    # median, binning, zero-pad, moving average, dispersion
    "binned": dict(width=512, height=64, binvalue=2, mediann=3, movavgn=2,
                   increasefftpointsmultiplier=2, dispersion_a2=2.0),
}
PRECISIONS = {"highest64": ("highest", "float64"), "highest32": ("highest", "float32"),
              "bf16": ("bf16", "float32")}
TOL = {"highest64": 1e-9, "highest32": 1e-4, "bf16": 2e-3}
DB_TOL = {"highest64": 1e-8, "highest32": 2e-3, "bf16": 2e-2}


def make_case(cfg_name, prec_name, seed=0):
    precision, dtype = PRECISIONS[prec_name]
    jcfg = JaxConfig(**{**BASE, **CONFIGS[cfg_name]}, matmul_precision=precision,
                     dtype=dtype)
    tcfg = PipelineConfig(**dataclasses.asdict(jcfg))
    src = SyntheticSource(height=jcfg.height, width=jcfg.width, noise=0.02, seed=seed,
                          depths_um=(60.0, 110.0), reflectivities=(0.5, 0.3))
    it = src.frames()
    raw = np.stack([next(it) for _ in range(jcfg.averages)])
    bg = np.array(jp.preprocess(jnp.asarray(np.maximum(src.background(), 1)), jcfg))
    pi = np.array(jp.preprocess(jnp.asarray(src.pi_frame()), jcfg))
    return jcfg, tcfg, raw, bg, pi


def calibs(jcfg, tcfg):
    return JaxCalibration.create(jcfg), Calibration.create(tcfg, "cpu")


def assert_bscans_close(got, want, prec_name):
    """got: port BscanOutputs; want: JAX BscanOutputs."""
    w_lin, g_lin = np.asarray(want.bscan), got.bscan.numpy()
    np.testing.assert_allclose(g_lin, w_lin, rtol=TOL[prec_name],
                               atol=TOL[prec_name] * np.abs(w_lin).max())
    w_db, g_db = np.asarray(want.bscandb), got.bscandb.numpy()
    near = w_db >= w_db.max() - 40.0
    assert near.sum() > 100
    np.testing.assert_allclose(g_db[near], w_db[near], rtol=0, atol=DB_TOL[prec_name])
    w_u8, g_u8 = np.asarray(want.bscandisp), got.bscandisp.numpy()
    assert g_u8.dtype == np.uint8 and g_u8.shape == w_u8.shape
    assert np.abs(g_u8.astype(int) - w_u8.astype(int)).max() <= 1


@pytest.mark.parametrize("prec_name", list(PRECISIONS))
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_reconstruct_bscan_matches_jax(cfg_name, prec_name):
    jcfg, tcfg, raw, bg, pi = make_case(cfg_name, prec_name)
    jcal, tcal = calibs(jcfg, tcfg)
    want = jp.reconstruct_bscan(jnp.asarray(raw), jnp.asarray(bg), jnp.asarray(pi),
                                jcal, jcfg, method="fused")
    got = tp.reconstruct_bscan(torch.as_tensor(raw), torch.as_tensor(bg),
                               torch.as_tensor(pi), tcal, tcfg)
    assert got.bscandb.shape == (tcal.ndisp, tcfg.oph)
    assert_bscans_close(got, want, prec_name)


@pytest.mark.parametrize("prec_name", ["highest64", "bf16"])
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_reconstruct_per_frame_matches_jax(cfg_name, prec_name):
    jcfg, tcfg, raw, bg, pi = make_case(cfg_name, prec_name, seed=1)
    jcal, tcal = calibs(jcfg, tcfg)
    want = np.asarray(jp.reconstruct(jnp.asarray(raw), jnp.asarray(bg), jnp.asarray(pi),
                                     jcal, jcfg, method="fused"))
    got = tp.reconstruct(torch.as_tensor(raw), torch.as_tensor(bg), torch.as_tensor(pi),
                         tcal, tcfg).numpy()
    tol = 1e-9 if prec_name == "highest64" else 1e-5
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def _shared_calibs(jcfg, tcfg):
    """The JAX calibration and the port's built from its leaves: one M."""
    jcal = JaxCalibration.create(jcfg)
    leaves = ("op_re", "op_im", "window", "nearest_idx", "frac", "phase", "lambdas", "k",
              "klinear")
    return jcal, Calibration.from_arrays({n: np.asarray(getattr(jcal, n)) for n in leaves},
                                         tcfg, "cpu")


@pytest.mark.parametrize("dtype", ["float64", torch.float64], ids=["name", "torch"])
@pytest.mark.parametrize("cfg_name", ["identity", "binned"])
def test_dtype_argument_matches_jax(cfg_name, dtype):
    """reconstruct and reconstruct_bscan with dtype='float64' on a float32
    config compute in float64, as the JAX package's ``dtype`` does."""
    jcfg, tcfg, raw, bg, pi = make_case(cfg_name, "highest32", seed=3)
    jcal, tcal = _shared_calibs(jcfg, tcfg)
    jargs = (jnp.asarray(raw), jnp.asarray(bg), jnp.asarray(pi), jcal, jcfg)
    targs = (torch.as_tensor(raw), torch.as_tensor(bg), torch.as_tensor(pi), tcal, tcfg)
    want = np.asarray(jp.reconstruct(*jargs, method="fused", dtype="float64"))
    got = tp.reconstruct(*targs, dtype=dtype).numpy()
    assert want.dtype == np.float64 and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.abs(want).max())
    want_b = jp.reconstruct_bscan(*jargs, method="fused", dtype="float64")
    got_b = tp.reconstruct_bscan(*targs, dtype=dtype)
    for name in ("bscan", "bscandb"):
        w = np.asarray(getattr(want_b, name))
        assert getattr(got_b, name).dtype == torch.float64
        np.testing.assert_allclose(getattr(got_b, name).numpy(), w, rtol=1e-12,
                                   atol=1e-12 * np.abs(w).max())
    np.testing.assert_array_equal(got_b.bscandisp.numpy(), np.asarray(want_b.bscandisp))


def test_dtype_argument_equal_to_config_keeps_the_group_kernel():
    jcfg, tcfg, raw, bg, pi = make_case("identity", "highest32")
    tcal = Calibration.create(tcfg, "cpu")
    args = (torch.as_tensor(raw), torch.as_tensor(bg), torch.as_tensor(pi), tcal, tcfg)
    via_group = tp.reconstruct_bscan(*args)
    for spec in ("float32", torch.float32):
        same = tp.reconstruct_bscan(*args, dtype=spec)
        np.testing.assert_array_equal(same.bscan.numpy(), via_group.bscan.numpy())


def test_ascan_complex_matches_jax():
    jcfg, tcfg, raw, bg, pi = make_case("binned", "highest64")
    jcal, tcal = calibs(jcfg, tcfg)
    yr = np.array(jp.apodize_ratio(jp.preprocess(jnp.asarray(raw), jcfg),
                                     jnp.asarray(bg), jnp.asarray(pi), jcfg))
    want = np.asarray(jp.ascan_complex(jnp.asarray(yr), jcal, "highest"))
    got = tp.ascan_complex(torch.as_tensor(yr), tcal, "highest").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())
    mags = tp.ascan_mags(torch.as_tensor(yr), tcal, "fused_exact").numpy()
    np.testing.assert_allclose(mags, np.abs(got), rtol=1e-12)


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_preprocess_and_ratio_match_jax(cfg_name):
    jcfg, tcfg, raw, bg, pi = make_case(cfg_name, "highest64", seed=2)
    # frames with different ranges: normalization must be per frame
    scaled = raw.astype(np.float64) * (1.0 + 0.5 * np.arange(len(raw)))[:, None, None]
    for frames in (raw, scaled):
        y_want = jp.preprocess(jnp.asarray(frames), jcfg)
        y_got = tp.preprocess(torch.as_tensor(frames), tcfg)
        np.testing.assert_allclose(y_got.numpy(), np.asarray(y_want), rtol=1e-12)
        want = np.asarray(jp.apodize_ratio(y_want, jnp.asarray(bg), jnp.asarray(pi), jcfg))
        got = tp.apodize_ratio(y_got, torch.as_tensor(bg), torch.as_tensor(pi), tcfg).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("clampupper", [False, True])
@pytest.mark.parametrize("thresh,eps,averages", [(None, 1e-5, 4), (-np.inf, 1e-6, 1),
                                                 (-12.5, 1e-5, 3)])
def test_form_bscan_matches_jax(clampupper, thresh, eps, averages):
    rng = np.random.default_rng(11)
    mag = rng.gamma(1.0, 2.0, (24, 40)) * np.exp(-np.arange(40) / 8.0)
    jcfg = JaxConfig(**BASE, dtype="float64", clampupper=clampupper, bscanthreshold=-20.0)
    tcfg = PipelineConfig(**dataclasses.asdict(jcfg))
    want = jp.form_bscan(jnp.asarray(mag), jcfg, averages, bscanthreshold=thresh, eps=eps)
    got = tp.form_bscan(torch.as_tensor(mag), tcfg, averages, bscanthreshold=thresh, eps=eps)
    for name in ("bscan", "bscandb"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-13, atol=1e-13)
    np.testing.assert_array_equal(got.bscandisp.numpy(), np.asarray(want.bscandisp))


def test_raw_and_ratio_routes_agree():
    """Kernel 1 (ratio from raw counts) and kernel 2 (ratio from preprocess)
    compute the same group sum."""
    jcfg, tcfg, raw, bg, pi = make_case("identity", "highest64")
    tcal = Calibration.create(tcfg, "cpu")
    traw = torch.as_tensor(raw)
    assert tp.raw_kernel_applies(traw, tcfg)
    assert not tp.raw_kernel_applies(traw.double(), tcfg)
    via_raw = tp.reconstruct_group(traw, torch.as_tensor(bg), torch.as_tensor(pi), tcal, tcfg)
    via_yr = tp.reconstruct_group(traw.double(), torch.as_tensor(bg), torch.as_tensor(pi),
                                  tcal, tcfg)
    np.testing.assert_allclose(via_raw.numpy(), via_yr.numpy(), rtol=1e-12)


@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_float64_group_takes_the_plain_chain(cfg_name, monkeypatch):
    """A float64 config's group step calls neither kernel wrapper (the
    kernels take a float32 or bfloat16 operator, and on CUDA their wrappers
    raise for float64) and equals the JAX package's per-frame sum in
    float64."""
    jcfg, tcfg, raw, bg, pi = make_case(cfg_name, "highest64", seed=4)
    jcal, tcal = _shared_calibs(jcfg, tcfg)

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called for a float64 operator")

    monkeypatch.setattr(tp, "fused_recon_raw_accumulate", refuse)
    monkeypatch.setattr(tp, "fused_recon_accumulate", refuse)
    assert not tp.group_kernel_applies(tcal.op_re.dtype)
    want = np.asarray(jp.reconstruct(jnp.asarray(raw), jnp.asarray(bg), jnp.asarray(pi), jcal,
                                     jcfg, method="fused")).sum(0)
    for method in ("fused", "fused_exact"):
        got = tp.reconstruct_group(torch.as_tensor(raw), torch.as_tensor(bg),
                                   torch.as_tensor(pi), tcal, tcfg, method)
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("change", [
    dict(mediann=3), dict(binvalue=2), dict(binvaluex=2), dict(movavgn=1),
    dict(donotnormalize=False), dict(rowwisenormalize=True)])
def test_raw_kernel_needs_identity_preprocess(change):
    tcfg = PipelineConfig(**BASE)
    assert tp.raw_kernel_applies(torch.zeros(2, 32, 256, dtype=torch.uint8), tcfg)
    assert not tp.raw_kernel_applies(torch.zeros(2, 32, 256, dtype=torch.uint8),
                                     tcfg.replace(**change))
    assert not tp.raw_kernel_applies(torch.zeros(32, 256, dtype=torch.uint8), tcfg)


def test_precision_policy():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert tp.use_bf16("bf16", torch.float32, cpu)
    assert not tp.use_bf16("default", torch.float32, cpu)       # f32 on the CPU, as JAX
    assert tp.use_bf16("default", torch.float32, cuda)          # bf16 on the card
    assert not tp.use_bf16("highest", torch.float32, cuda)
    assert not tp.use_bf16("bf16", torch.float64, cpu)          # float64 keeps float64
    for precision in ("int8", "int8_direct"):                   # without int8 tables:
        for device in (cpu, cuda):                              # bf16 on every device
            assert tp.use_bf16(precision, torch.float32, device)


@pytest.mark.parametrize("precision", ["int8_direct", "int8"])
def test_generic_int8_precisions_without_tables_are_bf16(precision):
    """Through the generic entry points 'int8_direct' (and 'int8' on a
    calibration without int8 tables) is the bf16 branch on the CPU too, as
    the JAX package resolves it (pipeline.py:160-176 there)."""
    jcfg, tcfg, raw, bg, pi = make_case("identity", "bf16")
    jcal, tcal = calibs(jcfg, tcfg)
    args = (torch.as_tensor(raw), torch.as_tensor(bg), torch.as_tensor(pi), tcal)
    bf16 = tp.reconstruct_group(*args, tcfg)
    got = tp.reconstruct_group(*args, tcfg.replace(matmul_precision=precision))
    np.testing.assert_array_equal(got.numpy(), bf16.numpy())
    np.testing.assert_array_equal(
        tp.reconstruct(*args, tcfg.replace(matmul_precision=precision)).numpy(),
        tp.reconstruct(*args, tcfg).numpy())
    want = jp.reconstruct_bscan(jnp.asarray(raw), jnp.asarray(bg), jnp.asarray(pi), jcal,
                                jcfg.replace(matmul_precision=precision), method="fused")
    assert_bscans_close(tp.reconstruct_bscan(*args, tcfg.replace(matmul_precision=precision)),
                        want, "bf16")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_int8_precision_matches_jax(dtype):
    """'int8' with the calibration's int8 tables: per-frame magnitudes and
    the group step (plain chain) against the JAX package."""
    jcfg, tcfg, raw, bg, pi = make_case("normalize", "highest64")
    jcfg = jcfg.replace(matmul_precision="int8", dtype=dtype)
    tcfg = PipelineConfig(**dataclasses.asdict(jcfg))
    jcal = JaxCalibration.create(jcfg, dtype=dtype)
    leaves = ("op_re", "op_im", "window", "nearest_idx", "frac", "phase", "lambdas", "k",
              "klinear", "op_re_q", "op_im_q", "op_scale_re", "op_scale_im")
    tcal = Calibration.from_arrays({n: np.asarray(getattr(jcal, n)) for n in leaves}, tcfg, "cpu")
    assert tcal.op_re_q.dtype == torch.int8
    want = np.asarray(jp.reconstruct(jnp.asarray(raw), jnp.asarray(bg), jnp.asarray(pi),
                                     jcal, jcfg, method="fused"))
    args = (torch.as_tensor(raw), torch.as_tensor(bg), torch.as_tensor(pi), tcal, tcfg)
    got = tp.reconstruct(*args).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    group = tp.reconstruct_group(*args).numpy()
    np.testing.assert_allclose(group, want.sum(0), rtol=1e-5,
                               atol=1e-5 * np.abs(want).sum(0).max())


@pytest.mark.parametrize("method,precision,exc,match", [
    ("fft", "highest", ValueError, "unknown method"),
    ("fused", "int4", ValueError, "unknown matmul_precision"),
])
def test_unported_paths_raise(method, precision, exc, match):
    tcfg = PipelineConfig(**BASE, matmul_precision="highest")
    tcal = Calibration.create(tcfg, "cpu")
    raw = torch.zeros(2, 32, 256, dtype=torch.uint8)
    one = torch.ones(32, 256)
    with pytest.raises(exc, match=match):
        tp.reconstruct_group(raw, one, one, tcal, tcfg.replace(matmul_precision=precision),
                             method)
    with pytest.raises(exc, match=match):
        tp.reconstruct(raw, one, one, tcal, tcfg.replace(matmul_precision=precision), method)
