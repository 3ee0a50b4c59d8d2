"""The gather and hilbert reconstruction methods of the port against the JAX
package on the same numpy inputs: the row-wise FFT ops (``ops/fft``), the
gather resample (``ops/resample``), the analytic signal (``ops/hilbert``),
``linearize``, ``ascan_mags`` and a gather ``Session``.

Limits: float64 rtol 1e-10, atol 1e-10·max; float32 rtol 1e-5, atol
1e-5·max (both packages transform in complex64 there, in their own FFT
libraries).
"""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the JAX reference; without it (a GPU-only host) skip

from fdoct_tpu import pipeline as jp
from fdoct_tpu.calibration import Calibration as JaxCalibration
from fdoct_tpu.config import PipelineConfig as JaxConfig
from fdoct_tpu.ops import fft as jfft
from fdoct_tpu.ops import hilbert as jhilbert
from fdoct_tpu.ops import resample as jresample
from fdoct_tpu.session import Session as JaxSession
from fdoct_tpu_torch import pipeline as tp
from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.ops import fft as tfft
from fdoct_tpu_torch.ops import hilbert as thilbert
from fdoct_tpu_torch.ops import kernels
from fdoct_tpu_torch.ops import resample as tresample
from fdoct_tpu_torch.session import Session
from fdoct_tpu_torch.sources.synthetic import SyntheticSource

TOL = {"float64": 1e-10, "float32": 1e-5}
DTYPES = list(TOL)
BASE = dict(width=256, height=16, numfftpoints=512, numdisplaypoints=128,
            lambdamin=816e-9, lambdamax=884e-9)
CONFIGS = {
    "plain": dict(compat=True),
    "clean": dict(compat=False),
    "mult2": dict(compat=True, increasefftpointsmultiplier=2),
    "bandpass_mult2_clean": dict(compat=False, increasefftpointsmultiplier=2,
                                 bandpassfilter=True),
    "dispersion_bandpass": dict(compat=True, bandpassfilter=True, dispersion_a2=2.0,
                                dispersion_a3=-1.0),
}


def close(got: torch.Tensor, want, dtype: str) -> None:
    want = np.asarray(want)
    assert got.shape == want.shape
    assert got.dtype == getattr(torch, dtype), (got.dtype, dtype)
    tol = TOL[dtype]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * np.abs(want).max())


def rows(dtype, shape=(3, 5, 96), seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bandpass", [False, True])
@pytest.mark.parametrize("mult", [1, 2, 4])
def test_zeropad_rowwise(mult, bandpass, dtype):
    x = rows(dtype)
    close(tfft.zeropad_rowwise(torch.as_tensor(x), mult, bandpass),
          jfft.zeropad_rowwise(jnp.asarray(x), mult, bandpass), dtype)


def test_zeropad_rowwise_is_the_identity_without_work():
    x = torch.as_tensor(rows("float64"))
    assert tfft.zeropad_rowwise(x, 1, False) is x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [96, 75])
def test_lowpass_rowwise(n, dtype):
    x = rows(dtype, (4, n), seed=1)
    close(tfft.lowpass_rowwise(torch.as_tensor(x)), jfft.lowpass_rowwise(jnp.asarray(x)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_phase", [False, True])
def test_ifft_mag_rows(with_phase, dtype):
    x = rows(dtype, (2, 6, 128), seed=2)
    phase = (np.linspace(-1, 1, 128) ** 2 * 3.0).astype(dtype) if with_phase else None
    got = tfft.ifft_mag_rows(torch.as_tensor(x), None if phase is None else torch.as_tensor(phase))
    close(got, jfft.ifft_mag_rows(jnp.asarray(x), None if phase is None else jnp.asarray(phase)),
          dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_row_slopes(dtype):
    x = rows(dtype, seed=3)
    close(tresample.row_slopes(torch.as_tensor(x)), jresample.row_slopes(jnp.asarray(x)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cfg_name", ["plain", "clean", "mult2", "bandpass_mult2_clean"])
def test_resample_klinear(cfg_name, dtype):
    """Both compat modes, at multiplier 1 and 2, on the calibration's
    nearest_idx (where n_in > nfft, compat's clip of the frac index bites)."""
    jcfg = JaxConfig(**BASE, **CONFIGS[cfg_name], dtype=dtype)
    jcal = JaxCalibration.create(jcfg, dtype=dtype)
    tcal = Calibration.create(PipelineConfig(**dataclasses.asdict(jcfg)), "cpu")
    y = rows(dtype, (2, 7, jcal.n_in), seed=4)
    got = tresample.resample_klinear(torch.as_tensor(y), tcal.nearest_idx, tcal.frac,
                                     compat=jcfg.compat)
    want = jresample.resample_klinear(jnp.asarray(y), jcal.nearest_idx, jcal.frac,
                                      compat=jcfg.compat)
    close(got, want, dtype)
    if jcfg.compat:
        assert not got[..., 0].any() and not got[..., -1].any()
    assert int(tcal.nearest_idx.max()) < jcal.n_in


def test_calibration_refuses_an_out_of_range_nearest_idx():
    cfg = PipelineConfig(**BASE)
    jcal = JaxCalibration.create(JaxConfig(**BASE))
    leaves = {n: np.asarray(getattr(jcal, n)) for n in
              ("op_re", "op_im", "window", "frac", "phase", "lambdas", "k", "klinear")}
    bad = np.asarray(jcal.nearest_idx).copy()
    bad[3] = cfg.opw
    with pytest.raises(ValueError, match="nearest_idx"):
        Calibration.from_arrays({**leaves, "nearest_idx": bad}, cfg, "cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [96, 75])
def test_analytic_signal(n, dtype):
    x = rows(dtype, (3, n), seed=5)
    got = thilbert.analytic_signal(torch.as_tensor(x))
    assert got.dtype == (torch.complex128 if dtype == "float64" else torch.complex64)
    want = np.asarray(jhilbert.analytic_signal(jnp.asarray(x)))
    tol = TOL[dtype]
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol * np.abs(want).max())
    np.testing.assert_allclose(got.real.numpy(), x, rtol=tol, atol=tol * np.abs(x).max())


@pytest.mark.parametrize("dtype", DTYPES)
def test_hilbert_reconstruct(dtype):
    x = rows(dtype, (4, 128), seed=6)
    close(thilbert.hilbert_reconstruct(torch.as_tensor(x), 50),
          jhilbert.hilbert_reconstruct(jnp.asarray(x), 50), dtype)


def calibs(cfg_name, dtype):
    jcfg = JaxConfig(**BASE, **CONFIGS[cfg_name], dtype=dtype)
    tcfg = PipelineConfig(**dataclasses.asdict(jcfg))
    return jcfg, tcfg, JaxCalibration.create(jcfg, dtype=dtype), Calibration.create(tcfg, "cpu")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
def test_linearize(cfg_name, dtype):
    jcfg, tcfg, jcal, tcal = calibs(cfg_name, dtype)
    yr = rows(dtype, (2, 16, 256), seed=7)
    close(tp.linearize(torch.as_tensor(yr), tcal), jp.linearize(jnp.asarray(yr), jcal), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cfg_name", list(CONFIGS))
@pytest.mark.parametrize("method", ["gather", "hilbert"])
def test_ascan_mags(method, cfg_name, dtype):
    jcfg, tcfg, jcal, tcal = calibs(cfg_name, dtype)
    yr = rows(dtype, (2, 16, 256), seed=8)
    got = tp.ascan_mags(torch.as_tensor(yr), tcal, method, "bf16")   # precision is ignored
    close(got, jp.ascan_mags(jnp.asarray(yr), jcal, method), dtype)
    assert got.shape == (2, 16, tcal.ndisp)


@pytest.mark.parametrize("method", ["gather", "hilbert"])
def test_group_step_launches_nothing(method, monkeypatch):
    """reconstruct_group with a stepwise method is the plain chain
    ``ascan_mags(...).sum(0)``: no kernel wrapper is called, no launch
    counted, and it equals the JAX per-frame magnitudes summed."""
    jcfg, tcfg, jcal, tcal = calibs("dispersion_bandpass", "float64")

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was called by a stepwise method")

    monkeypatch.setattr(tp, "fused_recon_raw_accumulate", refuse)
    monkeypatch.setattr(tp, "fused_recon_accumulate", refuse)
    src = SyntheticSource(height=16, width=256, noise=0.02, seed=1)
    it = src.frames()
    raw = np.stack([next(it) for _ in range(3)])
    bg = np.maximum(src.background(), 1).astype(np.float64)
    pi = src.pi_frame().astype(np.float64)
    kernels.reset_launches()
    got = tp.reconstruct_group(torch.as_tensor(raw), torch.as_tensor(bg), torch.as_tensor(pi),
                               tcal, tcfg, method)
    assert set(kernels.LAUNCHES.values()) == {0}
    want = np.asarray(jp.reconstruct(jnp.asarray(raw), jnp.asarray(bg), jnp.asarray(pi), jcal,
                                     jcfg, method=method)).sum(0)
    close(got, want, "float64")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("method", ["gather", "hilbert"])
def test_session_process_group_matches_jax(method, dtype):
    """A stepwise-method 'base' session on the same M, captures and frames
    as the JAX session: two groups through process_group and one per frame."""
    cfg = dict(width=256, height=32, averages=4, numfftpoints=512, numdisplaypoints=128,
               lambdamin=816e-9, lambdamax=884e-9, compat=True, dtype=dtype,
               donotnormalize=True, matmul_precision="highest")
    jcfg = JaxConfig(**cfg)
    tcfg = PipelineConfig(**cfg)
    src = SyntheticSource(height=32, width=256, noise=0.02, seed=2, depths_um=(50.0, 120.0))
    it = src.frames()
    frames = np.stack([next(it) for _ in range(12)])
    bg = np.maximum(src.background(), 1).astype(dtype)
    pi = src.pi_frame().astype(dtype)
    js = JaxSession(jcfg, variant="base", method=method)
    ts = Session(tcfg, device="cpu", method=method)
    js.data_yb, js.data_yp = jnp.asarray(bg), jnp.asarray(pi)
    ts.data_yb, ts.data_yp = torch.as_tensor(bg), torch.as_tensor(pi)
    kernels.reset_launches()
    want = js.process_group(frames[:8]) + [r for f in frames[8:] if (r := js.process(f))]
    got = ts.process_group(frames[:8]) + [r for f in frames[8:] if (r := ts.process(f))]
    assert set(kernels.LAUNCHES.values()) == {0}
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        close(g.bscan, w.bscan, dtype)
        assert np.abs(g.bscandisp.astype(int) - np.asarray(w.bscandisp).astype(int)).max() <= 1
