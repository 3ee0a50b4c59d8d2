"""The port's Doppler / OCT-A (``fdoct_tpu_torch/doppler.py``) against the
JAX package's (``fdoct_tpu/doppler.py``) on the same frames, at the config
of tests/test_doppler.py.

Tolerances.  float64: magnitudes and speckle variance rtol 1e-10 (atol 1e-10
of the peak), velocity atol 1e-15 m, the masks (voxels above 0.1 of the
peak magnitude) equal.  float32 (CPU 'default' is float32 in both
packages): magnitudes rtol 1e-4 (atol 1e-4 of the peak), velocity atol 1e-4
of its peak where the magnitude is above twice the floor (near the floor the
phase of a weak voxel is noise).  The physics cases of tests/test_doppler.py
run on the port alone.  The case marked ``cuda`` (it skips here) holds the
card's 'highest' and 'default' Doppler to the port's float64 Doppler on the
CPU.
"""

import numpy as np
import pytest
import torch

from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.doppler import (
    displacement_m, doppler_bscan, octa_bscan, phase_difference, speckle_variance,
)
from fdoct_tpu_torch.sources.synthetic import SyntheticSource

#: the config of tests/test_doppler.py
DOPPLER = dict(width=256, height=8, averages=1, numfftpoints=512, numdisplaypoints=160,
               lambdamin=816e-9, lambdamax=884e-9, dtype="float64", compat=True)


def moving_frames(step_nm: float, n_frames: int):
    """A scatterer moving ``step_nm`` a frame (tests/test_doppler.py:24-31)."""
    frames, bg = [], None
    for t in range(n_frames):
        src = SyntheticSource(height=8, width=256, depths_um=(50.0 + t * step_nm * 1e-3,),
                              reflectivities=(0.5,))
        frames.append(next(iter(src.frames())))
        bg = np.maximum(src.background(), 1).astype(np.float64)
    return np.stack(frames), bg


def jitter_frames():
    """A scatterer at a random depth each frame beside a static one
    (tests/test_doppler.py:84-96)."""
    rng = np.random.default_rng(11)
    frames = []
    for _ in range(8):
        src = SyntheticSource(height=8, width=256, depths_um=(50.0 + rng.uniform(-2, 2), 90.0),
                              reflectivities=(0.5, 0.5))
        frames.append(next(iter(src.frames())))
    return np.stack(frames), np.maximum(src.background(), 1).astype(np.float64)


@pytest.fixture(scope="module")
def calib64():
    return PipelineConfig(**DOPPLER), Calibration.create(PipelineConfig(**DOPPLER), "cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def port_run(fn, frames, bg, cfg, calib, device="cpu", **kw):
    dt = getattr(torch, cfg.dtype)
    bgt = torch.as_tensor(bg, dtype=dt).to(device)
    out = fn(torch.as_tensor(frames).to(device), bgt, torch.zeros_like(bgt), calib, cfg, **kw)
    return tuple(o.cpu().numpy() for o in out)


def jax_run(fn_name, frames, bg, dtype):
    jnp = pytest.importorskip("jax.numpy")
    from fdoct_tpu import doppler as jd
    from fdoct_tpu.calibration import Calibration as JaxCalibration
    from fdoct_tpu.config import PipelineConfig as JaxConfig

    cfg = JaxConfig(**{**DOPPLER, "dtype": dtype})
    bgj = jnp.asarray(bg.astype(dtype))
    out = getattr(jd, fn_name)(jnp.asarray(frames), bgj, jnp.zeros_like(bgj),
                               JaxCalibration.create(cfg), cfg)
    return tuple(np.asarray(o) for o in out)


def close(got, want, rtol):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


CASES = {"moving": lambda: moving_frames(30.0, 6), "static": lambda: moving_frames(0.0, 4),
         "jitter": jitter_frames}


@pytest.mark.parametrize("case", list(CASES))
def test_doppler_float64_matches_jax(case):
    frames, bg = CASES[case]()
    cfg = PipelineConfig(**DOPPLER)
    mag, vel = port_run(doppler_bscan, frames, bg, cfg, Calibration.create(cfg, "cpu"))
    jmag, jvel = jax_run("doppler_bscan", frames, bg, "float64")
    assert mag.shape == vel.shape == jmag.shape == (160, 8) and vel.dtype == np.float64
    close(mag, jmag, 1e-10)
    mask = mag > 0.1 * mag.max()
    np.testing.assert_array_equal(mask, jmag > 0.1 * jmag.max())
    assert not vel[~mask].any() and not jvel[~mask].any()
    np.testing.assert_allclose(vel, jvel, rtol=0, atol=1e-15)


@pytest.mark.parametrize("case", list(CASES))
def test_octa_float64_matches_jax(case):
    frames, bg = CASES[case]()
    cfg = PipelineConfig(**DOPPLER)
    mag, sv = port_run(octa_bscan, frames, bg, cfg, Calibration.create(cfg, "cpu"))
    jmag, jsv = jax_run("octa_bscan", frames, bg, "float64")
    close(mag, jmag, 1e-10)
    mask = mag > 0.1 * mag.max()
    np.testing.assert_array_equal(mask, jmag > 0.1 * jmag.max())
    assert not sv[~mask].any() and not jsv[~mask].any()
    close(sv, jsv, 1e-10)


@pytest.mark.parametrize("fn", ["doppler_bscan", "octa_bscan"])
def test_float32_matches_jax(fn):
    frames, bg = moving_frames(30.0, 6)
    cfg = PipelineConfig(**{**DOPPLER, "dtype": "float32"})
    port = {"doppler_bscan": doppler_bscan, "octa_bscan": octa_bscan}[fn]
    mag, out = port_run(port, frames, bg, cfg, Calibration.create(cfg, "cpu"))
    jmag, jout = jax_run(fn, frames, bg, "float32")
    assert mag.dtype == out.dtype == np.float32
    close(mag, jmag, 1e-4)
    strong = jmag > 0.2 * jmag.max()
    np.testing.assert_allclose(out[strong], jout[strong], rtol=0,
                               atol=1e-4 * np.abs(jout[strong]).max())


def test_phase_difference_and_displacement():
    z1 = torch.tensor([1.0 + 0j, 1.0 + 0j], dtype=torch.complex128)
    z2 = torch.tensor([np.exp(1j * 2.5), np.exp(-1j * 3.0)], dtype=torch.complex128)
    np.testing.assert_allclose(phase_difference(z1, z2).numpy(), [2.5, -3.0], rtol=1e-12)
    lam = PipelineConfig(**DOPPLER).lambda0
    assert float(displacement_m(torch.tensor(np.pi / 2), lam)) == pytest.approx(lam / 8, rel=1e-12)
    z = torch.tensor([[1.0, 2.0], [3.0, 2.0], [5.0, 2.0]], dtype=torch.complex128)
    np.testing.assert_allclose(speckle_variance(z).numpy(), [np.var([1, 3, 5]), 0.0])


def test_recovers_known_velocity(calib64):
    cfg, calib = calib64
    step_nm = 30.0
    mag, vel = port_run(doppler_bscan, *moving_frames(step_nm, 6), cfg, calib)
    peak = np.unravel_index(np.argmax(mag[5:]), mag[5:].shape)
    assert vel[5:][peak] * 1e9 == pytest.approx(step_nm, rel=0.2)


def test_static_scene_zero_velocity(calib64):
    cfg, calib = calib64
    _, vel = port_run(doppler_bscan, *moving_frames(0.0, 4), cfg, calib)
    assert np.abs(vel).max() < 1e-12


def test_noise_floor_masked(calib64):
    cfg, calib = calib64
    mag, vel = port_run(doppler_bscan, *moving_frames(20.0, 4), cfg, calib)
    assert np.all(vel[mag <= 0.1 * mag.max()] == 0.0)


def test_decorrelating_voxels_light_up(calib64):
    cfg, calib = calib64
    _, sv = port_run(octa_bscan, *jitter_frames(), cfg, calib)
    kl = calib.klinear.numpy()
    bin50, bin90 = (int(round(d * (kl[-1] - kl[0]) / np.pi)) for d in (50e-6, 90e-6))
    assert sv[bin50 - 1: bin50 + 2].max() > 10 * sv[bin90 - 1: bin90 + 2].max()


@pytest.mark.cuda
@pytest.mark.parametrize("precision,limit_nm", [("highest", 1e-3), ("default", 0.5)])
def test_cuda_doppler_against_float64(cuda, calib64, precision, limit_nm):
    """The card's Doppler ('highest': float32 products; 'default': bf16
    operands) against the port's float64 Doppler on the CPU, where the
    magnitude is above twice the floor, and the step recovered."""
    cfg64, calib = calib64
    frames, bg = moving_frames(30.0, 6)
    want_mag, want = port_run(doppler_bscan, frames, bg, cfg64, calib)
    cfg = PipelineConfig(**{**DOPPLER, "dtype": "float32"})
    mag, vel = port_run(doppler_bscan, frames, bg, cfg, Calibration.create(cfg, cuda),
                        device=cuda, precision=precision)
    strong = want_mag > 0.2 * want_mag.max()
    assert np.abs(vel[strong] - want[strong]).max() * 1e9 <= limit_nm
    peak = np.unravel_index(np.argmax(mag[5:]), mag[5:].shape)
    assert vel[5:][peak] * 1e9 == pytest.approx(30.0, rel=0.2)
