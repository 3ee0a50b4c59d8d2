"""The port's fused path against the independent numpy oracle
(``tests/oracle.py``, the loop-level transcription of the reference's
formulas), on the CPU in float64, as ``tests/test_pipeline.py`` holds the
JAX package to it.

The fused path (one float64 operator M composing DC removal, window,
zero-pad, resample and the truncated inverse DFT) is held at the JAX fused
path's tolerance against the oracle: rtol 1e-7, atol 1e-7·max
(tests/test_pipeline.py:52).  The port's float64 M is built in numpy and
reaches ~5e-15 of that scale in every case here, so the tolerance is the
contract the JAX package states, not what rounding needs.  The gather path
(k-interpolation, then an FFT) is held at the JAX gather tolerance, 1e-9
(tests/test_pipeline.py:42-86): a single frame, zero-pad with binning, a
moving average.
"""

import numpy as np
import pytest
import torch

import oracle
from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.pipeline import form_bscan, reconstruct, reconstruct_bscan, reconstruct_group
from fdoct_tpu_torch.sources.synthetic import SyntheticSource

TOL = 1e-7
GATHER_TOL = 1e-9


@pytest.fixture(scope="module")
def sim_cfg():
    """Scaled-down BscanFFTsim configuration, tests/test_pipeline.py's."""
    return PipelineConfig(
        width=256, height=32, binvalue=1, averages=1,
        numfftpoints=512, numdisplaypoints=160,
        lambdamin=816e-9, lambdamax=884e-9,
        increasefftpointsmultiplier=1, mediann=0, movavgn=0,
        donotnormalize=True, dtype="float64", compat=True,
    )


@pytest.fixture(scope="module")
def sim_frames(sim_cfg):
    src = SyntheticSource(height=sim_cfg.height, width=sim_cfg.width,
                          depths_um=(40.0, 80.0), noise=0.0)
    it = src.frames()
    return [next(it) for _ in range(3)], src.background(), src.pi_frame()


def run(raw, backg, piimg, cfg, method="fused"):
    """The port's per-frame magnitudes, float64, on the CPU."""
    calib = Calibration.create(cfg, "cpu")
    return reconstruct(torch.as_tensor(raw), torch.as_tensor(backg, dtype=torch.float64),
                       torch.as_tensor(piimg, dtype=torch.float64), calib, cfg, method).numpy()


def assert_close(got, want, tol=TOL):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max())


def oracle_run(raw, backg, piimg, cfg, **kw):
    return oracle.bscan_pipeline(raw, backg, piimg, cfg.lambdamin, cfg.lambdamax,
                                 cfg.numfftpoints, cfg.numdisplaypoints, **kw)


def test_single_frame_matches_oracle(sim_cfg, sim_frames):
    frames, backg, piimg = sim_frames
    got = run(frames[0], backg, piimg, sim_cfg)
    assert got.dtype == np.float64
    assert_close(got, oracle_run(frames[0], backg, piimg, sim_cfg)["mag"])


def test_with_zeropad_and_binning():
    cfg = PipelineConfig(width=128, height=16, binvalue=2, numfftpoints=256,
                         numdisplaypoints=80, increasefftpointsmultiplier=2,
                         dtype="float64", compat=True)
    rng = np.random.default_rng(21)
    raw = rng.integers(0, 255, size=(cfg.height, cfg.width)).astype(np.uint8)
    backg = np.full((cfg.oph, cfg.opw), 100.0)
    piimg = np.zeros((cfg.oph, cfg.opw))
    assert_close(run(raw, backg, piimg, cfg),
                 oracle_run(raw, backg, piimg, cfg, binvalue=2, mult=2)["mag"])


def test_with_movavg():
    cfg = PipelineConfig(width=96, height=8, numfftpoints=128, numdisplaypoints=48, movavgn=3,
                         dtype="float64", compat=True)
    rng = np.random.default_rng(22)
    raw = rng.integers(0, 255, size=(8, 96)).astype(np.uint8)
    backg = np.full((8, 96), 50.0)
    piimg = np.zeros((8, 96))
    assert_close(run(raw, backg, piimg, cfg), oracle_run(raw, backg, piimg, cfg, movavgn=3)["mag"])


def test_form_bscan_matches_oracle(sim_cfg, sim_frames):
    frames, backg, piimg = sim_frames
    out = form_bscan(torch.as_tensor(run(frames[0], backg, piimg, sim_cfg)), sim_cfg, averages=1)
    want = oracle_run(frames[0], backg, piimg, sim_cfg)
    assert_close(out.bscan.numpy(), want["bscan"])
    assert_close(out.bscandb.numpy(), want["bscandb"])
    assert out.bscandisp.dtype == torch.uint8


def test_group_matches_oracle(sim_cfg, sim_frames):
    """Three distinct frames through the group step and the averaged B-scan:
    the oracle's per-frame magnitudes summed, ÷3, +1e-5, dB."""
    frames, backg, piimg = sim_frames
    mags = [oracle_run(f, backg, piimg, sim_cfg)["mag"] for f in frames]
    calib = Calibration.create(sim_cfg, "cpu")
    args = (torch.as_tensor(np.stack(frames)), torch.as_tensor(backg, dtype=torch.float64),
            torch.as_tensor(piimg, dtype=torch.float64), calib, sim_cfg)
    assert_close(reconstruct_group(*args).numpy(), sum(mags))
    bscan = sum(mags).T / 3 + 1e-5
    bscandb = 20.0 * np.log(bscan) / 2.303
    bscandb[:2] = bscandb[4]
    out = reconstruct_bscan(*args)
    assert_close(out.bscan.numpy(), bscan)
    assert_close(out.bscandb.numpy(), bscandb)


def test_gather_single_frame_matches_oracle(sim_cfg, sim_frames):
    frames, backg, piimg = sim_frames
    got = run(frames[0], backg, piimg, sim_cfg, "gather")
    assert got.dtype == np.float64
    assert_close(got, oracle_run(frames[0], backg, piimg, sim_cfg)["mag"], GATHER_TOL)


def test_gather_with_zeropad_and_binning():
    cfg = PipelineConfig(width=128, height=16, binvalue=2, numfftpoints=256,
                         numdisplaypoints=80, increasefftpointsmultiplier=2,
                         dtype="float64", compat=True)
    rng = np.random.default_rng(21)
    raw = rng.integers(0, 255, size=(cfg.height, cfg.width)).astype(np.uint8)
    backg = np.full((cfg.oph, cfg.opw), 100.0)
    piimg = np.zeros((cfg.oph, cfg.opw))
    assert_close(run(raw, backg, piimg, cfg, "gather"),
                 oracle_run(raw, backg, piimg, cfg, binvalue=2, mult=2)["mag"], GATHER_TOL)


def test_gather_with_movavg():
    cfg = PipelineConfig(width=96, height=8, numfftpoints=128, numdisplaypoints=48, movavgn=3,
                         dtype="float64", compat=True)
    rng = np.random.default_rng(22)
    raw = rng.integers(0, 255, size=(8, 96)).astype(np.uint8)
    backg = np.full((8, 96), 50.0)
    piimg = np.zeros((8, 96))
    assert_close(run(raw, backg, piimg, cfg, "gather"),
                 oracle_run(raw, backg, piimg, cfg, movavgn=3)["mag"], GATHER_TOL)


def test_gather_form_bscan_matches_oracle(sim_cfg, sim_frames):
    frames, backg, piimg = sim_frames
    out = form_bscan(torch.as_tensor(run(frames[0], backg, piimg, sim_cfg, "gather")), sim_cfg,
                     averages=1)
    want = oracle_run(frames[0], backg, piimg, sim_cfg)
    assert_close(out.bscan.numpy(), want["bscan"], GATHER_TOL)
    assert_close(out.bscandb.numpy(), want["bscandb"], GATHER_TOL)
