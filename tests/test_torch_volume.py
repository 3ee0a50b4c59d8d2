"""The port's volume analysis, dispersion ops, autofocus and C-scan volume
functions (``volume.py``, ``ops/dispersion.py``, ``autofocus.py``,
``parallel.sharded_cscan_volume*``) against the JAX package's on the same
seeded inputs, on the CPU.

Tolerances.  Index outputs (``ascan_peaks``, ``surface_map``, the sweeps'
winners) exactly equal, ties included (both pick the first maximum).
float64 values rtol 1e-12 where the two compute the same expression, the
C-scan volume rtol 1e-9 (atol 1e-9 of the peak: the port multiplies by the
same float64 M in another summation order); float32 volumes rtol 1e-5
(atol 1e-5 of the peak); sweep scores rtol 1e-4 (a float32 metric of
float32 or complex64 IFFTs).  The int8-direct volume (both packages on one
plan): rtol 1e-5, atol 1e-5 of the peak.  The JAX cases modelled here are
tests/test_volume.py and tests/test_autofocus.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from fdoct_tpu import autofocus as jaf
from fdoct_tpu import volume as jvol
from fdoct_tpu.calibration import Calibration as JaxCalibration
from fdoct_tpu.config import PipelineConfig as JaxConfig
from fdoct_tpu.int8direct import Int8DirectPlan as JaxPlan
from fdoct_tpu.ops import dispersion as jdisp
from fdoct_tpu.parallel import make_mesh, shard_frames
from fdoct_tpu.parallel import sharded_cscan_volume as jax_cscan
from fdoct_tpu.parallel import sharded_cscan_volume_int8 as jax_cscan_int8
from fdoct_tpu.pipeline import apodize_ratio as jax_apodize_ratio
from fdoct_tpu.pipeline import preprocess as jax_preprocess
from fdoct_tpu_torch import autofocus as taf
from fdoct_tpu_torch import volume as tvol
from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.int8direct import Int8DirectPlan
from fdoct_tpu_torch.ops import dispersion as tdisp
from fdoct_tpu_torch.parallel import sharded_cscan_volume, sharded_cscan_volume_int8
from fdoct_tpu_torch.pipeline import apodize_ratio, preprocess
from fdoct_tpu_torch.sources.synthetic import SyntheticSource, wang_lambda_grid

AF = dict(width=256, height=16, averages=1, numfftpoints=512, numdisplaypoints=160,
          lambdamin=816e-9, lambdamax=884e-9, dtype="float64", compat=True)
CS = dict(width=256, height=16, averages=1, numfftpoints=512, numdisplaypoints=128,
          lambdamin=816e-9, lambdamax=884e-9, compat=True)
PLAN_LEAVES = ("oq_re", "oq_im", "s_re", "s_im", "row_gain_inv", "const_re", "const_im",
               "bg_rank1_resid", "oq2_re", "oq2_im", "s2_re", "s2_im", "row_gain2")


def configs(**kw):
    jcfg = JaxConfig(**kw)
    return jcfg, PipelineConfig(**dataclasses.asdict(jcfg))


def allclose(got, want, rtol, atol_frac=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    atol = 0.0 if atol_frac is None else atol_frac * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# volume.py


@pytest.fixture(scope="module")
def volume():
    """tests/test_volume.py's (4 frames, 64 depths, 16 laterals) with a
    bright surface deepening with frame and lateral position, DC junk."""
    F, D, L = 4, 64, 16
    vol = np.random.default_rng(0).uniform(0, 0.1, (F, D, L))
    for f in range(F):
        for x in range(L):
            d = 10 + 2 * f + x // 4
            vol[f, d, x] = 5.0
            vol[f, d + 8, x] = 2.0
    vol[:, :5, :] = 50.0
    return vol


@pytest.fixture(scope="module")
def ties():
    """A volume where every A-scan ties: constant blocks, and two equal
    peaks per A-scan at different depths."""
    vol = np.zeros((3, 40, 6))
    vol[1] = 1.0
    vol[2, 12, :] = vol[2, 30, :] = 7.0
    return vol


@pytest.mark.parametrize("which", ["volume", "ties"])
def test_ascan_peaks_match_jax(which, volume, ties):
    vol = {"volume": volume, "ties": ties}[which]
    for f in range(vol.shape[0]):
        idx, val = tvol.ascan_peaks(torch.as_tensor(vol[f]))
        jidx, jval = jvol.ascan_peaks(jnp.asarray(vol[f]))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    if which == "volume":
        idx, _ = tvol.ascan_peaks(torch.as_tensor(volume[2]))
        assert int(idx[0]) == 14 and int(idx[15]) == 17


@pytest.mark.parametrize("mode,depth_range", [("max", None), ("mean", None), ("sum", None),
                                              ("max", (30, 64)), ("mean", (7, 20))])
def test_enface_projection_matches_jax(mode, depth_range, volume):
    got = tvol.enface_projection(torch.as_tensor(volume), mode, depth_range).numpy()
    allclose(got, jvol.enface_projection(jnp.asarray(volume), mode, depth_range), 1e-12)
    assert got.shape == (4, 16)


def test_enface_bad_mode_raises(volume):
    for fn, v in ((tvol.enface_projection, torch.as_tensor(volume)),
                  (jvol.enface_projection, jnp.asarray(volume))):
        with pytest.raises(ValueError, match="unknown mode"):
            fn(v, "median")


@pytest.mark.parametrize("which,frac", [("volume", 0.5), ("volume", 0.2), ("ties", 0.5),
                                        ("ties", 1.0)])
def test_surface_map_matches_jax_on_ties(which, frac, volume, ties):
    """The map is the argmax of a boolean mask, all ties: the first True
    depth in both packages (a constant A-scan is True everywhere)."""
    vol = {"volume": volume, "ties": ties}[which]
    got = tvol.surface_map(torch.as_tensor(vol), frac).numpy()
    np.testing.assert_array_equal(got, np.asarray(jvol.surface_map(jnp.asarray(vol), frac)))
    if which == "volume":
        assert got[0, 0] == 10 and got[3, 15] == 19
    else:
        assert (got[0] == 5).all() and (got[1] == 5).all() and (got[2] == 12).all()


# ---------------------------------------------------------------------------
# ops/dispersion.py and autofocus.py


def chirped_frames(cfg, a2_true, z=60e-6):
    """tests/test_autofocus.py's interferograms with a known quadratic phase."""
    kl = Calibration.create(cfg, "cpu").klinear.numpy()
    kc, half = (kl[0] + kl[-1]) / 2, (kl[-1] - kl[0]) / 2
    lambdas = wang_lambda_grid(cfg.width)
    k = 2 * np.pi / lambdas
    x = (k - kc) / half
    S = np.exp(-0.5 * ((lambdas - 850e-9) / 17e-9) ** 2)
    fringe = S * (1.25 + np.cos(2 * k * z + a2_true * x**2))
    frame = np.round(np.tile(fringe / fringe.max(), (cfg.height, 1)) * 255).astype(np.uint8)
    return frame, np.maximum(np.tile(S / S.max(), (cfg.height, 1)) * 255, 1.0)


@pytest.fixture(scope="module")
def af():
    jcfg, tcfg = configs(**AF)
    return jcfg, tcfg, JaxCalibration.create(jcfg), Calibration.create(tcfg, "cpu")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_dispersion_ops_match_jax(af, dtype):
    _, _, jcal, tcal = af
    kl = np.asarray(jcal.klinear).astype(dtype)
    rng = np.random.default_rng(4)
    spectra = rng.normal(size=(6, kl.size)).astype(dtype)
    for a2, a3 in ((3.5, 0.0), (-2.0, 1.25)):
        ph = tdisp.dispersion_phase(torch.as_tensor(kl), a2, a3)
        allclose(ph.numpy(), jdisp.dispersion_phase(jnp.asarray(kl), a2, a3),
                 1e-12 if dtype == "float64" else 1e-6, 1e-12)
        z = tdisp.apply_dispersion(torch.as_tensor(spectra), ph)
        jz = jdisp.apply_dispersion(jnp.asarray(spectra), jnp.asarray(ph.numpy()))
        assert z.numpy().dtype == np.asarray(jz).dtype
        allclose(z.numpy(), jz, 1e-12 if dtype == "float64" else 1e-6, 1e-12)
    mag = np.abs(spectra)
    allclose(tdisp.sharpness_metric(torch.as_tensor(mag)).numpy(),
             jdisp.sharpness_metric(jnp.asarray(mag)), 1e-6)
    grid = np.linspace(-8.0, 8.0, 33)
    scores, best = tdisp.dispersion_sweep(torch.as_tensor(spectra), torch.as_tensor(kl),
                                          torch.as_tensor(grid), 100)
    jscores, jbest = jdisp.dispersion_sweep(jnp.asarray(spectra), jnp.asarray(kl),
                                            jnp.asarray(grid), 100)
    allclose(scores.numpy(), jscores, 1e-4)
    assert float(best) == float(jbest)


@pytest.mark.parametrize("a2_true", [5.0, 0.0, -3.0])
def test_sweep_volume_winner_matches_jax(af, a2_true):
    """The chirped case: the same winning index, scores at rtol 1e-4, and
    the winner recovers the chirp (tests/test_autofocus.py)."""
    jcfg, tcfg, jcal, tcal = af
    frame, bg = chirped_frames(tcfg, a2_true)
    grid = np.linspace(-8.0, 8.0, 33)
    scores, best = taf.sweep_volume(torch.as_tensor(frame)[None], torch.as_tensor(bg),
                                    torch.zeros(bg.shape, dtype=torch.float64), tcal, tcfg,
                                    torch.as_tensor(grid))
    jscores, jbest = jaf.sweep_volume(jnp.asarray(frame)[None], jnp.asarray(bg),
                                      jnp.zeros(bg.shape), jcal, jcfg, jnp.asarray(grid))
    assert isinstance(scores, np.ndarray) and scores.shape == (33,)
    allclose(scores, jscores, 1e-4)
    assert int(np.argmax(scores)) == int(np.argmax(jscores)) and best == jbest
    assert best == pytest.approx(a2_true, abs=0.75)


def test_sweep_volume_2d_matches_jax(af):
    jcfg, tcfg, jcal, tcal = af
    frame, bg = chirped_frames(tcfg, 4.0)
    a2, a3 = np.linspace(-6.0, 6.0, 13), np.linspace(-2.0, 2.0, 5)
    scores, b2, b3 = taf.sweep_volume_2d(torch.as_tensor(frame)[None], torch.as_tensor(bg),
                                         torch.zeros(bg.shape, dtype=torch.float64), tcal, tcfg,
                                         a2, a3)
    jscores, jb2, jb3 = jaf.sweep_volume_2d(jnp.asarray(frame)[None], jnp.asarray(bg),
                                            jnp.zeros(bg.shape), jcal, jcfg, jnp.asarray(a2),
                                            jnp.asarray(a3))
    assert scores.shape == (13, 5)
    allclose(scores, jscores, 1e-4)
    assert (b2, b3) == (jb2, jb3)
    assert b2 == pytest.approx(4.0, abs=1.0) and abs(b3) <= 1.0


def test_autofocused_calibration_matches_jax(af):
    jcfg, tcfg, _, _ = af
    got = taf.autofocused_calibration(tcfg, 2.5, -0.75, device="cpu")
    want = jaf.autofocused_calibration(jcfg, 2.5, -0.75)
    for name in ("op_re", "op_im", "phase"):
        allclose(getattr(got, name).numpy(), getattr(want, name), 1e-12, 1e-12)
    assert got.has_phase


def test_segmented_dispersion_matches_jax(af):
    """Two scatterers whose chirps differ with depth (tests/test_autofocus.py
    TestSegmentedDispersion): the per-segment winners equal, the stitched
    magnitudes at rtol 1e-9."""
    jcfg, tcfg, jcal, tcal = af
    kl = tcal.klinear.numpy()
    kc, half = (kl[0] + kl[-1]) / 2, (kl[-1] - kl[0]) / 2
    lambdas = wang_lambda_grid(tcfg.width)
    k = 2 * np.pi / lambdas
    x = (k - kc) / half
    S = np.exp(-0.5 * ((lambdas - 850e-9) / 17e-9) ** 2)
    fringe = S * (2.5 + np.cos(2 * k * 100e-6) + np.cos(2 * k * 450e-6 + 6.0 * x**2))
    frame = np.round(np.tile(fringe / fringe.max(), (tcfg.height, 1)) * 255).astype(np.uint8)
    bg = np.maximum(np.tile(S / S.max(), (tcfg.height, 1)) * 255, 1.0)
    yr = apodize_ratio(preprocess(torch.as_tensor(frame), tcfg), torch.as_tensor(bg),
                       torch.zeros(bg.shape, dtype=torch.float64), tcfg)
    jyr = jax_apodize_ratio(jax_preprocess(jnp.asarray(frame), jcfg), jnp.asarray(bg),
                            jnp.zeros(bg.shape), jcfg)
    grid = np.linspace(-8.0, 8.0, 17)
    best = taf.sweep_per_segment(yr, tcal, torch.as_tensor(grid), n_segments=2).numpy()
    jbest = np.asarray(jaf.sweep_per_segment(jyr, jcal, jnp.asarray(grid), n_segments=2))
    np.testing.assert_array_equal(best, jbest)
    assert abs(best[0]) <= 2.0 and best[1] == pytest.approx(6.0, abs=1.5)
    mags = taf.segmented_dispersion_mags(yr, tcal, torch.as_tensor(best)).numpy()
    allclose(mags, jaf.segmented_dispersion_mags(jyr, jcal, jnp.asarray(jbest)), 1e-9, 1e-9)
    assert mags.shape == (tcfg.height, tcfg.numdisplaypoints)
    with pytest.raises(ValueError, match="segments"):
        taf.segmented_dispersion_mags(yr, tcal, torch.zeros(3, dtype=torch.float64))


# ---------------------------------------------------------------------------
# parallel.sharded_cscan_volume*


@pytest.fixture(scope="module")
def cscan_frames():
    src = SyntheticSource(height=16, width=256, depths_um=(40.0, 90.0),
                          reflectivities=(0.5, 0.3), noise=0.02, seed=11)
    it = src.frames()
    frames = np.stack([next(it) for _ in range(5)])
    return frames, np.maximum(src.background().astype(np.float64), 1.0)


@pytest.mark.parametrize("dtype,normalize,method,rtol",
                         [("float64", False, "fused", 1e-9),
                          ("float64", True, "fused", 1e-9),
                          ("float64", False, "gather", 1e-9),
                          ("float32", False, "fused", 1e-5),
                          ("float32", True, "fused", 1e-5)])
def test_cscan_volume_matches_jax_on_one_device(cscan_frames, dtype, normalize, method, rtol):
    """The JAX function on a 1 × 1 mesh and the port's on the CPU, each
    frame normalized by its own range when ``donotnormalize`` is off."""
    frames, bg = cscan_frames
    jcfg, tcfg = configs(**CS, dtype=dtype, donotnormalize=not normalize)
    bg = bg.astype(dtype)
    jcal = JaxCalibration.create(jcfg)
    tcal = Calibration.create(tcfg, "cpu")
    mesh = make_mesh(1, 1, devices=__import__("jax").devices()[:1])
    want = np.asarray(jax_cscan(shard_frames(jnp.asarray(frames), mesh), jnp.asarray(bg),
                                jnp.zeros_like(jnp.asarray(bg)), jcal, jcfg, mesh,
                                method=method))
    got = sharded_cscan_volume(torch.as_tensor(frames), torch.as_tensor(bg),
                               torch.zeros(bg.shape, dtype=getattr(torch, dtype)), tcal, tcfg,
                               method=method)
    assert got.is_contiguous() and got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (5, 128, 16)
    allclose(got.numpy(), want, rtol, rtol)
    np.testing.assert_array_equal(tvol.surface_map(got).numpy(),
                                  np.asarray(jvol.surface_map(jnp.asarray(got.numpy()))))


def test_cscan_volume_int8_matches_jax_on_one_plan(cscan_frames):
    frames, bg = cscan_frames
    jcfg, tcfg = configs(**CS, dtype="float32", matmul_precision="int8_direct")
    jcal = JaxCalibration.create(jcfg)
    jplan = JaxPlan.create(jcal, jcfg, bg, np.zeros_like(bg))
    tplan = Int8DirectPlan.from_arrays(
        {n: None if getattr(jplan, n) is None else np.asarray(getattr(jplan, n))
         for n in PLAN_LEAVES}, "cpu")
    mesh = make_mesh(1, 1, devices=__import__("jax").devices()[:1])
    want = np.asarray(jax_cscan_int8(shard_frames(jnp.asarray(frames), mesh), jplan, jcfg,
                                     mesh))
    got = sharded_cscan_volume_int8(torch.as_tensor(frames), tplan, tcfg)
    assert tuple(got.shape) == (5, 128, 16) and got.dtype == torch.float32
    allclose(got.numpy(), want, 1e-5, 1e-5)
