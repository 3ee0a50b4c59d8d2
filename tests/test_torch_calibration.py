"""The port's Calibration against the JAX package's, in float64."""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the JAX reference; without it (a GPU-only host) skip

from fdoct_tpu.calibration import Calibration as JaxCalibration
from fdoct_tpu.calibration import reference_grids as jax_reference_grids
from fdoct_tpu.ops import windows as jax_windows
from fdoct_tpu_torch.calibration import Calibration, reference_grids
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.ops import windows

LEAVES = ("op_re", "op_im", "window", "nearest_idx", "frac", "phase",
          "lambdas", "k", "klinear")


def torch_cfg(jcfg):
    return PipelineConfig(**dataclasses.asdict(jcfg))


@pytest.fixture(scope="module", params=["small", "dispersion", "bandpass_clean"])
def cfg_pair(request, small_cfg):
    jcfg = {
        "small": small_cfg,
        "dispersion": small_cfg.replace(dispersion_a2=3.0, dispersion_a3=-1.5,
                                        window="tukey"),
        "bandpass_clean": small_cfg.replace(bandpassfilter=True, compat=False,
                                            window="blackmanharris"),
    }[request.param]
    return jcfg, torch_cfg(jcfg)


def test_create_matches_jax(cfg_pair):
    jcfg, tcfg = cfg_pair
    want = JaxCalibration.create(jcfg, dtype="float64")
    got = Calibration.create(tcfg, "cpu", torch.float64)
    for name in LEAVES:
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=1e-12 * np.abs(w).max(),
                                   err_msg=name)
    for name in ("n_raw", "n_in", "nfft", "ndisp", "mult", "compat",
                 "bandpassfilter", "has_phase"):
        assert getattr(got, name) == getattr(want, name), name


def test_reference_grids_match_jax(small_cfg):
    want = jax_reference_grids(small_cfg)
    got = reference_grids(torch_cfg(small_cfg))
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(want[name]))


def test_from_arrays_round_trips_jax_leaves(small_cfg):
    jcal = JaxCalibration.create(small_cfg, dtype="float64")
    arrays = {name: np.asarray(getattr(jcal, name)) for name in LEAVES}
    cal = Calibration.from_arrays(arrays, torch_cfg(small_cfg), "cpu", torch.float64)
    for name in LEAVES:
        np.testing.assert_array_equal(getattr(cal, name).numpy(), arrays[name])
    assert cal.op_re_bf16.dtype == torch.bfloat16
    np.testing.assert_array_equal(cal.op_re_bf16.float().numpy(),
                                  cal.op_re.to(torch.bfloat16).float().numpy())
    assert (cal.ndisp, cal.n_raw, cal.has_phase) == (jcal.ndisp, jcal.n_raw, jcal.has_phase)


def test_create_float32_is_the_rounded_float64(small_cfg):
    tcfg = torch_cfg(small_cfg)
    c64 = Calibration.create(tcfg, "cpu", torch.float64)
    c32 = Calibration.create(tcfg, "cpu", torch.float32)
    assert c32.op_re.dtype == torch.float32 and c32.nearest_idx.dtype == torch.int64
    np.testing.assert_array_equal(c32.op_im.numpy(), c64.op_im.float().numpy())


def test_int8_tables_not_ported(small_cfg):
    """The int8 operator tables are carried to the device only for
    matmul_precision='int8' (they cost device memory), as in the JAX
    package; there they match its tables."""
    for precision in ("default", "bf16", "int8_direct"):
        cal = Calibration.create(torch_cfg(small_cfg.replace(matmul_precision=precision)), "cpu")
        assert cal.op_re_q is None and cal.op_scale_im is None, precision
    jcfg = small_cfg.replace(matmul_precision="int8")
    want = JaxCalibration.create(jcfg)
    got = Calibration.create(torch_cfg(jcfg), "cpu")
    for name in ("op_re_q", "op_im_q"):
        assert getattr(got, name).dtype == torch.int8
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    for name in ("op_scale_re", "op_scale_im"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                   rtol=1e-6)


@pytest.mark.parametrize("kind", sorted(jax_windows._WINDOWS))
@pytest.mark.parametrize("n", [1, 2, 7, 256])
def test_windows_match_jax(kind, n):
    want = np.asarray(jax_windows.get_window(kind, n, dtype=jnp.float64))
    np.testing.assert_allclose(windows.get_window(kind, n), want, rtol=1e-13, atol=1e-15)


def test_unknown_window_raises():
    with pytest.raises(ValueError, match="unknown window"):
        windows.get_window("kaiser", 8)
