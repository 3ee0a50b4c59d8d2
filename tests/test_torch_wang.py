"""The port's Wang & Wu estimators (``fdoct_tpu_torch/ops/wang.py``) against
the JAX package's (``fdoct_tpu/ops/wang.py``), and the four-panel physics of
tests/test_wang.py on the port.

Tolerances.  The three estimators in float64 at rtol 1e-12 (atol 1e-12 of
the peak); ``depth_axis`` and the fixture pair exactly equal (both numpy
float64).  The case marked ``cuda`` (it skips here) runs the estimators in
float32 on the card against float64 numpy at rtol 1e-5, atol 1e-5 of the
peak.
"""

import numpy as np
import pytest
import torch

from fdoct_tpu_torch.ops.wang import (
    deconvolved_ift, depth_axis, differential_deconvolved_ift, ift_reflectivity,
    wang_interferogram_pair,
)

NS = 1.38
LS1, LS2 = 90e-6, 150e-6


@pytest.fixture(scope="module")
def jw():
    pytest.importorskip("jax")
    return pytest.importorskip("fdoct_tpu.ops.wang")


@pytest.fixture(scope="module")
def pair():
    I1, I2, S, sigma_k = wang_interferogram_pair(depths_m=(LS1, LS2),
                                                 reflectivities=(0.5, 0.25), ns=NS)
    return I1, I2, S, depth_axis(len(S), sigma_k, ns=NS)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def close(got, want, rtol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


def batch(pair, rows: int = 5, seed: int = 2):
    """The fixture pair in ``rows`` rows, each scaled and noised from a seed."""
    I1, I2, S, _ = pair
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 2.0, (rows, 1))
    return (I1 * scale + rng.normal(0, 1e-3, (rows, I1.size)) * S,
            I2 * scale + rng.normal(0, 1e-3, (rows, I2.size)) * S, S)


ESTIMATORS = {
    "ift_reflectivity": lambda m, I1, I2, S: m.ift_reflectivity(I1),
    "deconvolved_ift": lambda m, I1, I2, S: m.deconvolved_ift(I1, S),
    "differential_deconvolved_ift": lambda m, I1, I2, S: m.differential_deconvolved_ift(I1, I2, S),
}


@pytest.mark.parametrize("rows", [None, 5], ids=["one_row", "batched"])
@pytest.mark.parametrize("name", list(ESTIMATORS))
def test_estimators_match_jax_float64(jw, pair, name, rows):
    import jax.numpy as jnp

    from fdoct_tpu_torch.ops import wang

    arrays = pair[:3] if rows is None else batch(pair, rows)
    got = ESTIMATORS[name](wang, *(torch.as_tensor(a) for a in arrays))
    want = ESTIMATORS[name](jw, *(jnp.asarray(a) for a in arrays))
    assert got.dtype == torch.float64
    close(got.numpy(), np.asarray(want), 1e-12)


@pytest.mark.parametrize("n", [15, 16, 1023, 1024])
def test_depth_axis_and_pair_equal_jax(jw, n):
    for kw in ({}, {"nsigma": 0.5, "ns": 1.0}, {"nsigma": 3.0, "ns": NS}):
        np.testing.assert_array_equal(depth_axis(n, 1.7e5, **kw), jw.depth_axis(n, 1.7e5, **kw))
    got = wang_interferogram_pair(n=n, depths_m=(LS1, LS2), reflectivities=(0.5, 0.25))
    want = jw.wang_interferogram_pair(n=n, depths_m=(LS1, LS2), reflectivities=(0.5, 0.25))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def peak_depth(spec, ls, lo, hi):
    idx = np.flatnonzero((ls > lo) & (ls < hi))
    return ls[idx[np.argmax(np.asarray(spec)[idx])]]


def test_plain_ift_finds_scatterers_plus_dc(pair):
    I1, _, _, ls = pair
    spec = ift_reflectivity(torch.as_tensor(I1)).numpy()
    dbin = ls[1] - ls[0]
    assert abs(ls[np.argmax(spec)]) < dbin
    assert abs(peak_depth(spec, ls, 60e-6, 120e-6) - LS1) < 2 * dbin
    assert abs(peak_depth(spec, ls, 120e-6, 200e-6) - LS2) < 2 * dbin


def test_differential_cancels_dc_and_autocorrelation(pair):
    I1, I2, S, ls = (torch.as_tensor(a) for a in pair)
    ls = ls.numpy()
    deconv = deconvolved_ift(I1, S).numpy()
    diff = differential_deconvolved_ift(I1, I2, S).numpy()
    dbin = ls[1] - ls[0]
    assert abs(peak_depth(diff, ls, 120e-6, 200e-6) - LS2) < 2 * dbin
    dc = np.abs(ls) < 2 * dbin
    assert deconv[dc].max() == deconv.max() and diff[dc].max() < 0.01 * diff.max()


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(ESTIMATORS))
def test_cuda_float32_against_float64_numpy(cuda, pair, name):
    from fdoct_tpu_torch.ops import wang

    arrays = batch(pair, 64)
    got = ESTIMATORS[name](wang, *(torch.as_tensor(a, dtype=torch.float32).to(cuda)
                                   for a in arrays)).cpu().numpy()
    I1, I2, S = arrays
    x = {"ift_reflectivity": I1, "deconvolved_ift": I1 / S,
         "differential_deconvolved_ift": (I1 - I2) / S}[name]
    want = np.abs(np.fft.fftshift(np.fft.ifft(x, axis=-1), axes=-1)) / np.sqrt(x.shape[-1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
