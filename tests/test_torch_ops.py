"""The port's scale and filter ops against ``fdoct_tpu.ops``, in float64."""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the JAX reference; without it (a GPU-only host) skip

from fdoct_tpu.ops import filters as jf
from fdoct_tpu.ops import scale as js
from fdoct_tpu_torch.ops import filters as tf
from fdoct_tpu_torch.ops import scale as ts


@pytest.fixture(scope="module")
def x64():
    rng = np.random.default_rng(7)
    return rng.normal(size=(3, 12, 20)) * 10.0


def both(fn_j, fn_t, x, *args, **kw):
    want = np.asarray(fn_j(jnp.asarray(x), *args, **kw))
    got = fn_t(torch.as_tensor(x), *args, **kw)
    return got.numpy(), want


@pytest.mark.parametrize("compat", [True, False])
def test_to_db(x64, compat):
    got, want = both(js.to_db, ts.to_db, np.abs(x64), eps=1e-5, compat=compat)
    np.testing.assert_allclose(got, want, rtol=1e-13)


@pytest.mark.parametrize("axis", [None, -1, (-2, -1)])
def test_normalize_minmax(x64, axis):
    got, want = both(js.normalize_minmax, ts.normalize_minmax, x64, 0.0001, 1.0, axis=axis)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)


def test_normalize_minmax_constant_maps_to_lo():
    x = np.full((4, 5), 3.0)
    got, want = both(js.normalize_minmax, ts.normalize_minmax, x, 0.25, 1.0)
    np.testing.assert_array_equal(got, want)
    assert (got == 0.25).all()


def test_normalize_rows(x64):
    got, want = both(js.normalize_rows, ts.normalize_rows, x64, 0.0, 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)


def test_minmax_pair(x64):
    lo, hi = ts.minmax_pair(torch.as_tensor(x64))
    jlo, jhi = js.minmax_pair(jnp.asarray(x64))
    assert float(lo) == float(jlo) and float(hi) == float(jhi)


@pytest.mark.parametrize("fn", ["make_only_positive", "mask_dc_rows"])
def test_elementwise(x64, fn):
    got, want = both(getattr(js, fn), getattr(ts, fn), x64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thresh", [-3.0, 0.5, -np.inf])
def test_threshold_floor(x64, thresh):
    got, want = both(js.threshold_floor, ts.threshold_floor, x64, thresh)
    np.testing.assert_array_equal(got, want)


def test_clamp_pixel(x64):
    got, want = both(js.clamp_pixel, ts.clamp_pixel, x64, 50.0)
    np.testing.assert_array_equal(got, want)


def test_to_uint8_rounds_half_to_even():
    # exact halves (k + 0.5)/255 and out-of-range values
    x = np.concatenate([(np.arange(256) + 0.5) / 255.0,
                        np.random.default_rng(3).uniform(-0.2, 1.2, 500)])
    got, want = both(js.to_uint8, ts.to_uint8, x)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0 and got[1] == 2         # 0.5 → 0, 1.5 → 2


@pytest.mark.parametrize("n", [1, 3, 9])
def test_smooth_moving_average(x64, n):
    got, want = both(jf.smooth_moving_average, tf.smooth_moving_average, x64, n)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("ksize", [1, 3, 5])
@pytest.mark.parametrize("dtype", [np.uint8, np.float64])
def test_median_blur(ksize, dtype):
    img = np.random.default_rng(ksize).integers(0, 255, (2, 9, 14)).astype(dtype)
    got, want = both(jf.median_blur, tf.median_blur, img, ksize)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_median_blur_even_aperture_raises():
    with pytest.raises(ValueError, match="odd"):
        tf.median_blur(torch.zeros(4, 4), 4)


@pytest.mark.parametrize("bx,by", [(1, 1), (2, 2), (4, 2), (2, 3)])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float64])
def test_bin_area(bx, by, dtype):
    img = np.random.default_rng(bx * 10 + by).integers(0, 255, (2, 12, 16)).astype(dtype)
    got, want = both(jf.bin_area, tf.bin_area, img, bx, by)
    assert got.dtype == want.dtype
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-15)
    else:
        np.testing.assert_array_equal(got, want)


def test_bin_area_indivisible_raises():
    with pytest.raises(ValueError, match="not divisible"):
        tf.bin_area(torch.zeros(5, 8), 2, 2)


@pytest.mark.parametrize("channelnum", [0, 1, 2, 3])
def test_channel_select(channelnum):
    frame = np.random.default_rng(channelnum).integers(0, 255, (2, 6, 8, 3)).astype(np.uint8)
    got, want = both(jf.channel_select, tf.channel_select, frame, channelnum)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    gray = frame[0, ..., 0]
    np.testing.assert_array_equal(tf.channel_select(torch.as_tensor(gray), channelnum).numpy(),
                                  gray)
