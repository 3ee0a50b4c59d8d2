"""The port's spectrometer ingestion (``fdoct_tpu_torch/sources/
spectrometer.py``) against the JAX package's
(``fdoct_tpu/sources/spectrometer.py``) on the same seeded inputs.

Tolerances.  ProcSpec blocks exactly equal; the measured-λ tables exactly
equal (``window`` at rtol 1e-15: the JAX window comes from ``jnp.cos``);
``reconstruct_spectrometer_ascans(device="cpu", dtype=torch.float64)``
against the JAX function (float64 under the tests' x64) at rtol 1e-9, atol
1e-9 of the peak, with and without each of dark, ref, sample and π.  The
case marked ``cuda`` (it skips here) runs it in float32 on the card against
float64 numpy at rtol 1e-5, atol 1e-5 of the peak.
"""

import zipfile

import numpy as np
import pytest
import torch

from fdoct_tpu_torch.sources.spectrometer import (
    calibration_from_lambdas, read_procspec, read_procspec_xml, reconstruct_spectrometer_ascans,
)


@pytest.fixture(scope="module")
def js():
    pytest.importorskip("jax")
    return pytest.importorskip("fdoct_tpu.sources.spectrometer")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def make_procspec_xml(pixels, lambdas=None):
    lines = ['<?xml version="1.0"?>', "<sourceSpectra>", "<pixelValues>"]
    lines += [f"  <double>{v}</double>" for v in pixels]
    lines += ["</pixelValues>"]
    if lambdas is not None:
        lines += ["<wavelengths>"] + [f"  <double>{v}</double>" for v in lambdas]
        lines += ["</wavelengths>"]
    return "\n".join(lines + ["</sourceSpectra>"])


def chirped(n: int, descending: bool = False) -> np.ndarray:
    """A measured, slightly chirped λ vector (tests/test_spectrometer.py)."""
    lam = np.linspace(816e-9, 884e-9, n) + 1e-11 * np.sin(np.linspace(0, 6, n))
    return lam[::-1].copy() if descending else lam


def fringes(n: int, rows: int, seed: int = 5):
    """Seeded A-scans of one scatterer each on the chirped grid, with the
    dark, ref, sample and π frames of the bscan.m flow."""
    rng = np.random.default_rng(seed)
    lam = chirped(n)
    k = 2 * np.pi / lam
    S = np.exp(-0.5 * ((lam - 850e-9) / 17e-9) ** 2)
    z = rng.uniform(30e-6, 120e-6, (rows, 1))
    dark = 5.0 + rng.uniform(0, 0.5, n)
    frame = 1000 * S * (1.25 + np.cos(2 * k * z)) + dark + rng.normal(0, 0.5, (rows, n))
    pi = 1000 * S * (1.25 - np.cos(2 * k * z)) + dark
    return dict(ascans=frame, lambdas_m=lam, dark=dark, ref_arm=500 * S + dark,
                sample_arm=250 * S + dark, pi_frames=pi)


def test_parse_blocks_equal(js):
    rng = np.random.default_rng(1)
    text = make_procspec_xml(rng.normal(size=100), np.linspace(700, 900, 100))
    got, want = read_procspec_xml(text), js.read_procspec_xml(text)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("container", ["xml", "zip"])
@pytest.mark.parametrize("with_lambdas", [False, True])
def test_read_procspec_equal(js, tmp_path, container, with_lambdas):
    rng = np.random.default_rng(2)
    px = rng.normal(size=48)
    lam = np.linspace(800, 860, 48) if with_lambdas else None
    if container == "xml":
        path = tmp_path / "spec.xml"
        path.write_text(make_procspec_xml(px, lam))
    else:
        path = tmp_path / "spec.ProcSpec"
        with zipfile.ZipFile(path, "w") as z:
            z.writestr("ps_12345.xml", make_procspec_xml(px, lam))
    (pixels, lambdas), (jpixels, jlambdas) = read_procspec(path), js.read_procspec(path)
    np.testing.assert_array_equal(pixels, jpixels)
    np.testing.assert_array_equal(pixels, px)
    assert (lambdas is None) == (jlambdas is None) == (not with_lambdas)
    if with_lambdas:
        np.testing.assert_array_equal(lambdas, jlambdas)


def test_read_procspec_without_data_raises(js, tmp_path):
    path = tmp_path / "empty.xml"
    path.write_text("<x>\n</x>\n")
    for fn in (read_procspec, js.read_procspec):
        with pytest.raises(ValueError, match="no <double> data"):
            fn(path)


@pytest.mark.parametrize("descending", [False, True], ids=["ascending", "descending"])
@pytest.mark.parametrize("window", ["barthann", "hann", "rect"])
def test_calibration_tables_equal(js, descending, window):
    lam = chirped(256, descending)
    got = calibration_from_lambdas(lam, nfft=300, ndisp=100, window=window)
    want = js.calibration_from_lambdas(lam, nfft=300, ndisp=100, window=window)
    assert got.keys() == want.keys()
    for key in ("klinear", "nearest_idx", "frac"):
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    np.testing.assert_allclose(got["window"], want["window"], rtol=1e-15, atol=1e-15)
    assert (got["ndisp"], got["nfft"]) == (want["ndisp"], want["nfft"])


def test_linear_signal_interpolates_exactly():
    """Linear in k → exactly linear after resampling (clean convention)."""
    from fdoct_tpu_torch.ops.resample import resample_klinear

    lam = chirped(256)
    tab = calibration_from_lambdas(lam, nfft=300, ndisp=100)
    y = torch.as_tensor((5.0 * 2 * np.pi / lam + 2.0)[None])
    got = resample_klinear(y, torch.as_tensor(tab["nearest_idx"], dtype=torch.long),
                           torch.as_tensor(tab["frac"]), compat=False)[0].numpy()
    np.testing.assert_allclose(got[1:-1], (5.0 * tab["klinear"] + 2.0)[1:-1], rtol=1e-9)


ARMS = {"none": (), "dark": ("dark",), "pi": ("pi_frames",), "ref": ("ref_arm",),
        "sample": ("sample_arm",), "dark_pi": ("dark", "pi_frames"),
        "ref_sample": ("ref_arm", "sample_arm"),
        "all": ("dark", "ref_arm", "sample_arm", "pi_frames")}


@pytest.mark.parametrize("arms", list(ARMS))
def test_reconstruct_matches_jax(js, arms):
    data = fringes(512, 6)
    kw = {name: data[name] for name in ARMS[arms]}
    got = reconstruct_spectrometer_ascans(data["ascans"], data["lambdas_m"], 1024, 400,
                                          device="cpu", dtype=torch.float64, **kw)
    want = np.asarray(js.reconstruct_spectrometer_ascans(data["ascans"], data["lambdas_m"],
                                                         1024, 400, **kw))
    assert isinstance(got, np.ndarray) and got.shape == want.shape == (6, 400)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


def test_reconstruct_finds_scatterer_depth():
    """A fringe at a known depth on the measured λ grid peaks at its bin
    (the cellotape bscan.m flow with dark/ref/sample arms)."""
    n, z = 512, 60e-6
    lam = np.linspace(816e-9, 884e-9, n)
    k = 2 * np.pi / lam
    S = np.exp(-0.5 * ((lam - 850e-9) / 17e-9) ** 2)
    dark = np.full(n, 5.0)
    mags = reconstruct_spectrometer_ascans(
        (S * (1.25 + np.cos(2 * k * z)) + dark)[None], lam, nfft=1024, ndisp=400, dark=dark,
        ref_arm=0.5 * S + dark, sample_arm=0.25 * S + dark,
        pi_frames=(S * (1.25 - np.cos(2 * k * z)) + dark)[None], device="cpu")
    kl = calibration_from_lambdas(lam, 1024, 400)["klinear"]
    assert mags.dtype == np.float32
    assert abs(int(np.argmax(mags[0][4:])) + 4 - z * (kl[-1] - kl[0]) / np.pi) <= 2


def numpy_reference(data: dict, nfft: int, ndisp: int) -> np.ndarray:
    """The bscan.m flow in float64 numpy: the same host stage, then the
    clean linear interpolation and n·|ifft| written out."""
    d = data["dark"]
    a = (data["ascans"] - d) - (data["pi_frames"] - d)
    a = a / ((data["ref_arm"] - d) + (data["sample_arm"] - d))
    tab = calibration_from_lambdas(data["lambdas_m"], nfft, ndisp)
    a = (a - a.mean(axis=-1, keepdims=True)) * tab["window"]
    slope = np.diff(a, axis=-1)
    slope = np.concatenate([slope[:, :1], slope], axis=-1)
    i = tab["nearest_idx"]
    ylin = a[:, i] - tab["frac"] * slope[:, i]
    return (np.abs(np.fft.ifft(ylin, axis=-1)) * nfft)[:, :ndisp]


def test_numpy_reference_is_the_function():
    data = fringes(300, 4)
    got = reconstruct_spectrometer_ascans(**data, nfft=900, ndisp=300, device="cpu",
                                          dtype=torch.float64)
    want = numpy_reference(data, 900, 300)
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9 * np.abs(want).max())


@pytest.mark.cuda
def test_cuda_float32_against_float64_numpy(cuda):
    data = fringes(3648, 64)
    got = reconstruct_spectrometer_ascans(**data, nfft=3 * 3648, ndisp=3648, device=cuda)
    want = numpy_reference(data, 3 * 3648, 3648)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
