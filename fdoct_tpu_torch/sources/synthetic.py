"""Physics-based interferogram synthesis (fixture factory + demo source).

Implements the Wang & Wu *Biomedical Optics* ch. 9 spectral-domain OCT model
used by the reference's validation scripts (Matlab files/wangOCT.m,
wangOCTimg2.m): a Gaussian source PSD over λ and point backscatterers at
depths ``ls`` produce

    I(λ) = S(λ) · | r_R + Σ_j r_j · exp(i·4π·n_s·ls_j / λ) |²

with r_R = +1 for the normal frame and −1 for the π-shifted frame.  The
:func:`staircase_phantom` reproduces wangOCTimg2.m's stepped-scatterer test
image (depth increases every 10 rows), whose correct B-scan is a known
staircase — the reference's golden fixture (imgi.png / piimgi.png /
backg.png) regenerated from first principles rather than copied.

The port's own copy of ``fdoct_tpu/sources/synthetic.py`` (numpy; scipy only
for the vibrating-scatterer frames): the same functions and the same frames,
bit for bit, for the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np

_TWO_SQRT2LN2 = 2 * np.sqrt(2 * np.log(2))


def wang_lambda_grid(n: int = 1280, lambda0: float = 850e-9,
                     dlambda: float = 20e-9, nsigma: float = 2.0) -> np.ndarray:
    """λ sampling grid of wangOCTimg2.m: λ0 ± nsigma·σ_λ with
    σ_λ = FWHM/√(2·ln2).  Defaults give exactly the sim ini's
    816e-9..884e-9 range."""
    sigma_lambda = dlambda / np.sqrt(2 * np.log(2))
    return lambda0 + sigma_lambda * np.linspace(-nsigma, nsigma, n)


def source_psd(lambdas: np.ndarray, lambda0: float = 850e-9,
               dlambda: float = 20e-9) -> np.ndarray:
    """Gaussian source power spectral density S(λ) (wangOCTimg2.m)."""
    sigma_lambda = dlambda / np.sqrt(2 * np.log(2))
    return np.exp(-0.5 * (lambdas - lambda0) ** 2 / sigma_lambda**2)


def interferogram(lambdas: np.ndarray, depths_m, reflectivities,
                  ns: float = 1.0, r_ref: float = 1.0,
                  lambda0: float = 850e-9, dlambda: float = 20e-9) -> np.ndarray:
    """One A-scan interferogram I(λ) for point scatterers at ``depths_m``."""
    S = source_psd(lambdas, lambda0, dlambda)
    field = np.full(lambdas.shape, complex(r_ref))
    for ls, rs in zip(np.atleast_1d(depths_m), np.atleast_1d(reflectivities)):
        field = field + rs * np.exp(1j * 4 * np.pi * ns * ls / lambdas)
    return S * np.abs(field) ** 2


def interferogram_timeavg(lambdas: np.ndarray, depths_m, reflectivities,
                          vib_amp_m, ns: float = 1.0, r_ref: float = 1.0,
                          lambda0: float = 850e-9, dlambda: float = 20e-9
                          ) -> np.ndarray:
    """Camera-integrated interferogram with sinusoidally vibrating scatterers.

    With exposure ≫ vibration period, each cross term's fringe is multiplied
    by J0(2·k·A) for the vibrating scatterer's amplitude A (the lock-in
    physics the BscanFFTpeak vibrometry inverts, BscanFFTpeak.cpp:615-624):
    ⟨cos(2kz + 2kA·sinωt)⟩_t = J0(2kA)·cos(2kz).  Self terms are unmodulated.
    """
    from scipy.special import j0

    S = source_psd(lambdas, lambda0, dlambda)
    depths = np.atleast_1d(np.asarray(depths_m, float))
    refl = np.atleast_1d(np.asarray(reflectivities, float))
    amps = np.broadcast_to(np.atleast_1d(np.asarray(vib_amp_m, float)),
                           depths.shape)
    k = 2 * np.pi / lambdas
    I = np.full(lambdas.shape, r_ref**2 + np.sum(refl**2))
    bessel = [j0(2 * k * a) for a in amps]
    for j, (zj, rj) in enumerate(zip(depths, refl)):
        I = I + 2 * r_ref * rj * bessel[j] * np.cos(2 * k * ns * zj)
    for i in range(len(depths)):
        for j in range(i + 1, len(depths)):
            I = I + (2 * refl[i] * refl[j] * bessel[i] * bessel[j]
                     * np.cos(2 * k * ns * (depths[i] - depths[j])))
    return S * I


def staircase_phantom(h: int = 960, w: int = 1280, lambda0: float = 850e-9,
                      dlambda: float = 20e-9, rs: tuple[float, float] = (0.5, 0.5),
                      ns: float = 1.0, quantize: bool = True
                      ) -> dict[str, np.ndarray]:
    """Regenerate the wangOCTimg2.m staircase fixtures.

    Returns dict with 'imgi', 'piimgi', 'backg' float (h, w) frames (or
    uint8 when ``quantize``, matching the 8-bit PNGs the simulator reads).
    Rows are grouped in blocks of 10: blocks 1-60 hold scatterer pairs at
    (10·ii, 10·ii+50) µm; blocks 61-96 hold (ii µm, 60 µm)
    (wangOCTimg2.m:40-63).  Every block is normalized by its own max.
    """
    lambdas = wang_lambda_grid(w, lambda0, dlambda)
    S = source_psd(lambdas, lambda0, dlambda)
    imgi = np.zeros((h, w))
    piimgi = np.zeros((h, w))
    backg = np.zeros((h, w))
    nblocks = h // 10
    for ii in range(1, nblocks + 1):
        if ii <= 60:
            ls = (ii * 10e-6, (ii * 10 + 50) * 1e-6)
        else:
            ls = (ii * 1e-6, 60e-6)
        I_l = interferogram(lambdas, ls, rs, ns, +1.0, lambda0, dlambda)
        I_pi = interferogram(lambdas, ls, rs, ns, -1.0, lambda0, dlambda)
        rows = slice((ii - 1) * 10, ii * 10)
        imgi[rows] = I_l / I_l.max()
        piimgi[rows] = I_pi / I_pi.max()
        backg[rows] = S / S.max()
    out = dict(imgi=imgi, piimgi=piimgi, backg=backg)
    if quantize:
        # matlab imwrite quantizes [0,1] doubles with round(x*255)
        out = {k: np.round(v * 255).astype(np.uint8) for k, v in out.items()}
    return out


def wang_fixture(h: int = 96, w: int = 128, lambda0: float = 850e-9,
                 dlambda: float = 20e-9, ns: float = 1.38,
                 rs: tuple[float, float] = (0.5, 0.25),
                 quantize: bool = True) -> dict[str, np.ndarray]:
    """Regenerate the reference's *checked-in* 96×128 16-bit fixtures
    (Matlab files/imgi.png, backg.png), which come from wangOCTimg.m — one
    scatterer pair per ROW at (ii, ii+50) µm with n_s = 1.38 and
    reflectivities (0.5, 0.25); each row normalized by its own max.
    """
    lambdas = wang_lambda_grid(w, lambda0, dlambda)
    S = source_psd(lambdas, lambda0, dlambda)
    imgi = np.zeros((h, w))
    backg = np.zeros((h, w))
    for ii in range(1, h + 1):
        ls = (ii * 1e-6, (ii + 50) * 1e-6)
        I_l = interferogram(lambdas, ls, rs, ns, +1.0, lambda0, dlambda)
        imgi[ii - 1] = I_l / I_l.max()
        backg[ii - 1] = S / S.max()
    out = dict(imgi=imgi, backg=backg)
    if quantize:
        # octave imwrite of doubles → 16-bit PNG here
        out = {k: np.round(v * 65535).astype(np.uint16) for k, v in out.items()}
    return out


@dataclasses.dataclass
class SyntheticSource:
    """Continuous synthetic frame stream (the hardware-free live camera).

    Adds optional per-frame noise, and models a sinusoidally vibrating
    scatterer 0 via camera time-integration: with ``vibration_amp_nm`` set,
    the fringe carries the Bessel-J0(2kA) attenuation the vibrometry plugin
    inverts (see :func:`interferogram_timeavg`;
    BscanFFTpeak.cpp:243-395 physics).
    """

    height: int = 960
    width: int = 1280
    lambda0: float = 850e-9
    dlambda: float = 20e-9
    depths_um: tuple = (90.0, 150.0)
    reflectivities: tuple = (0.5, 0.5)
    noise: float = 0.0
    vibration_amp_nm: float = 0.0
    bpp: int = 8
    seed: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._lambdas = wang_lambda_grid(self.width, self.lambda0, self.dlambda)
        # fixed intensity scale from the still frame: a real camera's counts
        # track absolute intensity, so a vibrating (J0-attenuated) frame must
        # NOT be re-normalized to its own max or the dB drop washes out
        I0 = interferogram(self._lambdas, np.asarray(self.depths_um, float) * 1e-6,
                           self.reflectivities, r_ref=1.0,
                           lambda0=self.lambda0, dlambda=self.dlambda)
        self._scale = I0.max()

    @property
    def _maxval(self) -> int:
        return (1 << self.bpp) - 1

    def _quant(self, x01: np.ndarray) -> np.ndarray:
        x = np.clip(x01, 0.0, 1.0) * self._maxval
        return np.round(x).astype(np.uint8 if self.bpp <= 8 else np.uint16)

    def _frame(self, r_ref: float) -> np.ndarray:
        depths = np.asarray(self.depths_um, float) * 1e-6
        if self.vibration_amp_nm:
            amps = np.zeros_like(depths)
            amps[0] = self.vibration_amp_nm * 1e-9
            I = interferogram_timeavg(self._lambdas, depths, self.reflectivities,
                                      amps, r_ref=r_ref, lambda0=self.lambda0,
                                      dlambda=self.dlambda)
        else:
            I = interferogram(self._lambdas, depths, self.reflectivities,
                              r_ref=r_ref, lambda0=self.lambda0,
                              dlambda=self.dlambda)
        img = np.tile(I / self._scale, (self.height, 1))
        if self.noise:
            img = img + self._rng.normal(0.0, self.noise, img.shape)
        return self._quant(img)

    def frames(self) -> Iterator[np.ndarray]:
        while True:
            yield self._frame(+1.0)

    def background(self) -> np.ndarray:
        S = source_psd(self._lambdas, self.lambda0, self.dlambda)
        return self._quant(np.tile(S / S.max(), (self.height, 1)))

    def pi_frame(self) -> np.ndarray:
        return self._frame(-1.0)
