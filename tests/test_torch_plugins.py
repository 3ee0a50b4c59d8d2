"""The port's copies of the JAX package's plugins (ROI analytics, J-mask,
vibrometry), each against its original on the same seeded inputs, fed with
results whose B-scans are numpy arrays and with results whose B-scans are
CPU tensors (as a port session gives them; on a card they are CUDA tensors,
which the copies slice before moving to the host).

Tolerance: the plugin state (strip chart, holds, profiles, masks, status
lines) is exactly equal when both are fed the same numbers.  The full
three-hold displacement runs a float64 JAX session and a float64 port
session on the same frames: their dB B-scans agree to ~1e-12, so the holds
agree to rtol 1e-9 and the displacement and its profile to rtol 1e-6.
"""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from fdoct_tpu.config import PipelineConfig as JaxConfig
from fdoct_tpu.plugins import JMaskPlugin as JaxJMask
from fdoct_tpu.plugins import ROIPlugin as JaxROI
from fdoct_tpu.plugins import VibrometryPlugin as JaxVibrometry
from fdoct_tpu.plugins import vibrometry as jvib
from fdoct_tpu.plugins.roi import ascan_min_max as jax_ascan_min_max
from fdoct_tpu.plugins.roi import roi_mean_db as jax_roi_mean_db
from fdoct_tpu.session import Session as JaxSession
from fdoct_tpu.sinks import RunWriter as JaxRunWriter
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.plugins import JMaskPlugin, ROIPlugin, VibrometryPlugin, vibrometry
from fdoct_tpu_torch.plugins.roi import ascan_min_max, roi_mean_db
from fdoct_tpu_torch.session import Session
from fdoct_tpu_torch.sinks import RunWriter
from fdoct_tpu_torch.sources.synthetic import SyntheticSource

AS = {"numpy": np.asarray, "tensor": torch.as_tensor}


@dataclasses.dataclass
class Calib:
    ndisp: int


class FakeSession:
    """The session fields the plugins read, and its status feed."""

    def __init__(self, ndisp=40, sink=None):
        self.ROIreport = True
        self.ascanat, self.vertposROI, self.widthROI = 2, 10, 3
        self.calib = Calib(ndisp)
        self.jlockin = False
        self.sink = sink
        self.status = []

    def _say(self, text):
        self.status.append(text)


@dataclasses.dataclass
class Result:
    bscandb: object
    bscandisp: np.ndarray
    sub_disp: np.ndarray | None = None


def db_stream(n, shape=(40, 12), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-10.0, 55.0, shape).astype(np.float32) for _ in range(n)]


# ---------------------------------------------------------------------------
# functions


def test_vibrometry_functions_equal():
    y = np.linspace(0.0, 40.0, 97)
    np.testing.assert_array_equal(vibrometry.bessel_db_inverse(y), jvib.bessel_db_inverse(y))
    for v in (0.0, 3.3, 29.9, 45.0):
        assert vibrometry.bessel_db_inverse(v) == jvib.bessel_db_inverse(v)
        assert vibrometry.errnull(v) == jvib.errnull(v)
    np.testing.assert_array_equal(vibrometry.displacement_nm(y, 850e-9),
                                  jvib.displacement_nm(y, 850e-9))
    prof = np.random.default_rng(1).uniform(-150, 150, 33)
    np.testing.assert_array_equal(vibrometry.render_vib_profile(prof),
                                  jvib.render_vib_profile(prof))


@pytest.mark.parametrize("kind", list(AS))
def test_roi_functions_equal(kind):
    for b in db_stream(3, (20, 30)):
        b[0, 3] = 99.0
        for ascanat in (0, 3, 29):
            assert ascan_min_max(AS[kind](b), ascanat, 20) == jax_ascan_min_max(b, ascanat, 20)
            assert ascan_min_max(AS[kind](b), ascanat, 12) == jax_ascan_min_max(b, ascanat, 12)
        for args in ((4, 10, 10), (25, 10, 10), (0, 0, 29), (3, 15, 5, 8)):
            assert roi_mean_db(AS[kind](b), *args) == jax_roi_mean_db(b, *args)


# ---------------------------------------------------------------------------
# plugins fed the same results


@pytest.mark.parametrize("kind", list(AS))
def test_roi_plugin_equal(kind):
    port, jax = ROIPlugin(), JaxROI()
    ps, js = FakeSession(), FakeSession()
    for i, b in enumerate(db_stream(650)):
        if i == 5:
            for s in (ps, js):
                s.widthROI = 11                      # off the image for a while
        if i == 9:
            for s in (ps, js):
                s.widthROI, s.ROIreport = 3, False
        if i == 12:
            for s in (ps, js):
                s.ROIreport = True
        port.on_bscan(ps, Result(AS[kind](b), None))
        jax.on_bscan(js, Result(b, None))
        assert (port.last_mean, port.last_minmax) == (jax.last_mean, jax.last_minmax)
    assert port.col == jax.col and np.array_equal(port.plot, jax.plot)
    assert ps.status == js.status and not port.key(ps, "e")


def test_jmask_plugin_equal():
    port, jax = JMaskPlugin(), JaxJMask()
    ps, js = FakeSession(), FakeSession()
    rng = np.random.default_rng(2)
    for i in range(12):
        disp = rng.integers(0, 256, (40, 12), dtype=np.uint8)
        if i in (2, 8):
            ps.jlockin = js.jlockin = True
        if i == 6:
            ps.jlockin = js.jlockin = False
        pr, jr = Result(None, disp.copy()), Result(None, disp.copy())
        port.on_bscan(ps, pr)
        jax.on_bscan(js, jr)
        assert port.active == jax.active
        assert (pr.sub_disp is None) == (jr.sub_disp is None)
        if pr.sub_disp is not None:
            assert np.array_equal(pr.sub_disp, jr.sub_disp)


@pytest.mark.parametrize("kind", list(AS))
def test_vibrometry_plugin_keys_holds_and_saves_equal(kind, tmp_path):
    """Every key of the plugin, four holds on the same dB stream, and the
    'z' save: the same holds, profiles, status lines and saved files."""
    sinks = {"port": RunWriter(tmp_path / "p", "vib", timestamp=1e9),
             "jax": JaxRunWriter(tmp_path / "j", "vib", timestamp=1e9)}
    port, jax = VibrometryPlugin(850e-9, 6), JaxVibrometry(850e-9, 6)
    ps, js = FakeSession(sink=sinks["port"]), FakeSession(sink=sinks["jax"])
    stream = iter(db_stream(200, seed=4))

    def both(fn):
        a, b = fn(port, ps), fn(jax, js)
        assert a == b
        return a

    both(lambda p, s: p.key(s, "1"))                      # refused: no ROI yet
    for ch in "><>,.,M?/mMv!@#$":
        both(lambda p, s: p.key(s, ch))
    both(lambda p, s: p.set_roi(2, 5, 4, 20))
    for hold in "1234":
        both(lambda p, s: p.key(s, hold))
        while jax.active_hold is not None:
            b = next(stream)
            port.on_bscan(ps, Result(AS[kind](b), None))
            jax.on_bscan(js, Result(b, None))
            assert port.active_hold == jax.active_hold and port.frame_count == jax.frame_count
        assert port.maxval == jax.maxval
        for a, b in zip(port.maxvals, jax.maxvals):
            np.testing.assert_array_equal(a, b)
        assert port.dispnm == jax.dispnm and port.errnm == jax.errnm
        np.testing.assert_array_equal(port.profile, jax.profile)
    both(lambda p, s: p.key(s, "z"))
    both(lambda p, s: p.key(s, "q"))                      # not the plugin's
    assert ps.status == js.status
    sinks["port"].close()
    sinks["jax"].close()
    names = sorted(f.name for f in sinks["port"].dir.iterdir())
    assert names == sorted(f.name for f in sinks["jax"].dir.iterdir())
    assert (sinks["port"].dir / "BscanFFT.m").read_bytes() == \
        (sinks["jax"].dir / "BscanFFT.m").read_bytes()
    from fdoct_tpu.utils.imageio import read_png
    assert np.array_equal(read_png(sinks["port"].dir / "vibrprof001.png"),
                          read_png(sinks["jax"].dir / "vibrprof001.png"))


def test_vibrometry_three_hold_displacement_matches_jax():
    """tests/test_plugins.py's full-physics case on both packages: a still
    source for holds 1-2, a vibrating one for hold 3, each through a float64
    'peak' session; the displacement agrees and is within 25 % of the
    source's amplitude."""
    kw = dict(width=256, height=8, averages=1, numfftpoints=512, numdisplaypoints=160,
              dtype="float64", compat=True, peakholdnumframes=40)
    jcfg = JaxConfig(**kw)
    tcfg = PipelineConfig(**dataclasses.asdict(jcfg))
    amp_nm = 60.0
    still = dict(height=8, width=256, depths_um=(40.0,), reflectivities=(0.5,), seed=3)
    bg = np.maximum(SyntheticSource(**still).background().astype(np.float64), 1.0)
    sessions = {"jax": JaxSession(jcfg, variant="peak"),
                "port": Session(tcfg, device="cpu", variant="peak")}
    sessions["jax"].data_yb = jnp.asarray(bg)
    sessions["port"].data_yb = torch.as_tensor(bg)
    for s in sessions.values():
        s.ascanat = 4
        s.set_roi(2, 10, 4, 140)
        for key, vib in (("1", 0.0), ("2", 0.0), ("3", amp_nm)):
            s.key(key)
            src = SyntheticSource(**{**still, "seed": 3 if vib == 0.0 else 4},
                                  vibration_amp_nm=vib)
            it = iter(src.frames())
            for _ in range(kw["peakholdnumframes"]):
                s.process(next(it))
            assert s.plugins[0].active_hold is None
    jp, tp = sessions["jax"].plugins[0], sessions["port"].plugins[0]
    assert isinstance(tp, VibrometryPlugin)
    np.testing.assert_allclose(tp.maxval[:3], jp.maxval[:3], rtol=1e-9)
    for a, b in zip(tp.maxvals[:3], jp.maxvals[:3]):
        np.testing.assert_allclose(a, b, rtol=1e-9)
    assert tp.dispnm == pytest.approx(jp.dispnm, rel=1e-6)
    assert tp.errnm == pytest.approx(jp.errnm, rel=1e-6, abs=1e-9)
    np.testing.assert_allclose(tp.profile, jp.profile, rtol=1e-6)
    assert tp.dispnm == pytest.approx(amp_nm, rel=0.25) and tp.profile.shape == (4,)
    # the fps lines depend on each session's wall clock
    assert ([m for m in sessions["port"].status if not m.startswith("fps")]
            == [m for m in sessions["jax"].status if not m.startswith("fps")])
