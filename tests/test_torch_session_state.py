"""The rest of the session state machine, JAX ``Session`` against the port's
``Session(device="cpu")`` on the same seeded frames: the dark, peak and
spinj variants; captures ('b' from the ring, 'o'/'r'/'t'); J-lockin; every
key; saves ('s', the rings, manual averaging) into run directories;
triggered captures and the offline hand-off; output rebinning;
``config_snapshot``/``apply_config``/``set_roi``; plugins; the fast path
against per-frame ``process`` for each flag; and the int8-direct mode of the
dark variant.  The JAX tests modelled here are tests/test_session.py
(TestCaptures, TestJLockin, TestKeys, TestSaves), tests/test_session_group.py
(test_dark_variant_parity, TestFastPathStatefulFlags,
test_plugins_run_per_group) and tests/test_spinj.py.

Tolerances.  float64 sessions ('highest'): linear B-scans, session tensors
and ring contents rtol 1e-9 (atol 1e-9 of the peak), dB within 1e-8 on
pixels within 40 dB of the peak, uint8 displays (and the subtracted and
manual displays) within one level.  Written run directories: the same file
names; ``.npz``, ``.ocv`` and ``.xml`` data at rtol 1e-9, ``.m`` text with
the same names and footer and its numbers (printed to 10 digits) at rtol
1e-8; raw-frame PNGs (rawframe*, Trig*) exact, display PNGs within one
level, JET PNGs within 8 (one display level moves a JET channel by up to
~4).  The port's fast path against its own per-frame path: rtol 1e-12 and
equal displays.  int8-direct (both packages on one M, so one plan): as
tests/test_torch_session.py.  The group routes the new paths take, and their
runs on the card, are in tests/test_torch_session_routes.py.
"""

import dataclasses
import re
import subprocess

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from fdoct_tpu.config import PipelineConfig as JaxConfig
from fdoct_tpu.ops.filters import bscan_rebin as jax_bscan_rebin
from fdoct_tpu.ops.filters import resize_bicubic as jax_resize_bicubic
from fdoct_tpu.session import Session as JaxSession
from fdoct_tpu.sinks import RunWriter as JaxRunWriter
from fdoct_tpu.utils.cvxml import read_xml as jax_read_xml
from fdoct_tpu.utils.imageio import read_png as jax_read_png
from fdoct_tpu.utils.ocv_io import matread as jax_matread
from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.int8direct import reconstruct_int8_direct, shift_u8_to_s8
from fdoct_tpu_torch.ops.filters import bscan_rebin, resize_bicubic
from fdoct_tpu_torch.pipeline import preprocess
from fdoct_tpu_torch.session import VARIANTS, BscanResult, Session, jlockin_batch
from fdoct_tpu_torch.sinks import RunWriter
from fdoct_tpu_torch.sources.synthetic import SyntheticSource
from fdoct_tpu_torch.utils.imageio import read_png

CFG = dict(width=128, height=16, binvalue=1, averages=3, numfftpoints=256, numdisplaypoints=80,
           dtype="float64", compat=True)
TS = 1_700_000_000.0
TOL = 1e-9


class FixedSource:
    """Background and π frames drawn once, so that both sessions capture
    the same noisy frames."""

    def __init__(self, src):
        self._background, self._pi = src.background(), src.pi_frame()

    def background(self):
        return self._background

    def pi_frame(self):
        return self._pi


@pytest.fixture(scope="module")
def data():
    src = SyntheticSource(height=16, width=128, depths_um=(40.0,), reflectivities=(0.5,),
                          noise=0.02, seed=5)
    it = src.frames()
    # no zero count, so that no captured background holds a zero to divide by
    frames = np.maximum(np.stack([next(it) for _ in range(64)]), 1)
    return FixedSource(src), frames, np.maximum(src.background(), 1).astype(np.float64)


def pair(tmp_path=None, variant="base", fmt="npz", source=None, calls=None, **extra):
    """A JAX and a port session on the same config, each with its own run
    directory (same timestamp) when ``tmp_path`` is given and its camera
    callback appending to ``calls[name]``."""
    jcfg = JaxConfig(**{**CFG, **extra})
    tcfg = PipelineConfig(**dataclasses.asdict(jcfg))
    kw = {"jax": {"source": source}, "port": {"source": source}}
    if tmp_path is not None:
        kw["jax"]["sink"] = JaxRunWriter(tmp_path / "jax", "state", fmt=fmt, timestamp=TS)
        kw["port"]["sink"] = RunWriter(tmp_path / "port", "state", fmt=fmt, timestamp=TS)
    if calls is not None:
        for name in kw:
            calls[name] = []
            kw[name]["camera"] = lambda p, v, _c=calls[name]: _c.append((p, v))
    return (JaxSession(jcfg, variant=variant, **kw["jax"]),
            Session(tcfg, device="cpu", variant=variant, **kw["port"]))


def prime(js, ts, bg, dark=None):
    js.data_yb, ts.data_yb = jnp.asarray(bg), torch.as_tensor(bg)
    if dark is not None:
        js.data_yd, ts.data_yd = jnp.asarray(dark), torch.as_tensor(dark)


def run(s, script, frames):
    """Drive ``s``: a string is keys (one per character), an int n is
    ``process_group`` of the next n frames, ("p", n) per-frame ``process``
    of the next n frames.  Returns every result."""
    out, i = [], 0
    for step in script:
        if isinstance(step, str):
            for ch in step:
                s.key(ch)
            continue
        kind, n = step if isinstance(step, tuple) else ("g", step)
        chunk = frames[i:i + n]
        i += n
        if kind == "g":
            out += s.process_group(chunk)
        else:
            out += [r for f in chunk if (r := s.process(f)) is not None]
    return out


def u8_close(got, want, limit=1):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= limit


def allclose(got, want, rtol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.nanmax(np.abs(want)), 1e-300))


def assert_results_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, BscanResult) and torch.is_tensor(g.bscan)
        allclose(g.bscan.numpy(), w.bscan)
        w_db, g_db = np.asarray(w.bscandb), g.bscandb.numpy()
        near = w_db >= np.nanmax(w_db) - 40.0
        np.testing.assert_allclose(g_db[near], w_db[near], rtol=0, atol=1e-8)
        u8_close(g.bscandisp, w.bscandisp)
        assert g.index == w.index
        for name in ("sub_disp", "manual_disp"):
            a, b = getattr(g, name), getattr(w, name)
            assert (a is None) == (b is None), name
            if a is not None:
                assert isinstance(a, np.ndarray)
                u8_close(a, b)


FIELDS = ("averages", "averagestoggle", "bscanthreshold", "indextemp", "indexi", "manualindexi",
          "zeroisactive", "jlockin", "baccumcount", "manualaccumcount", "exposure_us", "gain",
          "ascanat", "widthROI", "vertposROI", "ROIreport", "done", "clampupper",
          "_pending", "_dark_counts")
TENSORS = ("data_yb", "data_yp", "data_yd", "data_yr", "data_ys", "accum", "manualaccum",
           "baccum", "jscansave")


def no_fps(status):
    return [m for m in status if not m.startswith("fps")]


def assert_sessions_equal(ts, js, rings=TOL):
    for name in FIELDS:
        assert getattr(ts, name) == getattr(js, name), name
    assert (ts._trig is None) == (getattr(js, "_trig", None) is None)
    assert ts._trig_set == getattr(js, "_trig_set", 0)        # JAX sets it at a first capture
    for name in TENSORS:
        a, b = getattr(ts, name), getattr(js, name)
        assert (a is None) == (b is None), name
        if a is not None:
            allclose(a.numpy(), b)
    assert_rings_equal(ts, js, rings)
    assert no_fps(ts.status) == no_fps(js.status)


def host(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def ring_binned(s, rid):
    """The binned frames of ring ``rid``: a JAX session stores them; the port
    forms them from its raw ring, as its 'b' capture does."""
    ring = s._rings[rid]
    if "binned" in ring:
        return ring["binned"]
    return list(preprocess(torch.stack(ring["raw"]), s.cfg)) if ring["raw"] else []


def assert_rings_equal(a, b, rtol=TOL):
    assert a.zeroisactive == b.zeroisactive
    for rid in (0, 1):
        for key in ("bscan", "raw", "binned"):
            x, y = ((ring_binned(a, rid), ring_binned(b, rid)) if key == "binned"
                    else (a._rings[rid][key], b._rings[rid][key]))
            assert len(x) == len(y), (rid, key, len(x), len(y))
            for u, v in zip(x, y):
                allclose(host(u), host(v), rtol)


_M_NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?|[-+]?inf|nan")


def assert_run_dirs_equal(port_dir, jax_dir):
    names = sorted(p.name for p in port_dir.iterdir())
    assert names == sorted(p.name for p in jax_dir.iterdir())
    assert port_dir.name == jax_dir.name
    for name in names:
        p, j = port_dir / name, jax_dir / name
        if name.endswith(".png"):
            a, b = read_png(p), jax_read_png(j)
            if name.startswith(("rawframe", "Trig", "KTrig")):
                assert a.dtype == b.dtype and np.array_equal(a, b), name
            else:
                u8_close(a, b, 8 if a.ndim == 3 else 1)
        elif name.endswith(".ocv"):
            allclose(jax_matread(p), jax_matread(j))
        elif name.endswith(".npz"):
            with np.load(p) as a, np.load(j) as b:
                assert sorted(a.files) == sorted(b.files)
                for key in a.files:
                    assert a[key].dtype == b[key].dtype
                    allclose(a[key], b[key])
        elif name.endswith(".xml"):
            (a, sa), (b, sb) = jax_read_xml(p), jax_read_xml(j)
            assert sa == sb and sorted(a) == sorted(b)
            for key in a:
                allclose(a[key], b[key])
        elif name.endswith(".m"):
            ta, tb = p.read_text(), j.read_text()
            names_of = [re.findall(r"^(\w+)=\[", t, re.M) for t in (ta, tb)]
            assert names_of[0] == names_of[1]
            assert ta.splitlines()[-2:] == tb.splitlines()[-2:]            # the footer
            na = [float(x) for x in _M_NUMBER.findall(re.sub(r"\w+\d+=", "", ta))]
            nb = [float(x) for x in _M_NUMBER.findall(re.sub(r"\w+\d+=", "", tb))]
            allclose(na, nb, 1e-8)
        else:
            raise AssertionError(f"unexpected file {name}")


def both(js, ts, script, frames, close=True):
    want, got = run(js, script, frames), run(ts, script, frames)
    assert_results_close(got, want)
    assert_sessions_equal(ts, js)
    if close:
        js.close()
        ts.close()
        if ts.sink is not None:
            assert_run_dirs_equal(ts.sink.dir, js.sink.dir)
    return got, want


def no_fallback(s):
    """Make a per-frame fallback on ``s`` fail the test."""
    def boom(raw):
        raise AssertionError("process_group fell back to per-frame process")
    s.process = boom


# ---------------------------------------------------------------------------
# captures


@pytest.mark.parametrize("case", ["b", "p", "b_ring", "sim", "dark", "dark_lowpass", "spinj_b"])
def test_captures_match_jax(tmp_path, data, case):
    """TestCaptures of tests/test_session.py and the spinj spectrum dump,
    on both packages."""
    src, frames, bg = data
    variant = {"sim": "sim", "dark": "dark", "dark_lowpass": "dark", "spinj_b": "spinj"}.get(
        case, "base")
    extra = {"b_ring": dict(saveinterferograms=True), "dark": dict(averages=2),
             "dark_lowpass": dict(averages=2, lowpassfilter=True)}.get(case, {})
    js, ts = pair(tmp_path, variant, source=src if case == "sim" else None, **extra)
    script = {"b": ["b", 4, 3], "p": ["p", ("p", 1), 2],
              "b_ring": [3, "b", ("p", 1), 2], "sim": ["bp", ("p", 1), 3],
              "dark": ["o", 2, "r", 2, "t", 2, 4], "dark_lowpass": ["o", 2, "r", 2, "t", 2, 4],
              "spinj_b": ["b", 2, 4]}[case]
    both(js, ts, script, frames)
    if case == "b_ring":
        assert (ts.sink.dir / "rawframeb000-000.png").exists()
    if case.startswith("dark"):
        assert not torch.equal(ts.data_yd, torch.zeros_like(ts.data_yd))
    if case == "spinj_b":
        assert (ts.sink.dir / "spectrum.ocv").exists()


def test_dark_arms_compose_the_background(data):
    """Identical captures of the three arms: S(k) = (f − f) + (f − f) = 0,
    guarded to 1; the dark frame is the frame (test_session.py)."""
    _, frames, _ = data
    _, ts = pair(variant="dark", averages=2)
    same = np.stack([frames[0]] * 6)
    run(ts, ["o", 2, "r", 2, "t", 2], same)
    assert torch.equal(ts.data_yb, torch.ones_like(ts.data_yb))
    np.testing.assert_allclose(ts.data_yd.numpy(), frames[0].astype(np.float64))


# ---------------------------------------------------------------------------
# J-lockin


@pytest.mark.parametrize("route", ["per_frame", "fast"])
def test_jlockin_matches_jax(tmp_path, data, route):
    """'j' at a group boundary, J-lockin groups with their bscansub saves,
    then 'c' (TestJLockin; TestFastPathStatefulFlags.test_jlockin_rides_fast_path)."""
    _, frames, bg = data
    js, ts = pair(tmp_path, fmt="m")
    prime(js, ts, bg)
    steady = 9 if route == "fast" else ("p", 9)
    got, _ = both(js, ts, ["j", 3, steady, "c", 3], frames)
    # the group that completes after 'c' still subtracts: 'c' acts at its end
    assert [r.sub_disp is not None for r in got] == [False, True, True, True, True]
    subs = sorted(p.name for p in ts.sink.dir.glob("bscansub*.png"))
    assert len(subs) == 8                           # 4 bscansub + 4 bscansubc


def test_jlockin_on_identical_frames_is_flat(data):
    _, frames, bg = data
    _, ts = pair()
    ts.data_yb = torch.as_tensor(bg)
    same = np.stack([frames[0]] * 6)
    ts.key("j")
    run(ts, [3], same)
    (r,) = run(ts, [3], same)
    assert r.sub_disp is not None and r.sub_disp.max() == 0


def test_jlockin_batch_is_the_jax_chain(data):
    from fdoct_tpu.session import _jlockin_batch
    rng = np.random.default_rng(0)
    stack, jscan = rng.uniform(0, 2, (3, 20, 16)), rng.uniform(0, 2, (20, 16))
    cfg = JaxConfig(**CFG)
    for thresh in (-np.inf, 2.0):
        want_db, want = _jlockin_batch(jnp.asarray(stack), jnp.asarray(jscan),
                                       jnp.asarray(thresh), cfg)
        got_db, got = jlockin_batch(torch.as_tensor(stack), torch.as_tensor(jscan), thresh, cfg)
        allclose(got_db.numpy(), want_db)
        u8_close(got.numpy(), want)


# ---------------------------------------------------------------------------
# keys, live config, ROI


KEYS = "+uUd]][0)9(WWwhHHqeaa!@123#4$-_=x" + "DDDDDDDDDDDDDD" + "otrk|vM><,.Z1\x1bX"


@pytest.mark.parametrize("variant", VARIANTS)
def test_keys_match_jax(variant, data):
    """Every key of Session.key in every variant (TestKeys, TestAveragesKeys;
    the spinj exposure floor of 8 and the gain keys), the camera callback's
    calls included; unknown keys are ignored."""
    src = data[0]
    calls = {}
    js, ts = pair(variant=variant, source=src, calls=calls, averages=4)
    for ch in KEYS:
        js.key(ch)
        ts.key(ch)
        assert_sessions_equal(ts, js)
    assert calls["port"] == calls["jax"] and ts.done
    assert ts.exposure_us == (8 if variant == "spinj" else 0)


def test_clampupper_key_changes_display(data):
    """'q' pins pixel (5, 5) to clampupperdb before the normalization
    (BscanFFT.cpp:1248-1253): above the data it is the display maximum."""
    _, frames, bg = data
    js, ts = pair(clampupperdb=200.0)
    prime(js, ts, bg)
    got, _ = both(js, ts, ["q", ("p", 3), 3], frames)
    for r in got:
        assert r.bscandisp[5, 5] == r.bscandisp.max() == 255


def test_config_snapshot_and_apply_config_match_jax(data):
    _, frames, bg = data
    calls = {}
    js, ts = pair(calls=calls)
    prime(js, ts, bg)
    assert ts.config_snapshot() == js.config_snapshot()
    updates = [{"bscanthreshold": "7.5", "gain": 3, "exposure_us": -5},
               {"averages": 0, "manualaverages": 0, "clampupper": "1", "clampupperdb": "44"},
               {"averages": "2", "width": 64, "gain": "x", "manualaverages": 4},
               {"clampupper": 0, "bscanthreshold": None}]
    for upd in updates:
        assert ts.apply_config(upd) == js.apply_config(upd)
        assert ts.config_snapshot() == js.config_snapshot()
        assert_sessions_equal(ts, js)
    assert calls["port"] == calls["jax"]
    both(js, ts, [("p", 1), 4, 3], frames, close=False)
    sim_j, sim_t = pair(variant="sim")
    assert sim_t.config_snapshot() == sim_j.config_snapshot()        # -inf → None


@pytest.mark.parametrize("variant", ["base", "peak"])
def test_set_roi_matches_jax(variant):
    js, ts = pair(variant=variant)
    for rect in ((3, 5, 4, 7), (-4, 200, 90, 90), (15, 0, 1, 1), (8.7, 30.2, 2.5, 3.9)):
        js.set_roi(*rect)
        ts.set_roi(*rect)
        assert_sessions_equal(ts, js)
        if variant == "peak":
            assert ts.plugins[0].roi == js.plugins[0].roi
            assert ts.plugins[0].roi_selected


def test_unknown_variant_raises():
    with pytest.raises(ValueError, match="unknown variant 'webcam'"):
        Session(PipelineConfig(**CFG), device="cpu", variant="webcam")


# ---------------------------------------------------------------------------
# saves


@pytest.mark.parametrize("case", ["m", "xml", "npz", "rings", "manual"])
def test_saves_match_jax(tmp_path, data, case):
    """TestSaves: 's' writes the B-scan (data, PNG, JET PNG), the rings'
    per-frame B-scans and raw frames of the group before, manual averages;
    close() the footer and the data file."""
    _, frames, bg = data
    extra = {"rings": dict(saveframes=True, saveinterferograms=True),
             "manual": dict(manualaveraging=True, manualaverages=2)}.get(case, {})
    js, ts = pair(tmp_path, fmt=case if case in ("m", "xml") else "npz", **extra)
    prime(js, ts, bg)
    script = {"rings": [3, "s", 3, 3, "s", ("p", 3)],
              "manual": ["s", 3, "s", 3, "s", 3, "s", 3]}.get(case, ["s", 3, 3])
    got, _ = both(js, ts, script, frames)
    files = {p.name for p in ts.sink.dir.iterdir()}
    assert {"bscan001.png", "bscanc001.png"} <= files
    if case == "rings":
        assert {"bscan001-000.png", "rawframe001-002.png", "bscan002-002.png"} <= files
    if case == "manual":
        assert "bscanman001.png" in files and any(r.manual_disp is not None for r in got)


# ---------------------------------------------------------------------------
# the fast path against per-frame process, for each flag


@pytest.mark.parametrize("flag", ["none", "saveframes", "saveinterferograms", "jlockin", "dark",
                                  "dark_rings"])
def test_fast_path_matches_per_frame_and_jax(data, flag):
    """process_group on whole groups equals process() frame by frame in
    the port (rtol 1e-12, equal displays, equal rings), and both equal JAX
    process() (TestGroupParity, TestFastPathStatefulFlags,
    test_dark_variant_parity)."""
    _, frames, bg = data
    extra = {"saveframes": dict(saveframes=True),
             "saveinterferograms": dict(saveinterferograms=True),
             "dark_rings": dict(saveframes=True, saveinterferograms=True)}.get(flag, {})
    variant = "dark" if flag.startswith("dark") else "base"
    dark = np.full(bg.shape, 2.0) if variant == "dark" else None
    js, ts = pair(variant=variant, **extra)
    _, fast = pair(variant=variant, **extra)
    prime(js, ts, bg, dark)
    prime(js, fast, bg, dark)
    head = ["j", ("p", 3)] if flag == "jlockin" else []
    n_head = 3 if flag == "jlockin" else 0
    want = run(js, head + [("p", 12)], frames)
    seq = run(ts, head + [("p", 12)], frames)
    batched = run(fast, head, frames)
    no_fallback(fast)
    batched += fast.process_group(frames[n_head:n_head + 12])
    assert len(batched) == len(seq) == len(want) == (5 if flag == "jlockin" else 4)
    for a, b in zip(seq, batched):
        allclose(b.bscan.numpy(), a.bscan.numpy(), 1e-12)
        np.testing.assert_array_equal(a.bscandisp, b.bscandisp)
        assert (a.sub_disp is None) == (b.sub_disp is None)
        if a.sub_disp is not None:
            u8_close(b.sub_disp, a.sub_disp)
    assert_rings_equal(fast, ts, 1e-12)
    assert_results_close(seq, want)
    assert_sessions_equal(ts, js)
    if flag in ("saveframes", "dark_rings"):
        assert len(fast._rings[1 if fast.zeroisactive else 0]["bscan"]) == 3


def test_dark_ring_keeps_frames_before_the_subtraction(data):
    """The dark variant's binned frames, which the port forms from its raw
    ring, are the frames before the dark subtraction on both of the port's
    paths, as JAX process() stores them.  The JAX fast path stores them
    after it (fdoct_tpu/session.py:1143-1150): the reference's fault, which
    the port does not reproduce (ROADMAP Queue 3 item 1); pinned here so
    that a change on either side shows."""
    _, frames, bg = data
    dark = np.full(bg.shape, 2.0)
    js, ts = pair(variant="dark", saveinterferograms=True)
    jfast, tfast = pair(variant="dark", saveinterferograms=True)
    for j, t in ((js, ts), (jfast, tfast)):
        prime(j, t, bg, dark)
    run(js, [("p", 6)], frames)
    run(ts, [("p", 6)], frames)
    run(jfast, [6], frames)
    run(tfast, [6], frames)
    assert_rings_equal(ts, js)
    assert_rings_equal(tfast, ts, 1e-12)
    inactive = 1 if js.zeroisactive else 0
    for jf, jp in zip(jfast._rings[inactive]["binned"], js._rings[inactive]["binned"]):
        allclose(np.asarray(jf), np.asarray(jp) - dark)
    for raw, frame in zip(tfast._rings[inactive]["raw"], frames[3:6]):
        np.testing.assert_array_equal(raw.numpy(), frame)


def test_saveinterferograms_fast_path_feeds_the_b_capture(data):
    """The 'b' capture averages the inactive ring's binned frames; both paths
    and JAX capture the same background."""
    _, frames, bg = data
    js, ts = pair(saveinterferograms=True)
    _, fast = pair(saveinterferograms=True)
    prime(js, ts, bg)
    prime(js, fast, bg)
    for s, first in ((js, ("p", 6)), (ts, ("p", 6)), (fast, 6)):
        run(s, [first, "b", ("p", 1)], frames)
    allclose(ts.data_yb.numpy(), js.data_yb)
    allclose(fast.data_yb.numpy(), ts.data_yb.numpy(), 1e-12)


def test_ring_keeps_its_own_copy_of_the_frames(data):
    """A caller that reuses its frame buffer does not change the ring."""
    _, frames, bg = data
    _, ts = pair(saveinterferograms=True)
    buf = frames[:3].copy()
    ts.process_group(buf)
    buf[:] = 0
    ring = ts._rings[1 if ts.zeroisactive else 0]
    for raw, frame in zip(ring["raw"], frames[:3]):
        np.testing.assert_array_equal(raw.numpy(), frame)


def test_plugins_run_per_group(data):
    _, frames, bg = data
    calls = {"jax": 0, "port": 0}

    class Probe:
        def __init__(self, name):
            self.name = name

        def key(self, s, ch):
            return False

        def on_bscan(self, s, result):
            calls[self.name] += 1

    js, ts = pair()
    prime(js, ts, bg)
    js.plugins.append(Probe("jax"))
    ts.plugins.append(Probe("port"))
    no_fallback(ts)
    both(js, ts, [12], frames, close=False)
    assert calls == {"jax": 4, "port": 4}


@pytest.mark.parametrize("case", ["manual averaging", "output B-scan rebinning",
                                  "triggered batch capture in progress"])
def test_fast_path_blocker_is_said_once(tmp_path, data, case):
    _, frames, bg = data
    extra = {"manual averaging": dict(manualaveraging=True),
             "output B-scan rebinning": dict(bscanbinx=2, bscanbiny=2)}.get(case, {})
    js, ts = pair(tmp_path, variant="spinj", manualaverages=6, **extra)
    prime(js, ts, bg)
    head = ["t"] if case.startswith("triggered") else []
    both(js, ts, head + [3, 3], frames)
    assert sum(case in m for m in ts.status) == 1


# ---------------------------------------------------------------------------
# spinj: triggered captures, .ocv dumps, offline hand-off, rebinning


@pytest.mark.parametrize("keys,expect", [
    ("t", ["Trig000-000.png", "Trig000-001.png", "Trig000-002.png"]),
    ("k", ["KTrig000-000.png", "KTrig000-001.png", "KTrig000-002.png"]),
    ("|", ["KTrig000-000.png", "KTrig000-001.png", "KTrig000-002.png", "Trig000-000.png",
           "Trig000-001.png", "Trig000-002.png"]),
    ("tt", ["Trig000-000.png", "Trig000-001.png", "Trig000-002.png", "Trig001-000.png",
            "Trig001-001.png", "Trig001-002.png"]),
], ids=["t", "k", "alternating", "set_counter"])
def test_triggered_capture_matches_jax(tmp_path, data, keys, expect):
    """TestTrigCapture: the next manualaverages frames as 16-bit PNGs."""
    _, frames, bg = data
    js, ts = pair(tmp_path, variant="spinj", manualaverages=3, averages=2)
    prime(js, ts, bg)
    script = [keys[0], 6] + ([keys[1], 6] if len(keys) > 1 else [])
    both(js, ts, script, frames)
    names = sorted(p.name for p in ts.sink.dir.glob("*Trig*.png"))
    assert names == expect
    first = read_png(ts.sink.dir / ("KTrig000-000.png" if keys == "k" else "Trig000-000.png"))
    assert first.dtype == np.uint16 and np.array_equal(first >> 8, frames[0])


def test_triggered_capture_of_16_bit_frames_matches_jax(tmp_path, data):
    """A 12-bit camera's uint16 frames are written as they come, with no
    Mono16 shift, by both packages; the groups around the capture take
    kernel 1's raw route on the port."""
    _, frames, bg = data
    frames16 = frames.astype(np.uint16) << 4
    js, ts = pair(tmp_path, variant="spinj", manualaverages=3, averages=2, bpp=12)
    prime(js, ts, bg * 16)
    both(js, ts, ["t", 6, 4], frames16)
    names = sorted(p.name for p in ts.sink.dir.glob("*Trig*.png"))
    assert names == ["Trig000-000.png", "Trig000-001.png", "Trig000-002.png"]
    for i, name in enumerate(names):
        np.testing.assert_array_equal(read_png(ts.sink.dir / name), frames16[i])


def test_trig_needs_a_sink(data):
    _, frames, _ = data
    js, ts = pair(variant="spinj")
    both(js, ts, ["t", 3], frames, close=False)
    assert ts._trig is None and "no sink; trig capture ignored" in ts.status


def test_spinj_ocv_dumps_match_jax(tmp_path, data):
    """TestOcvDumps: spectrum.ocv at the 'b' capture, bscandb and jscan
    .ocv at an 's' save under J-lockin."""
    _, frames, _ = data
    js, ts = pair(tmp_path, variant="spinj", averages=2)
    both(js, ts, ["b", 2, "j", 2, "s", 2, 2], frames)
    files = {p.name for p in ts.sink.dir.iterdir()}
    assert {"spectrum.ocv", "bscandb001.ocv", "jscan001.ocv"} <= files


def test_offline_tool_gets_the_reference_argv(tmp_path, monkeypatch):
    """TestOfflineHandoff: {tool, dirname, manualaverages}, as the JAX
    session starts it."""
    cmds = []
    monkeypatch.setattr(subprocess, "Popen", lambda cmd: cmds.append(cmd))
    js, ts = pair(tmp_path, variant="spinj", manualaverages=3,
                  offline_tool_path="oct-offline-tool")
    js.key("y")
    ts.key("y")
    assert cmds[1] == ["oct-offline-tool", str(ts.sink.dir), "3"]
    assert cmds[0][1:] == [str(js.sink.dir), "3"]
    assert ts.status == [f"spawned offline tool for {ts.sink.dir}"]
    assert js.status == [f"spawned offline tool for {js.sink.dir}"]


@pytest.mark.parametrize("shape,out", [((20, 16), (40, 32)), ((80, 16), (80, 16)),
                                       ((7, 5), (3, 9))])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_resize_bicubic_and_bscan_rebin_match_jax(shape, out, dtype):
    x = np.random.default_rng(3).uniform(0, 5, (2, *shape)).astype(dtype)
    rtol = 1e-12 if dtype == "float64" else 2e-6
    allclose(resize_bicubic(torch.as_tensor(x), *out).numpy(),
             jax_resize_bicubic(jnp.asarray(x), *out), rtol)
    if shape[0] % 2 == 0 and shape[1] % 2 == 0:
        for bx, by, mult in ((2, 2, 4.0), (2, 1, 1.0), (1, 1, 3.0)):
            allclose(bscan_rebin(torch.as_tensor(x), bx, by, mult).numpy(),
                     jax_bscan_rebin(jnp.asarray(x), bx, by, mult), rtol)


def test_bscan_rebin_session_matches_jax(data):
    """TestBscanRebin: the rebinned output keeps its shape, differs from the
    plain one, and matches JAX; the fast path is left for per-frame."""
    _, frames, bg = data
    js, ts = pair(variant="spinj", bscanbinx=2, bscanbiny=2)
    _, plain = pair(variant="spinj")
    prime(js, ts, bg)
    prime(js, plain, bg)
    got, _ = both(js, ts, [6, ("p", 3)], frames, close=False)
    ref = run(plain, [6], frames)
    assert got[0].bscan.shape == ref[0].bscan.shape
    assert not torch.allclose(got[0].bscan, ref[0].bscan)


# ---------------------------------------------------------------------------
# every variant with every flag


SWEEP_HEAD = {"base": ["b", 4], "sim": ["bp", 1], "dark": ["o", 3, "r", 3, "t", 3],
              "peak": ["b", 4], "spinj": ["b", 4, "t", 2]}
SWEEP = [("p", 2), "p", 2, "j", 3, "s", 3, "s", 4, "c", 3, "s", 3, "s", 2, "s", 3]


@pytest.mark.parametrize("variant", VARIANTS)
def test_every_variant_with_every_flag_matches_jax(tmp_path, data, variant):
    """Session(cfg, "cpu", variant) with saveframes, saveinterferograms,
    manualaveraging and bscanbinx = 2 against the JAX session: captures,
    J-lockin, saves, the rebinned display, every result, the session's
    fields and rings, and the written run directory."""
    src, frames, _ = data
    extra = dict(saveframes=True, saveinterferograms=True, manualaveraging=True,
                 manualaverages=2, bscanbinx=2, peakholdnumframes=2,
                 lowpassfilter=variant == "dark")
    js, ts = pair(tmp_path, variant, source=src if variant == "sim" else None, **extra)
    script = SWEEP_HEAD[variant] + SWEEP
    if variant == "peak":
        for s in (js, ts):
            s.set_roi(2, 4, 5, 30)
            s.ascanat = 3                         # the hold reads this A-scan (oph 16)
        script = script + ["1", 3]
    got, _ = both(js, ts, script, frames)
    assert len(got) >= 6
    assert any(r.manual_disp is not None for r in got)
    files = {p.name for p in ts.sink.dir.iterdir()}
    assert any(f.startswith("rawframe") for f in files) and "BscanFFT.npz" in files


# ---------------------------------------------------------------------------
# int8-direct in the dark variant, and beside the rings and J-lockin

I8 = dict(width=256, height=32, averages=4, numfftpoints=512, numdisplaypoints=160,
          lambdamin=816e-9, lambdamax=884e-9, dtype="float32", compat=True)
CAL_LEAVES = ("op_re", "op_im", "window", "nearest_idx", "frac", "phase", "lambdas", "k",
              "klinear")


@pytest.fixture(scope="module")
def i8_data():
    src = SyntheticSource(height=32, width=256, depths_um=(40.0, 80.0),
                          reflectivities=(0.5, 0.3), noise=0.01, seed=9)
    it = iter(src.frames())
    frames = np.stack([next(it) for _ in range(8)]).astype(np.uint8)
    rng = np.random.default_rng(3)
    bg = np.maximum(src.background().astype(np.float64), 1.0)
    bg = bg * (1.0 + 0.04 * np.sin(np.linspace(0, 3, 32)))[:, None]
    return frames, bg, rng.uniform(0.0, 8.0, bg.shape), rng.uniform(0.0, 4.0, bg.shape)


def i8_pair(bg, pi, dark, variant="dark", **extra):
    """A JAX and a port session on one M, with S(k), π and the dark frame."""
    jcfg = JaxConfig(**I8, matmul_precision="int8_direct", **extra)
    tcfg = PipelineConfig(**dataclasses.asdict(jcfg))
    js = JaxSession(jcfg, variant=variant)
    tcal = Calibration.from_arrays({n: np.asarray(getattr(js.calib, n)) for n in CAL_LEAVES},
                                   tcfg, "cpu")
    ts = Session(tcfg, device="cpu", variant=variant, calib=tcal)
    for name, arr in (("data_yb", bg), ("data_yp", pi), ("data_yd", dark)):
        setattr(js, name, jnp.asarray(arr, jnp.float32))
        setattr(ts, name, torch.as_tensor(arr, dtype=torch.float32))
    return js, ts


def assert_i8_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.bscan.numpy(), np.asarray(w.bscan), rtol=1e-5)
        np.testing.assert_allclose(g.bscandb.numpy(), np.asarray(w.bscandb), rtol=1e-5,
                                   atol=1e-4)
        u8_close(g.bscandisp, w.bscandisp)


def test_int8_direct_dark_plan_matches_jax(i8_data):
    """The dark variant folds its dark frame into the plan; a new dark frame
    builds a new plan; the groups match JAX's."""
    frames, bg, pi, dark = i8_data
    js, ts = i8_pair(bg, pi, dark)
    want, got = js.process_group(frames), ts.process_group(frames)
    assert ts._i8plan is not None and len(got) == len(want) == 2
    assert_i8_close(got, want)
    plan = ts._i8plan
    ts.data_yd = ts.data_yd * 0.5
    ts.process_group(frames[:4])
    assert ts._i8plan is not plan
    _, base = i8_pair(bg, pi, dark, variant="base")
    base.process_group(frames[:4])
    assert not torch.equal(base._i8plan.const_re, plan.const_re)     # base ignores the dark


def fused_int8_calls(monkeypatch) -> list:
    """Count the session's calls of the int8 B-scan kernel's wrapper route
    (on the CPU the wrapper runs its plain version and counts no launch)."""
    from fdoct_tpu_torch import session as tsession
    calls = []
    orig = tsession.int8_bscan_outputs
    monkeypatch.setattr(tsession, "int8_bscan_outputs",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    return calls


def test_int8_direct_saveframes_ring_matches_jax(i8_data, monkeypatch):
    """With saveframes the display stays one kernel 3 call per group and
    the ring holds reconstruct_int8_direct's per-frame magnitudes."""
    frames, bg, pi, dark = i8_data
    js, ts = i8_pair(bg, pi, dark, saveframes=True, saveinterferograms=True)
    calls = fused_int8_calls(monkeypatch)
    want, got = js.process_group(frames), ts.process_group(frames)
    assert len(calls) == 2
    assert_i8_close(got, want)
    assert_rings_equal(ts, js, 1e-5)
    ring = ts._rings[1 if ts.zeroisactive else 0]["bscan"]
    s8 = shift_u8_to_s8(torch.as_tensor(frames[4:]))
    for got_m, want_m in zip(ring, reconstruct_int8_direct(s8, ts._i8plan)):
        assert torch.equal(got_m, want_m)


def test_int8_direct_is_off_under_jlockin(i8_data, monkeypatch):
    frames, bg, pi, dark = i8_data
    js, ts = i8_pair(bg, pi, dark, variant="base")
    for s in (js, ts):
        s.key("j")
    want = [r for f in frames[:4] if (r := js.process(f)) is not None]
    got = [r for f in frames[:4] if (r := ts.process(f)) is not None]
    assert ts.jlockin and not ts._use_int8_direct(torch.as_tensor(frames[0]))
    calls = fused_int8_calls(monkeypatch)
    want += js.process_group(frames[4:])
    got += ts.process_group(frames[4:])
    assert not calls
    assert got[-1].sub_disp is not None and len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.bscandb.numpy(), np.asarray(w.bscandb), atol=2e-2)
