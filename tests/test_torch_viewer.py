"""The port's viewer (``fdoct_tpu_torch/viewer.py``) against the JAX
package's (``fdoct_tpu/viewer.py``) on the same seeded inputs.

Tolerances.  ``render_bscan`` and ``render_strip_chart`` byte-equal;
``render_status`` is the port's own bitmap font (PIL's default font differs
between Pillow versions), so it is held to its layout: (300, 600) uint8,
each row's pixels inside its 7-pixel band at y = 15 + 50·i.  Float64
sessions of both packages, each driving a files-mode viewer: the same file
names, the raw frame exactly, the port's ``bscan.png`` equal to
``render_bscan`` of its own result, whose display is within one level of
the JAX session's.  The case marked ``cuda`` (it skips here) drives a
session on the card.
"""

import numpy as np
import pytest
import torch

from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.session import Session
from fdoct_tpu_torch.sources.synthetic import SyntheticSource
from fdoct_tpu_torch.utils.font import HEIGHT
from fdoct_tpu_torch.utils.imageio import read_png
from fdoct_tpu_torch.viewer import Viewer, render_bscan, render_status, render_strip_chart

#: the session config of tests/test_viewer.py
SMALL = dict(width=64, height=8, averages=2, numfftpoints=128, numdisplaypoints=40,
             dtype="float64")


@pytest.fixture(scope="module")
def jv():
    """The JAX viewer module (it imports PIL); skips without JAX."""
    pytest.importorskip("jax")
    return pytest.importorskip("fdoct_tpu.viewer")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# renderers


@pytest.mark.parametrize("ascanat,roi", [
    (10, None), (None, None), (0, None), (31, None), (40, None), (-1, None),
    (10, {"x": 4, "y": 6, "w": 10, "h": 8}),
    (5, {"x": -5, "y": 60, "w": 100, "h": 30}),
    (5, {"x": 20, "y": -3, "w": 50, "h": 70}),
    (5, {"x": 3, "y": 3, "w": 0, "h": 5}),
], ids=["marker", "no_marker", "marker_left_edge", "marker_right_edge", "marker_outside",
        "marker_negative", "roi_in_range", "roi_dragged_past_bottom", "roi_dragged_past_right",
        "roi_empty"])
def test_render_bscan_byte_equal(jv, ascanat, roi):
    disp = np.random.default_rng(3).integers(0, 256, (64, 32), dtype=np.uint8)
    got = render_bscan(disp, ascanat, roi=roi)
    want = jv.render_bscan(disp, ascanat, roi=roi)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_render_strip_chart_byte_equal(jv):
    plot = (np.random.default_rng(4).uniform(size=(300, 600)) > 0.97).astype(np.float64)
    got = render_strip_chart(plot)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, jv.render_strip_chart(plot))


def band(i: int) -> slice:
    return slice(15 + 50 * i, 15 + 50 * i + HEIGHT)


def test_render_status_rows_stay_in_their_bands():
    lines = [f"row {i}: fps = 30  Max Intensity = {200 + i}" for i in range(6)]
    img = render_status(lines)
    assert img.shape == (300, 600) and img.dtype == np.uint8
    lit = img > 0
    for i in range(6):
        assert lit[band(i)].any(), i
        assert lit[band(i), :4].sum() == 0                    # text starts at x = 4
    inside = np.zeros_like(lit)
    for i in range(6):
        inside[band(i)] = True
    assert not (lit & ~inside).any()
    assert set(np.unique(img)) == {0, 255}


def test_render_status_draws_only_the_first_six_rows():
    lines = [f"line {i}" for i in range(9)]
    np.testing.assert_array_equal(render_status(lines), render_status(lines[:6]))
    assert not render_status([]).any()


def test_render_status_draws_any_character():
    """The session's status lines hold "—" and "µ": a box glyph, no error."""
    img = render_status(["J0 level — set", "vibration 12.5 µm", "\x00\t\ud800"])
    for i in range(3):
        assert img[band(i)].any(), i
    box = render_status(["—"])[band(0), 4:9]
    assert box[0].all() and box[-1].all() and box[:, 0].all() and box[:, -1].all()


# ---------------------------------------------------------------------------
# the viewer driven by sessions


def session_pair(jv, variant="base", **kw):
    from fdoct_tpu.config import PipelineConfig as JaxConfig
    from fdoct_tpu.session import Session as JaxSession

    cfg = {**SMALL, **kw}
    return JaxSession(JaxConfig(**cfg), variant=variant), \
        Session(PipelineConfig(**cfg), device="cpu", variant=variant)


def test_files_mode_session_loop_matches_jax(jv, tmp_path):
    js, ts = session_pair(jv)
    views = {"jax": jv.Viewer(mode="files", outdir=tmp_path / "jax"),
             "port": Viewer(mode="files", outdir=tmp_path / "port")}
    it = iter(SyntheticSource(height=8, width=64, depths_um=(20.0,)).frames())
    results = {}
    for _ in range(4):
        raw = next(it)
        for name, s in (("jax", js), ("port", ts)):
            r = s.process(raw)
            views[name].show_session_frame(s, raw, r)
            if r is not None:
                results[name] = r
    names = {p.name for p in (tmp_path / "port").iterdir()}
    assert {"show.png", "status.png", "bscan.png"} <= names
    assert names == {p.name for p in (tmp_path / "jax").iterdir()}
    np.testing.assert_array_equal(read_png(tmp_path / "port" / "show.png"), raw)
    r = results["port"]
    np.testing.assert_array_equal(read_png(tmp_path / "port" / "bscan.png"),
                                  render_bscan(r.bscandisp, ts.ascanat))
    diff = np.abs(r.bscandisp.astype(int) - np.asarray(results["jax"].bscandisp, int))
    assert diff.max() <= 1
    np.testing.assert_array_equal(read_png(tmp_path / "port" / "status.png"),
                                  render_status(ts.status[-6:]))
    assert ts.status == js.status


def test_roi_strip_chart_and_outline_reach_the_windows(jv):
    """A 'peak' session with a selected ROI outlines it on the B-scan, as the
    JAX viewer does; a base session's 'e' toggle feeds the strip chart."""
    seen = {"jax": {}, "port": {}}
    js, ts = session_pair(jv, variant="peak", height=32, averages=1)
    raw = next(iter(SyntheticSource(height=32, width=64, depths_um=(20.0,)).frames()))
    for name, s, mod in (("jax", js, jv), ("port", ts, None)):
        s.set_roi(5, 8, 10, 6)
        cls = jv.Viewer if mod else Viewer
        v = cls(mode="callback", callback=lambda n, i, d=seen[name]: d.update({n: i}))
        v.show_session_frame(s, raw, s.process(raw))
    assert (seen["port"]["bscan"][8, 5:16] == 255).all()
    assert seen["port"].keys() == seen["jax"].keys()
    js, ts = session_pair(jv, height=32, averages=1)
    for s in (js, ts):
        s.key("e")
    shown = []
    v = Viewer(mode="callback", callback=lambda n, i: shown.append((n, i)))
    for _ in range(2):
        js.process(raw)
        v.show_session_frame(ts, raw, ts.process(raw))
    chart = dict(shown)["roi_intensity"]
    np.testing.assert_array_equal(chart, jv.render_strip_chart(js.plugins[0].plot))


def test_callback_mode_and_unknown_window():
    seen = []
    v = Viewer(mode="callback", callback=lambda n, i: seen.append((n, i)))
    v.update("show", torch.arange(16, dtype=torch.uint8).reshape(4, 4))
    assert [n for n, _ in seen] == ["show"]
    assert isinstance(seen[0][1], np.ndarray) and seen[0][1][3, 3] == 15
    with pytest.raises(ValueError, match="unknown window"):
        v.update("nope", np.zeros((2, 2)))
    with pytest.raises(ValueError, match="unknown viewer mode"):
        Viewer(mode="x11")
    assert v.pop_keys() == "" and v.pop_rois() == [] and v.pop_config() == []


@pytest.mark.filterwarnings("ignore:FigureCanvasAgg is non-interactive")
def test_mpl_mode_with_agg(monkeypatch):
    monkeypatch.setenv("MPLBACKEND", "Agg")
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg", force=True)
    import matplotlib.pyplot as plt

    v = Viewer(mode="mpl")
    rgb = render_bscan(np.arange(64 * 32, dtype=np.uint8).reshape(64, 32), 10)
    try:
        v.update("bscan", rgb)
        v.update("show", np.full((8, 16), 7, np.uint8))
        v.update("bscan", rgb[::-1])
        assert list(v._ax_map) == ["bscan", "show"]
        np.testing.assert_array_equal(np.asarray(v._ax_map["bscan"][1].get_array()), rgb[::-1])
    finally:
        plt.close(v._fig)


def test_mpl_mode_without_matplotlib_names_the_mode(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    monkeypatch.setitem(__import__("sys").modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError, match="mode='mpl'"):
        Viewer(mode="mpl")


@pytest.mark.cuda
def test_cuda_session_drives_the_viewer(cuda):
    """A 'default' session on the card: its host displays reach the windows
    as render_bscan renders them, and a CUDA tensor passed to update arrives
    on the host."""
    cfg = PipelineConfig(width=256, height=16, averages=2, numfftpoints=512,
                         numdisplaypoints=128, dtype="float32", donotnormalize=True)
    s = Session(cfg, device=cuda)
    seen = {}
    v = Viewer(mode="callback", callback=lambda n, i: seen.update({n: i}))
    it = iter(SyntheticSource(height=16, width=256, depths_um=(30.0,)).frames())
    raws = np.stack([next(it) for _ in range(4)])
    r = s.process_group(raws)[-1]
    v.show_session_frame(s, raws[-1], r)
    np.testing.assert_array_equal(seen["bscan"], render_bscan(r.bscandisp, s.ascanat))
    v.update("show", torch.as_tensor(raws[0]).to(cuda))
    assert isinstance(seen["show"], np.ndarray)
    np.testing.assert_array_equal(seen["show"], raws[0])
