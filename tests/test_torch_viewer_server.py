"""The port's HTTP viewer (``fdoct_tpu_torch/viewer_server.py``) against the
JAX package's (``fdoct_tpu/viewer_server.py``): one HTTP transcript sent to
a server of each (both on ``port=0``) gives equal results.

Equal means: status codes, bodies and JSON equal; ``GET /`` byte-equal;
PNGs (frames and the first ``/stream/`` part) equal by pixels (the port
encodes with its own codec, the JAX server with PIL); the queued keys, ROIs
and config edits drained by ``pop_*`` equal; the per-window ``max_fps`` drop
equal under a patched clock.  Every request carries ``timeout=5`` and every
server is closed by its fixture, so no case can hang the suite.  The case
marked ``cuda`` (it skips here) serves a session that runs on the card.
"""

import http.client
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from fdoct_tpu_torch import viewer_server
from fdoct_tpu_torch.utils.imageio import decode_png
from fdoct_tpu_torch.viewer_server import ViewerServer

TIMEOUT = 5


@pytest.fixture(scope="module")
def jvs():
    """The JAX server module (it encodes with PIL); skips without JAX."""
    pytest.importorskip("jax")
    pytest.importorskip("PIL")
    return pytest.importorskip("fdoct_tpu.viewer_server")


@pytest.fixture
def servers(jvs, request):
    """{"jax": ..., "port": ...} on ephemeral ports, closed at the end."""
    kw = getattr(request, "param", {})
    made = {}
    request.addfinalizer(lambda: [srv.close() for srv in made.values()])
    made["jax"] = jvs.ViewerServer(port=0, **kw)
    made["port"] = ViewerServer(port=0, **kw)
    return made


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def request(port: int, path: str, body: bytes | None = None) -> tuple[int, bytes, str]:
    """(status, body, content type) of GET ``path`` or POST ``body``."""
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as resp:
            return resp.status, resp.read(), resp.headers["Content-Type"]
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers["Content-Type"]


def first_stream_part(port: int, name: str) -> tuple[str, bytes, bytes]:
    """(content type of the response, the first part's headers, its PNG)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        conn.request("GET", f"/stream/{name}")
        resp = conn.getresponse()
        head = [resp.fp.readline() for _ in range(3)]         # boundary, type, length
        assert resp.fp.readline() == b"\r\n"
        png = resp.fp.read(int(head[2].split(b":")[1]))
        return resp.headers["Content-Type"], head[0] + head[1], png
    finally:
        conn.close()


def windows(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    return {"bscan": rng.integers(0, 256, (40, 24, 3), dtype=np.uint8),
            "show": rng.integers(0, 256, (16, 64), dtype=np.uint8),
            "status": rng.uniform(-50.0, 300.0, (30, 60)),             # clipped to uint8
            "roi_intensity": rng.integers(0, 3000, (12, 20)).astype(np.uint16)}


def transcript(srv) -> dict:
    """The same requests against one server; PNGs as pixels."""
    out = {}
    port = srv.port
    out["status_empty"] = request(port, "/status.json")
    out["config_no_provider"] = request(port, "/config")
    for name, img in windows().items():
        srv.update(name, img)
    srv.config_provider = lambda: {"live": {"bscanthreshold": -30.0}, "static": {"width": 64}}
    for path in ("/", "/index.html", "/status.json", "/config", "/frame/nope.png", "/nowhere",
                 "/frame/"):
        out[path] = request(port, path)
    for name in windows():
        code, body, ctype = request(port, f"/frame/{name}.png")
        out[f"frame {name}"] = (code, decode_png(body).tolist(), ctype)
        ctype, head, png = first_stream_part(port, name)
        out[f"stream {name}"] = (ctype, head, decode_png(png).tolist())
    posts = [("/key", b"sb+"), ("/key", "]é".encode()), ("/key", b""),
             ("/roi", json.dumps({"window": "bscan", "x": 5, "y": 7, "w": 12, "h": 4}).encode()),
             ("/roi", json.dumps({"x": "3", "y": 6.7, "w": 9, "h": 5}).encode()),
             ("/roi", b"not json"), ("/roi", json.dumps({"x": 1}).encode()),
             ("/roi", json.dumps({"x": "a", "y": 1, "w": 1, "h": 1}).encode()),
             ("/config", json.dumps({"bscanthreshold": "-42.5"}).encode()),
             ("/config", b"[1,2]"), ("/config", b"{}"), ("/config", b"nope"),
             ("/nowhere", b"x")]
    out["posts"] = [request(port, path, body) for path, body in posts]
    out["keys"] = (srv.pop_keys(), srv.pop_keys())
    out["rois"] = (srv.pop_rois(), srv.pop_rois())
    out["config"] = (srv.pop_config(), srv.pop_config())
    return out


def test_transcript_matches_jax(servers):
    got = {name: transcript(srv) for name, srv in servers.items()}
    assert got["port"] == got["jax"]
    port = got["port"]
    assert port["/"][0] == 200 and b"cfgtable" in port["/"][1]
    assert json.loads(port["/status.json"][1]) == {
        "windows": ["bscan", "roi_intensity", "show", "status"],
        "frames": {"bscan": 1, "show": 1, "status": 1, "roi_intensity": 1}}
    assert port["keys"] == ("sb+]é", "")
    assert port["rois"][0] == [{"x": 5, "y": 7, "w": 12, "h": 4, "window": "bscan"},
                               {"x": 3, "y": 6, "w": 9, "h": 5, "window": "bscan"}]
    assert port["config"] == ([{"bscanthreshold": "-42.5"}], [])
    assert [c for c, _, _ in port["posts"]] == [200] * 5 + [400] * 3 + [200] + [400] * 3 + [404]


def test_dashboard_page_is_the_jax_page(jvs):
    assert viewer_server._INDEX_HTML == jvs._INDEX_HTML


def test_png_pixels_and_clipping(servers):
    img = windows(1)["status"]
    for srv in servers.values():
        srv.update("status", img)
    want = np.clip(img, 0, 255).astype(np.uint8)
    for srv in servers.values():
        code, body, ctype = request(srv.port, "/frame/status.png")
        assert (code, ctype) == (200, "image/png")
        np.testing.assert_array_equal(decode_png(body), want)


class FakeClock:
    def __init__(self):
        self.now = 100.0

    def monotonic(self):
        return self.now


@pytest.mark.parametrize("servers", [{"max_fps": 10.0}], indirect=True)
def test_max_fps_drops_updates_like_jax(servers, jvs, monkeypatch):
    """10 fps: an update within 0.1 s of the last published one of its
    window is dropped, not queued; windows are limited separately."""
    clock = FakeClock()
    monkeypatch.setattr(jvs, "time", clock)
    monkeypatch.setattr(viewer_server, "time", clock)
    seen = {name: [] for name in servers}
    for i, t in enumerate((100.0, 100.05, 100.2, 100.25, 100.299, 100.5)):
        clock.now = t
        img = np.full((4, 4), i, np.uint8)
        for name, srv in servers.items():
            srv.update("show", img)
            if i == 1:
                srv.update("bscan", img)                      # its own window: published
            status = json.loads(request(srv.port, "/status.json")[1])
            shown = decode_png(request(srv.port, "/frame/show.png")[1])[0, 0]
            seen[name].append((status["frames"], int(shown)))
    assert seen["port"] == seen["jax"]
    assert [f["show"] for f, _ in seen["port"]] == [1, 1, 2, 2, 2, 3]
    assert [v for _, v in seen["port"]] == [0, 0, 2, 2, 2, 5]


@pytest.mark.cuda
def test_cuda_session_served_over_http(cuda):
    """A session on the card behind an http Viewer: the served B-scan is
    render_bscan of its result, and a POSTed key reaches the session."""
    from fdoct_tpu_torch.config import PipelineConfig
    from fdoct_tpu_torch.session import Session
    from fdoct_tpu_torch.sources.synthetic import SyntheticSource
    from fdoct_tpu_torch.viewer import Viewer, render_bscan

    cfg = PipelineConfig(width=256, height=16, averages=2, numfftpoints=512,
                         numdisplaypoints=128, dtype="float32", donotnormalize=True)
    s = Session(cfg, device=cuda)
    v = Viewer(mode="http", port=0)
    try:
        v.set_config_provider(s.config_snapshot)
        it = iter(SyntheticSource(height=16, width=256, depths_um=(30.0,)).frames())
        raws = np.stack([next(it) for _ in range(2)])
        r = s.process_group(raws)[-1]
        v.show_session_frame(s, raws[-1], r)
        code, body, _ = request(v.server.port, "/frame/bscan.png")
        assert code == 200
        np.testing.assert_array_equal(decode_png(body), render_bscan(r.bscandisp, s.ascanat))
        before = s.bscanthreshold
        request(v.server.port, "/key", b"]")
        for ch in v.pop_keys():
            s.key(ch)
        assert s.bscanthreshold == before + 1.0
        assert json.loads(request(v.server.port, "/config")[1])["live"]["bscanthreshold"] \
            == before + 1.0
    finally:
        v.close()
