"""The whole slice: a JAX ``Session`` and a port ``Session(device="cpu")``
side by side on the same frames — 'b'/'p' captures, the batched
``process_group``, per-frame ``process``, threshold and averaging keys — for
the 'base' and 'sim' variants and the int8-direct mode; and the port's import
hygiene (no JAX).

Tolerances as tests/test_torch_pipeline.py: float64 'highest' to rounding;
bf16 magnitudes rtol 2e-3 of the peak and dB within 2e-2 on pixels within
40 dB of the peak (ratio by reciprocal in the port, by division in JAX);
uint8 displays within one level.  int8-direct (both packages on one M, so on
one plan): linear rtol 1e-5, dB rtol 1e-5 and atol 1e-4, uint8 within one
level; against a bf16 session, pixels within 30 dB of the peak within 0.35 dB
(tests/test_int8direct.py:308-323).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")   # the JAX reference; without it (a GPU-only host) skip

from fdoct_tpu.config import PipelineConfig as JaxConfig
from fdoct_tpu.session import Session as JaxSession
from fdoct_tpu_torch import pipeline as tpl
from fdoct_tpu_torch import session as tsession
from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.int8direct import reconstruct_int8_direct, shift_u8_to_s8
from fdoct_tpu_torch.session import Session
from fdoct_tpu_torch.sources.synthetic import SyntheticSource

ROOT = Path(__file__).resolve().parent.parent
AVG = 4
CFG = dict(width=256, height=64, averages=AVG, numfftpoints=512, numdisplaypoints=128,
           lambdamin=816e-9, lambdamax=884e-9, compat=True)
PRECISIONS = {"highest64": ("highest", "float64"), "bf16": ("bf16", "float32")}
TOL = {"highest64": 1e-9, "bf16": 2e-3}
DB_TOL = {"highest64": 1e-8, "bf16": 2e-2}


class FixedSource:
    """Background and π frames drawn once, so that both sessions capture the
    same noisy frames (SyntheticSource draws new noise on every call)."""

    def __init__(self, src):
        self._background, self._pi = src.background(), src.pi_frame()

    def background(self):
        return self._background

    def pi_frame(self):
        return self._pi


@pytest.fixture(scope="module")
def source():
    src = SyntheticSource(height=64, width=256, noise=0.02, seed=4,
                          depths_um=(50.0, 120.0), reflectivities=(0.5, 0.3))
    it = src.frames()
    return FixedSource(src), np.stack([next(it) for _ in range(40)])


def configs(variant, prec_name, **extra):
    precision, dtype = PRECISIONS[prec_name]
    jcfg = JaxConfig(**CFG, matmul_precision=precision, dtype=dtype, **extra)
    if variant == "sim":
        jcfg = jcfg.replace(donotnormalize=False)   # as `fdoct sim` runs it
    return jcfg, PipelineConfig(**dataclasses.asdict(jcfg))


def drive(s, src, frames, variant):
    """Captures, two batched passes, per-frame frames, keys; every result."""
    out = []
    s.key("b")
    if variant == "base":
        out += [s.process(src.background()) for _ in range(AVG)]
        s.key("p")
        out += [s.process(f) for f in [src.pi_frame(), *frames[:AVG - 1]]]
    else:
        s.key("p")
        out += [s.process(f) for f in frames[:AVG]]
    out = [r for r in out if r is not None]
    out += s.process_group(frames[4:20])             # 4 groups, batched
    s.key("[")
    s.key("[")
    out += [r for f in frames[20:28] if (r := s.process(f)) is not None]
    out += s.process_group(frames[28:34])            # 6 % 4: per-frame fallback
    out += s.process_group(frames[34:36])            # completes the group
    s.key("a")                                       # averaging 4 → 1
    out += s.process_group(frames[36:39])
    return out


def assert_result_close(got, want, prec_name):
    w_lin, g_lin = np.asarray(want.bscan), got.bscan.numpy()
    tol = TOL[prec_name]
    np.testing.assert_allclose(g_lin, w_lin, rtol=tol, atol=tol * np.abs(w_lin).max())
    w_db, g_db = np.asarray(want.bscandb), got.bscandb.numpy()
    near = w_db >= w_db.max() - 40.0
    np.testing.assert_allclose(g_db[near], w_db[near], rtol=0, atol=DB_TOL[prec_name])
    assert got.bscandisp.dtype == np.uint8 and got.bscandisp.shape == want.bscandisp.shape
    assert np.abs(got.bscandisp.astype(int) - np.asarray(want.bscandisp).astype(int)).max() <= 1
    assert got.index == want.index


@pytest.mark.parametrize("prec_name", list(PRECISIONS))
@pytest.mark.parametrize("variant", ["base", "sim"])
def test_session_matches_jax(source, variant, prec_name):
    src, frames = source
    jcfg, tcfg = configs(variant, prec_name)
    js = JaxSession(jcfg, variant=variant, source=src)
    ts = Session(tcfg, device="cpu", variant=variant, source=src)
    want = drive(js, src, frames, variant)
    got = drive(ts, src, frames, variant)
    assert len(got) == len(want) == (2 if variant == "base" else 1) + 4 + 2 + 2 + 3
    for g, w in zip(got, want):
        assert_result_close(g, w, prec_name)
    for name in ("data_yb", "data_yp"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   rtol=1e-6)
    for name in ("zeroisactive", "indextemp", "averagestoggle", "bscanthreshold"):
        assert getattr(ts, name) == getattr(js, name), name


def test_strict_sim_matches_jax(source):
    src, frames = source
    jcfg, tcfg = configs("sim", "highest64", simcopyto=True)
    js = JaxSession(jcfg, variant="sim", source=src)
    ts = Session(tcfg, device="cpu", variant="sim", source=src)
    for s in (js, ts):
        s.key("b")
        s.key("p")
    want = [r for f in frames[:15] if (r := js.process(f)) is not None]
    got = [r for f in frames[:15] if (r := ts.process(f)) is not None]
    got += ts.process_group(frames[15:20])           # strict-sim never batches
    want += js.process_group(frames[15:20])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert_result_close(g, w, "highest64")


def test_fast_path_reason_is_said_once(source):
    src, frames = source
    _, tcfg = configs("base", "highest64")
    s = Session(tcfg, device="cpu")
    s.process_group(frames[:3])
    s.process_group(frames[3:5])
    assert sum("not divisible" in m for m in s.status) == 1
    assert s.indextemp == 1


@pytest.mark.parametrize("kwargs,extra,match", [
    (dict(variant="dark"), {}, "variant 'dark'"),
    (dict(variant="peak"), {}, "variant 'peak'"),
    (dict(mesh=object()), {}, "mesh"),
    ({}, dict(saveframes=True), "saveframes"),
    ({}, dict(saveinterferograms=True), "saveinterferograms"),
    ({}, dict(manualaveraging=True), "manualaveraging"),
    ({}, dict(bscanbinx=2), "bscanbinx"),
    (dict(variant="dark"), dict(matmul_precision="int8_direct"), "variant 'dark'"),
], ids=["dark", "peak", "mesh", "saveframes", "saveinterferograms", "manualaveraging",
        "bscanbin", "int8_direct"])
def test_unported_session_features_raise(source, kwargs, extra, match):
    src, frames = source
    _, tcfg = configs("base", "highest64")
    with pytest.raises(NotImplementedError, match=match):
        s = Session(tcfg.replace(**extra), device="cpu", **kwargs)
        s.process_group(frames[:AVG])


@pytest.mark.parametrize("key", ["s", "j", "c", "x", "\x1b", "q", "e", "+", "o"])
def test_unported_keys_raise(key):
    _, tcfg = configs("base", "highest64")
    s = Session(tcfg, device="cpu")
    with pytest.raises(NotImplementedError, match="key"):
        s.key(key)


def test_results_stay_on_device_but_display(source):
    src, frames = source
    _, tcfg = configs("base", "highest64")
    s = Session(tcfg, device="cpu")
    res = s.process_group(frames[:2 * AVG])
    assert len(res) == 2
    for r in res:
        assert torch.is_tensor(r.bscan) and torch.is_tensor(r.bscandb)
        assert isinstance(r.bscandisp, np.ndarray) and r.bscandisp.shape == (128, 64)


def test_port_never_imports_jax():
    """A fresh interpreter imports every module of the port and runs a small
    sim session on the CPU; neither jax nor the JAX package may be loaded,
    under any module name: no loaded module's file lies under fdoct_tpu/."""
    prog = (
        "import sys, importlib, pkgutil\n"
        "from pathlib import Path\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import numpy as np\n"
        "import fdoct_tpu_torch\n"
        "for m in pkgutil.walk_packages(fdoct_tpu_torch.__path__, 'fdoct_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from fdoct_tpu_torch import PipelineConfig, Session\n"
        "from fdoct_tpu_torch.sources.synthetic import SyntheticSource\n"
        "from fdoct_tpu_torch.utils.profiling import StageTimer\n"
        "import fdoct_tpu_torch.int8direct\n"
        "import fdoct_tpu_torch.bench_resident\n"
        "cfg = PipelineConfig(width=256, height=32, averages=2, numfftpoints=512,\n"
        "                     numdisplaypoints=128, donotnormalize=False)\n"
        "src = SyntheticSource(height=32, width=256, noise=0.01)\n"
        "s = Session(cfg, device='cpu', variant='sim', source=src)\n"
        "s.key('b'); s.key('p')\n"
        "it = src.frames()\n"
        "res = [r for _ in range(2) for r in s.process_group(\n"
        "    np.stack([next(it) for _ in range(4)]))]\n"
        "assert len(res) == 4, len(res)\n"
        "s8 = Session(cfg.replace(matmul_precision='int8_direct', donotnormalize=True),\n"
        "             device='cpu')\n"
        "assert len(s8.process_group(np.stack([next(it) for _ in range(2)]))) == 1\n"
        "assert s8._i8plan is not None\n"
        "from fdoct_tpu_torch.streaming import run_streaming\n"
        "out, _ = run_streaming(iter([np.zeros((32, 256), np.uint8)] * 4), len, batch=2,\n"
        "                       n_batches=2, device='cpu')\n"
        "assert out == [2, 2], out\n"
        "for method in ('gather', 'hilbert'):\n"
        "    g = Session(cfg.replace(donotnormalize=True), device='cpu', method=method)\n"
        "    assert len(g.process_group(np.stack([next(it) for _ in range(2)]))) == 1\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'fdoct_tpu'))\n"
        "assert not bad, bad\n"
        f"ref = Path({str(ROOT / 'fdoct_tpu')!r})\n"
        "files = [Path(f).resolve() for f in (getattr(m, '__file__', None)\n"
        "         for m in list(sys.modules.values())) if f]\n"
        "under = sorted(str(f) for f in files if f.is_relative_to(ref))\n"
        "assert not under, under\n"
        "assert 'fdoct_tpu_torch.ops.kernels' in sys.modules\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout


@pytest.mark.parametrize("pattern", [r"\b_shared\b", r"spec_from_file_location",
                                     r"load_reference_module", r"^\s*(import|from) fdoct_tpu\b(?!_)"],
                         ids=["_shared", "spec_from_file_location", "load_reference_module",
                              "import fdoct_tpu"])
def test_port_sources_load_nothing_of_the_jax_package(pattern):
    """No source of the port (nor chip_smoke.py) loads a module of fdoct_tpu/
    by any route: it keeps its own copies."""
    import re
    pkg = ROOT / "fdoct_tpu_torch"
    assert not (pkg / "_shared.py").exists()
    sources = [p for p in sorted(pkg.rglob("*")) if p.suffix in (".py", ".cu", ".cuh")]
    sources.append(ROOT / "chip_smoke.py")
    hits = [f"{p.relative_to(ROOT)}:{i}" for p in sources
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if re.search(pattern, line)]
    assert not hits, hits


# ---------------------------------------------------------------------------
# int8-direct display mode

I8 = dict(width=256, height=32, averages=4, numfftpoints=512, numdisplaypoints=160,
          lambdamin=816e-9, lambdamax=884e-9, dtype="float32", compat=True)
CAL_LEAVES = ("op_re", "op_im", "window", "nearest_idx", "frac", "phase", "lambdas", "k",
              "klinear")


@pytest.fixture(scope="module")
def i8_data():
    """tests/test_int8direct.py's fixture: 8 frames, a non-rank-1 background
    (per-row gain, 0.3 % noise) and π."""
    src = SyntheticSource(height=32, width=256, depths_um=(40.0, 80.0),
                          reflectivities=(0.5, 0.3), noise=0.01, seed=9)
    it = iter(src.frames())
    frames = np.stack([next(it) for _ in range(8)]).astype(np.uint8)
    rng = np.random.default_rng(3)
    bg = np.maximum(src.background().astype(np.float64), 1.0)
    bg = bg * (1.0 + 0.04 * np.sin(np.linspace(0, 3, 32)))[:, None]
    bg = bg * (1.0 + 0.003 * rng.standard_normal(bg.shape))
    pi = rng.uniform(0.0, 8.0, bg.shape)
    return frames, bg, pi, src


def i8_pair(bg, pi, precision="int8_direct", **extra):
    """A JAX and a port 'base' session on one M, with S(k) and π bound."""
    jcfg = JaxConfig(**I8, matmul_precision=precision, **extra)
    tcfg = PipelineConfig(**dataclasses.asdict(jcfg))
    js = JaxSession(jcfg, variant="base")
    tcal = Calibration.from_arrays({n: np.asarray(getattr(js.calib, n)) for n in CAL_LEAVES},
                                   tcfg, "cpu")
    ts = Session(tcfg, device="cpu", calib=tcal)
    js.data_yb, js.data_yp = jnp.asarray(bg, jnp.float32), jnp.asarray(pi, jnp.float32)
    ts.data_yb = torch.as_tensor(bg, dtype=torch.float32)
    ts.data_yp = torch.as_tensor(pi, dtype=torch.float32)
    return js, ts


def assert_i8_close(got, want):
    np.testing.assert_allclose(got.bscan.numpy(), np.asarray(want.bscan), rtol=1e-5)
    np.testing.assert_allclose(got.bscandb.numpy(), np.asarray(want.bscandb),
                               rtol=1e-5, atol=1e-4)
    w_u8 = np.asarray(want.bscandisp)
    assert got.bscandisp.dtype == np.uint8 and got.bscandisp.shape == w_u8.shape
    assert np.abs(got.bscandisp.astype(int) - w_u8.astype(int)).max() <= 1
    assert got.index == want.index


def test_int8_direct_process_group_matches_jax(i8_data):
    frames, bg, pi, _ = i8_data
    js, ts = i8_pair(bg, pi)
    want, got = js.process_group(frames), ts.process_group(frames)
    assert len(got) == len(want) == 2 and ts._i8plan is not None
    for g, w in zip(got, want):
        assert_i8_close(g, w)
    assert ts.zeroisactive == js.zeroisactive


@pytest.mark.parametrize("precision,band,limit", [("highest", 30.0, 0.35), ("bf16", 10.0, 0.1)])
def test_int8_direct_is_display_equivalent(i8_data, precision, band, limit):
    """The int8 display against the f32 chain with its precision pinned:
    within 30 dB of the peak to 0.35 dB of 'highest' (the function
    tests/test_int8direct.py compares on the CPU), and within 10 dB to 0.1 dB
    of 'bf16' (bf16 rounding adds its own error towards -30 dB)."""
    frames, bg, pi, _ = i8_data
    _, t8 = i8_pair(bg, pi)
    _, tf = i8_pair(bg, pi, precision=precision)
    for a, b in zip(tf.process_group(frames), t8.process_group(frames)):
        dbf, db8 = a.bscandb.numpy(), b.bscandb.numpy()
        signal = dbf > dbf.max() - band
        assert signal.sum() > 50
        assert np.abs(dbf - db8)[signal].max() < limit


def test_int8_direct_per_frame_matches_group_and_jax(i8_data):
    frames, bg, pi, _ = i8_data
    js, ts = i8_pair(bg, pi)
    _, tg = i8_pair(bg, pi)
    want = [r for f in frames[:4] if (r := js.process(f)) is not None]
    got = [r for f in frames[:4] if (r := ts.process(f)) is not None]
    group = tg.process_group(frames[:4])
    assert len(got) == len(want) == len(group) == 1
    assert_i8_close(got[0], want[0])
    np.testing.assert_allclose(got[0].bscandb.numpy(), group[0].bscandb.numpy(),
                               rtol=1e-5, atol=1e-4)
    assert np.abs(got[0].bscandisp.astype(int) - group[0].bscandisp.astype(int)).max() <= 1


def test_int8_direct_plan_rebuilt_on_capture(i8_data):
    """A 'b' capture rebinds data_yb, and the next frame gets a new plan."""
    frames, bg, pi, src = i8_data
    _, ts = i8_pair(bg, pi)
    ts.process(frames[0])
    p1 = ts._i8plan
    assert p1 is not None
    ts.key("b")
    for _ in range(ts.averagestoggle):
        ts.process(np.maximum(src.background(), 1).astype(np.uint8))
    assert not ts._pending
    ts.process(frames[1])
    assert ts._i8plan is not None and ts._i8plan is not p1
    assert not torch.equal(ts._i8plan.const_re, p1.const_re)
    p2 = ts._i8plan
    ts.process(frames[2])
    assert ts._i8plan is p2                   # no capture, no rebuild


def test_int8_direct_colour_planes(i8_data):
    """A single-plane select keeps exact uint8 counts and rides int8-direct
    (batched and per frame, equal to the grey frames); a channel sum is float
    and takes the f32 chain; both match JAX."""
    frames, bg, pi, _ = i8_data
    color = np.random.default_rng(5).integers(0, 255, (4, 32, 256, 3)).astype(np.uint8)
    color[..., 1] = frames[:4]                # channelnum=1 reads plane 2-1
    js, ts = i8_pair(bg, pi, channelnum=1)
    got = ts.process_group(color)
    assert ts._i8plan is not None
    assert_i8_close(got[0], js.process_group(color)[0])
    _, grey = i8_pair(bg, pi, channelnum=1)
    np.testing.assert_array_equal(got[0].bscandisp, grey.process_group(frames[:4])[0].bscandisp)
    _, per_frame = i8_pair(bg, pi, channelnum=1)
    outs = [r for f in color if (r := per_frame.process(f)) is not None]
    assert per_frame._i8plan is not None
    assert np.abs(outs[0].bscandisp.astype(int) - got[0].bscandisp.astype(int)).max() <= 1
    js_sum, ts_sum = i8_pair(bg, pi, channelnum=3)
    got_sum = ts_sum.process_group(color)
    assert ts_sum._i8plan is None and len(got_sum) == 1
    assert_result_close(got_sum[0], js_sum.process_group(color)[0], "bf16")


def test_int8_direct_per_frame_skips_preprocess(i8_data, monkeypatch):
    """No preprocess on the per-frame int8 path; a pending capture still
    gets its preprocessed frame."""
    frames, bg, pi, _ = i8_data
    calls = []
    for module in (tsession, tpl):
        orig = module.preprocess
        monkeypatch.setattr(module, "preprocess",
                            lambda *a, _orig=orig, **k: (calls.append(1), _orig(*a, **k))[1])
    _, ts = i8_pair(bg, pi)
    outs = [r for f in frames[:4] if (r := ts.process(f)) is not None]
    assert len(outs) == 1 and not calls
    ts.key("b")
    ts.process(frames[0])
    assert calls


def structured_bg():
    lam = np.linspace(0, 1, 256)
    spec1 = np.exp(-(((lam - 0.45) / 0.15) ** 2)) * 180.0 + 12.0
    spec2 = np.exp(-(((lam - 0.65) / 0.08) ** 2)) * 120.0
    return np.maximum(spec1[None, :] + 0.25 * np.linspace(0.0, 1.0, 32)[:, None]
                      * spec2[None, :], 1.0)


@pytest.mark.parametrize("kind", ["structured", "noise", "mediann"])
def test_int8_direct_fallbacks_are_the_bf16_chain(i8_data, kind):
    """A background whose rank-1 residual is too high, and a median filter,
    take the f32 chain: the bf16 branch on the CPU too, as JAX resolves
    'int8_direct' there."""
    frames, bg, pi, _ = i8_data
    extra = {}
    if kind == "structured":
        bg = structured_bg()
    elif kind == "noise":
        rng = np.random.default_rng(17)
        bg = np.maximum(bg * (1.0 + 0.05 * rng.standard_normal(bg.shape)), 1.0)
    else:
        extra = dict(mediann=3)
    js, ts = i8_pair(bg, pi, **extra)
    _, t16 = i8_pair(bg, pi, precision="bf16", **extra)
    assert not ts._use_int8_direct(torch.as_tensor(frames[0]))
    got, want = ts.process_group(frames), js.process_group(frames)
    assert ts._i8plan is None and len(got) == len(want) == 2
    if kind != "mediann":
        assert any("falling back to the exact f32" in m for m in ts.status)
    for g, w, b in zip(got, want, t16.process_group(frames)):
        assert_result_close(g, w, "bf16")
        np.testing.assert_array_equal(g.bscandb.numpy(), b.bscandb.numpy())


def test_int8_direct_clampupper_takes_the_plain_chain(i8_data):
    """clampupper is not in the fused kernel: the group runs
    form_bscan(reconstruct_int8_direct(...).sum(0)), and matches JAX."""
    frames, bg, pi, _ = i8_data
    js, ts = i8_pair(bg, pi, clampupper=True)
    got = ts.process_group(frames[:4])
    assert_i8_close(got[0], js.process_group(frames[:4])[0])
    plan = ts._i8plan
    want = tpl.form_bscan(reconstruct_int8_direct(shift_u8_to_s8(torch.as_tensor(frames[:4])),
                                                  plan).sum(0),
                          ts.cfg, 4, bscanthreshold=ts.bscanthreshold)
    np.testing.assert_array_equal(got[0].bscandb.numpy(), want.bscandb.numpy())
    np.testing.assert_array_equal(got[0].bscandisp, want.bscandisp.numpy())
