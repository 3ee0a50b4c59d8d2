"""The whole slice: a JAX ``Session`` and a port ``Session(device="cpu")``
side by side on the same frames — 'b'/'p' captures, the batched
``process_group``, per-frame ``process``, threshold and averaging keys — for
the 'base' and 'sim' variants; and the port's import hygiene (no JAX).

Tolerances as tests/test_torch_pipeline.py: float64 'highest' to rounding;
bf16 magnitudes rtol 2e-3 of the peak and dB within 2e-2 on pixels within
40 dB of the peak (ratio by reciprocal in the port, by division in JAX);
uint8 displays within one level.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fdoct_tpu.config import PipelineConfig as JaxConfig
from fdoct_tpu.session import Session as JaxSession
from fdoct_tpu_torch.config import PipelineConfig
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
    ({}, dict(matmul_precision="int8_direct"), "Queue 1 item 7"),
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
    """A fresh interpreter imports the port and runs a small sim session on
    the CPU; neither jax nor the JAX package may be loaded."""
    prog = (
        "import sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import numpy as np\n"
        "import fdoct_tpu_torch\n"
        "from fdoct_tpu_torch import PipelineConfig, Session\n"
        "from fdoct_tpu_torch.sources.synthetic import SyntheticSource\n"
        "from fdoct_tpu_torch.utils.profiling import StageTimer\n"
        "cfg = PipelineConfig(width=256, height=32, averages=2, numfftpoints=512,\n"
        "                     numdisplaypoints=128, donotnormalize=False)\n"
        "src = SyntheticSource(height=32, width=256, noise=0.01)\n"
        "s = Session(cfg, device='cpu', variant='sim', source=src)\n"
        "s.key('b'); s.key('p')\n"
        "it = src.frames()\n"
        "res = [r for _ in range(2) for r in s.process_group(\n"
        "    np.stack([next(it) for _ in range(4)]))]\n"
        "assert len(res) == 4, len(res)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'fdoct_tpu'))\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "clean" in out.stdout
