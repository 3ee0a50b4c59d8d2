"""Session checkpoints of the port (``fdoct_tpu_torch/utils/checkpoint.py``)
against the JAX package's (``fdoct_tpu/utils/checkpoint.py``): the same npz
keys, so an archive written by either package loads into the other's
session, both ways; the orbax backend refused; and the deliberate deviation
(ROADMAP Queue 3 item 4): a load empties the session's rings and resets
their toggle, where the JAX load leaves both as they were.

Tolerance: none.  Tensors and scalars go through npz unchanged, so every
restored field equals the saved one exactly (float64 and float32 alike).
"""

import dataclasses

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from fdoct_tpu.config import PipelineConfig as JaxConfig
from fdoct_tpu.session import Session as JaxSession
from fdoct_tpu.utils import checkpoint as jckpt
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.session import Session
from fdoct_tpu_torch.sources.synthetic import SyntheticSource
from fdoct_tpu_torch.utils import checkpoint as tckpt

CFG = dict(width=128, height=16, averages=2, numfftpoints=256, numdisplaypoints=64,
           lambdamin=816e-9, lambdamax=884e-9, compat=True, saveframes=True,
           saveinterferograms=True)
TENSORS = tckpt._TENSORS + tckpt._OPT_TENSORS
SCALARS = tckpt._SCALARS + tckpt._OPT_SCALARS


def configs(dtype="float64", **kw):
    jcfg = JaxConfig(**CFG, dtype=dtype, **kw)
    return jcfg, PipelineConfig(**dataclasses.asdict(jcfg))


def set_state(s, dtype, seed=1, asarray=torch.as_tensor):
    """Distinct seeded values in every checkpointed field of ``s``."""
    rng = np.random.default_rng(seed)
    shape = (s.cfg.oph, s.cfg.opw)
    for name in tckpt._TENSORS:
        setattr(s, name, asarray(rng.uniform(1, 5, shape).astype(dtype)))
    s.jscansave = asarray(rng.uniform(0, 1, (s.calib.ndisp, s.cfg.oph)).astype(dtype))
    s.manualaccum = asarray(rng.uniform(0, 1, (s.calib.ndisp, s.cfg.oph)).astype(dtype))
    s.averagestoggle, s.averages, s.bscanthreshold = 5, 7, -38.5
    s.exposure_us, s.gain, s.ascanat, s.vertposROI, s.widthROI = 2100, 3, 31, 12, 9
    s.indexi, s.manualindexi, s.manualaccumcount, s.jlockin = 4, 2, 1, True


def assert_same_state(got, want):
    """Every checkpointed field of ``got`` equals ``want``'s exactly."""
    for name in TENSORS:
        g, w = np.asarray(tckpt.to_host(getattr(got, name))), np.asarray(getattr(want, name))
        assert g.dtype == w.dtype and np.array_equal(g, w), name
    for name in SCALARS:
        assert getattr(got, name) == getattr(want, name), name
        assert type(getattr(got, name)) is type(getattr(want, name)), name
    assert got.cfg.to_json() == want.cfg.to_json()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_port_checkpoint_round_trips(tmp_path, dtype):
    _, tcfg = configs(dtype)
    s = Session(tcfg, device="cpu", variant="spinj")
    set_state(s, dtype)
    path = tckpt.save_session(s, tmp_path / "sess")              # suffixless
    assert path == tmp_path / "sess.npz" and path.exists()
    r = tckpt.load_session(tmp_path / "sess", device="cpu", variant="spinj")
    assert r.device.type == "cpu" and r.variant == "spinj"
    assert_same_state(r, s)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_jax_checkpoint_loads_into_the_port(tmp_path, dtype):
    jcfg, _ = configs(dtype)
    js = JaxSession(jcfg, variant="base")
    set_state(js, dtype, asarray=jnp.asarray)
    jckpt.save_session(js, tmp_path / "jax.npz")
    ts = tckpt.load_session(tmp_path / "jax.npz", device="cpu")
    assert_same_state(ts, js)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_port_checkpoint_loads_into_jax(tmp_path, dtype):
    _, tcfg = configs(dtype)
    ts = Session(tcfg, device="cpu")
    set_state(ts, dtype)
    tckpt.save_session(ts, tmp_path / "port.npz")
    js = jckpt.load_session(tmp_path / "port.npz")
    assert_same_state(ts, js)


def test_archives_hold_the_same_keys(tmp_path):
    """Both packages write the same keys, each array with the same dtype and
    shape; a session without J-lockin writes no jscansave in either."""
    jcfg, tcfg = configs()
    for armed in (True, False):
        js, ts = JaxSession(jcfg), Session(tcfg, device="cpu")
        set_state(js, "float64", asarray=jnp.asarray)
        set_state(ts, "float64")
        if not armed:
            js.jscansave = ts.jscansave = None
        with np.load(jckpt.save_session(js, tmp_path / "j.npz")) as a, \
                np.load(tckpt.save_session(ts, tmp_path / "t.npz")) as b:
            assert set(a.files) == set(b.files)
            assert ("tensor_jscansave" in b.files) == armed
            for k in a.files:
                assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
                assert np.array_equal(a[k], b[k]), k


def test_load_into_live_session_clears_rings(tmp_path):
    """The deviation: restoring into a running session empties both rings
    and sets the toggle back to its initial value, and restarts the group;
    the JAX load leaves its rings and toggle as they were (the reference
    fault, confirmed here)."""
    jcfg, tcfg = configs()
    src = SyntheticSource(height=16, width=128, noise=0.02, seed=3)
    it = src.frames()
    frames = [next(it) for _ in range(3)]
    js, ts = JaxSession(jcfg), Session(tcfg, device="cpu")
    for f in frames:                      # one group and a half: both rings filled
        js.process(f)
        ts.process(f)
    for s in (js, ts):
        assert s.zeroisactive is False and s.indextemp == 1
        assert any(len(part) for ring in s._rings.values() for part in ring.values())
    tckpt.save_session(ts, tmp_path / "c.npz")
    tckpt.load_session(tmp_path / "c.npz", session=ts)
    jckpt.load_session(tmp_path / "c.npz", session=js)
    assert ts.zeroisactive is True and ts.indextemp == 0
    assert all(len(part) == 0 for ring in ts._rings.values() for part in ring.values())
    assert not torch.any(ts.accum)
    assert js.zeroisactive is False                       # stale in the JAX load
    assert any(len(part) for ring in js._rings.values() for part in ring.values())
    # the restored port session then runs as a fresh one does
    fresh = Session(tcfg, device="cpu")
    for name in tckpt._TENSORS:
        setattr(fresh, name, getattr(ts, name))
    want = fresh.process_group(np.stack(frames[:2]))[0]
    got = ts.process_group(np.stack(frames[:2]))[0]
    assert np.array_equal(got.bscandisp, want.bscandisp)


def test_orbax_backend_is_refused(tmp_path):
    _, tcfg = configs()
    s = Session(tcfg, device="cpu")
    with pytest.raises(ValueError, match="orbax.*JAX"):
        tckpt.save_session(s, tmp_path / "o", backend="orbax")
    with pytest.raises(ValueError, match="orbax.*JAX"):
        tckpt.load_session(tmp_path / "o", backend="orbax", device="cpu")
    (tmp_path / "dir").mkdir()
    with pytest.raises(ValueError, match="directory"):
        tckpt.load_session(tmp_path / "dir", device="cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        tckpt.save_session(s, tmp_path / "x", backend="hdf5")


def test_required_scalar_missing_fails_loudly(tmp_path):
    """A damaged archive without a core scalar raises KeyError; one without
    the optional scalars and tensors keeps the session's defaults."""
    _, tcfg = configs()
    s = Session(tcfg, device="cpu")
    set_state(s, "float64")
    with np.load(tckpt.save_session(s, tmp_path / "full.npz")) as d:
        data = dict(d)
    np.savez(tmp_path / "nocore.npz", **{k: v for k, v in data.items() if k != "scalar_indexi"})
    with pytest.raises(KeyError):
        tckpt.load_session(tmp_path / "nocore.npz", device="cpu")
    old = {k: v for k, v in data.items()
           if k not in ("scalar_averages", "scalar_jlockin", "scalar_manualaccumcount",
                        "tensor_jscansave")}
    np.savez(tmp_path / "old.npz", **old)
    r = tckpt.load_session(tmp_path / "old.npz", device="cpu")
    assert r.averages == tcfg.averages and r.jlockin is False and r.jscansave is None
    assert r.indexi == 4
