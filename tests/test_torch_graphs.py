"""The session's group steps as pure functions (``session_group_pipeline``,
``session_group_pipeline_int8`` of ``fdoct_tpu_torch.session``) against the
JAX package's one-dispatch programs (``_session_group_pipeline``,
``_session_group_pipeline_int8``), and their CUDA graphs
(``fdoct_tpu_torch.graphs``).

On the CPU, at 32 × 256 with ``numfftpoints`` 512, on the same numpy-seeded
frames and calibration frames: the f32 step in float64 'highest' at rtol =
atol/max 1e-9 for dB, the linear B-scan, the per-frame magnitudes and the
preprocessed frames, and 0 levels for the uint8 displays (both chains compute
the same float64 operations in another order); the int8 step within one
uint8 level and dB rtol 1e-5, atol 1e-4, as tests/test_torch_int8direct.py
holds the int8 kernel's route against the XLA chain.  Both steps run under
``graphs.NoHostSync``, which fails on any read of a device value on the host.
The keys the session captures its graphs by change where JAX's programs
retrace, and only there.

Cases marked ``cuda`` (they skip here; on the card ``python -m pytest
--noconftest -m cuda tests/test_torch_graphs.py``) replay the captured
graphs: bit-equal to the eager step on every route, after a capture or a
threshold key too, with the launch counts of the eager step, and with
``torch.cuda.set_sync_debug_mode("error")`` silent over a replay.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from fdoct_tpu_torch import graphs
from fdoct_tpu_torch import session as tsession
from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.config import PipelineConfig
from fdoct_tpu_torch.graphs import CapturedStep, NoHostSync
from fdoct_tpu_torch.int8direct import Int8DirectPlan
from fdoct_tpu_torch.ops import kernels
from fdoct_tpu_torch.session import Session
from fdoct_tpu_torch.sources.synthetic import SyntheticSource

SMALL = dict(width=256, height=32, averages=4, numfftpoints=512, numdisplaypoints=160,
             lambdamin=816e-9, lambdamax=884e-9, compat=True)
CAL_LEAVES = ("op_re", "op_im", "window", "nearest_idx", "frac", "phase", "lambdas", "k",
              "klinear")
PLAN_LEAVES = ("oq_re", "oq_im", "s_re", "s_im", "row_gain_inv", "const_re", "const_im",
               "bg_rank1_resid")
#: a display floor inside the test frames' dB range (about -16 to 31 dB), so
#: that it clamps some pixels
THRESHOLD = -3.0
F64_TOL = 1e-9
THRESHOLD_DEFAULT = PipelineConfig().bscanthreshold


def inputs(groups: int, seed: int = 6):
    """(uint8 frames of ``groups`` groups of 4, background, π, dark), numpy."""
    src = SyntheticSource(height=32, width=256, noise=0.02, seed=seed)
    it = src.frames()
    raw = np.stack([next(it) for _ in range(4 * groups)])
    rng = np.random.default_rng(1)
    return (raw, np.maximum(src.background(), 1.0).astype(np.float64),
            rng.uniform(0, 8, (32, 256)), rng.uniform(0, 4, (32, 256)))


def allclose(got, want, rtol=F64_TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def jx():
    """The JAX package's programs, imported here so that the cuda cases run
    where JAX is not installed (``--noconftest -m cuda``)."""
    jnp = pytest.importorskip("jax.numpy")
    from fdoct_tpu.calibration import Calibration as JaxCalibration
    from fdoct_tpu.config import PipelineConfig as JaxConfig
    from fdoct_tpu.int8direct import Int8DirectPlan as JaxPlan
    from fdoct_tpu.session import _session_group_pipeline, _session_group_pipeline_int8
    return dict(jnp=jnp, JaxCalibration=JaxCalibration, JaxConfig=JaxConfig, JaxPlan=JaxPlan,
                f32=_session_group_pipeline, int8=_session_group_pipeline_int8)


def both(jx, **kw):
    """(JAX config and calibration, the port's config and a calibration
    from the JAX one's leaves)."""
    jcfg = jx["JaxConfig"](**{**SMALL, **kw})
    jcal = jx["JaxCalibration"].create(jcfg)
    tcfg = PipelineConfig(**dataclasses.asdict(jcfg))
    tcal = Calibration.from_arrays({n: np.asarray(getattr(jcal, n)) for n in CAL_LEAVES},
                                   tcfg, "cpu")
    return jcfg, jcal, tcfg, tcal


# --------------------------------------------------------------------------
# the f32 step against _session_group_pipeline


@pytest.mark.parametrize("groups", [1, 3])
@pytest.mark.parametrize("method", ["fused", "gather"])
@pytest.mark.parametrize("keep", [False, True], ids=["outputs", "keep_frames+keep_binned"])
@pytest.mark.parametrize("dark", [False, True], ids=["no_dark", "dark"])
def test_session_group_pipeline_matches_jax(jx, groups, method, keep, dark):
    jnp = jx["jnp"]
    jcfg, jcal, tcfg, tcal = both(jx, dtype="float64", matmul_precision="highest")
    raw, yb, yp, yd = inputs(groups)
    want, want_mags, want_binned = jx["f32"](
        jnp.asarray(raw), jnp.asarray(yb), jnp.asarray(yp), jnp.asarray(yd),
        jnp.asarray(THRESHOLD, jnp.float64), jcal, jcfg, groups, 4, method, dark, eps=1e-5,
        keep_frames=keep, keep_binned=keep)
    args = [torch.as_tensor(a) for a in (raw, yb, yp, yd)]
    thresh = torch.tensor(THRESHOLD, dtype=torch.float64)
    with NoHostSync():
        got, mags, binned = tsession.session_group_pipeline(
            *args, thresh, tcal, tcfg, groups, 4, method, dark, eps=1e-5, keep_frames=keep,
            keep_binned=keep)
    assert got.bscandisp.shape == (groups, 160, 32) and got.bscandisp.dtype == torch.uint8
    np.testing.assert_array_equal(got.bscandisp.numpy(), np.asarray(want.bscandisp))
    allclose(got.bscandb.numpy(), want.bscandb)
    allclose(got.bscan.numpy(), want.bscan)
    if keep:
        assert mags.shape == (4 * groups, 32, 160) and binned.shape == (4 * groups, 32, 256)
        allclose(mags.numpy(), want_mags)
        allclose(binned.numpy(), want_binned)
    else:
        assert mags is None and binned is None and want_mags is None


def test_session_group_pipeline_takes_colour_frames(jx):
    """(…, 3) frames: the channel is selected inside the step, as in JAX."""
    jnp = jx["jnp"]
    jcfg, jcal, tcfg, tcal = both(jx, dtype="float64", matmul_precision="highest",
                                  channelnum=0)
    raw, yb, yp, yd = inputs(2)
    rgb = np.stack([raw, raw // 2, raw // 3], axis=-1)
    want, _, _ = jx["f32"](jnp.asarray(rgb), jnp.asarray(yb), jnp.asarray(yp), jnp.asarray(yd),
                           jnp.asarray(THRESHOLD, jnp.float64), jcal, jcfg, 2, 4, "fused", False,
                           eps=1e-5)
    got, _, _ = tsession.session_group_pipeline(
        torch.as_tensor(rgb), *(torch.as_tensor(a) for a in (yb, yp, yd)),
        torch.tensor(THRESHOLD, dtype=torch.float64), tcal, tcfg, 2, 4, "fused", False, eps=1e-5)
    np.testing.assert_array_equal(got.bscandisp.numpy(), np.asarray(want.bscandisp))
    allclose(got.bscandb.numpy(), want.bscandb)


# --------------------------------------------------------------------------
# the int8 step against _session_group_pipeline_int8


@pytest.mark.parametrize("groups,clampupper,keep", [(1, False, False), (3, False, True),
                                                    (3, True, True)],
                         ids=["1-group", "3-groups+frames", "3-groups+clampupper"])
def test_session_group_pipeline_int8_matches_jax(jx, groups, clampupper, keep):
    jnp = jx["jnp"]
    jcfg, jcal, tcfg, _ = both(jx, dtype="float32", matmul_precision="int8_direct",
                               clampupper=clampupper)
    raw, yb, yp, _ = inputs(groups, seed=9)
    jplan = jx["JaxPlan"].create(jcal, jcfg, yb, yp)
    tplan = Int8DirectPlan.from_arrays({n: np.asarray(getattr(jplan, n)) for n in PLAN_LEAVES},
                                       "cpu")
    want, want_mags = jx["int8"](jnp.asarray(raw), jplan, jnp.asarray(THRESHOLD, jnp.float32),
                                 jcfg, groups, 4, eps=1e-5, keep_frames=keep)
    frames = torch.as_tensor(raw)
    with NoHostSync():
        got, mags = tsession.session_group_pipeline_int8(
            frames, tplan, THRESHOLD, tcfg, groups, 4, eps=1e-5, keep_frames=keep)
    assert got.bscandisp.shape == (groups, 160, 32) and got.bscandisp.dtype == torch.uint8
    assert np.abs(got.bscandisp.numpy().astype(int)
                  - np.asarray(want.bscandisp).astype(int)).max() <= 1
    np.testing.assert_allclose(got.bscandb.numpy(), np.asarray(want.bscandb), rtol=1e-5,
                               atol=1e-4)
    if keep:
        np.testing.assert_allclose(mags.numpy(), np.asarray(want_mags), rtol=1e-5,
                                   atol=1e-5 * float(np.abs(want_mags).max()))
    else:
        assert mags is None and want_mags is None


# --------------------------------------------------------------------------
# no host synchronisation, on each route the session takes


STEP_ROUTES = {
    "raw-kernel": dict(),
    "ratio-kernel+median": dict(donotnormalize=False, mediann=3),
    "gather": dict(method="gather"),
    "hilbert": dict(method="hilbert"),
    "clampupper": dict(clampupper=True),
    "saveframes": dict(saveframes=True),
    "dark": dict(variant="dark"),
    "float64": dict(dtype="float64"),
    "int8": dict(matmul_precision="int8_direct"),
    "int8+clampupper+saveframes": dict(matmul_precision="int8_direct", clampupper=True,
                                       saveframes=True),
}


def route_session(device, variant="base", method="fused", **kw):
    """A session with the calibration frames of :func:`inputs` set as its
    captures would set them, and 3 groups of frames."""
    cfg = PipelineConfig(**{**SMALL, "dtype": "float32", **kw})
    s = Session(cfg, device, variant=variant, method=method)
    raw, yb, yp, yd = inputs(3)
    dt = getattr(torch, cfg.dtype)
    s.data_yb, s.data_yp, s.data_yd = (torch.as_tensor(a, dtype=dt).to(device)
                                       for a in (yb, yp, yd))
    return s, raw


@pytest.mark.parametrize("route", list(STEP_ROUTES))
def test_session_steps_make_no_host_synchronisation(route):
    """The step of each route, as the session builds it for a batch, under
    NoHostSync: no value leaves the device inside it (a graph captures it
    whole), and it gives what process_group gives."""
    kw = dict(STEP_ROUTES[route])
    s, raw = route_session("cpu", **kw)
    key, state, step = s._group_step(raw.shape, torch.uint8, 3, 4)
    assert key[0] == ("int8" if "int8" in route else "f32")
    frames = torch.as_tensor(raw)
    with NoHostSync():
        outs, mags = step(frames)
    assert (mags is not None) == ("saveframes" in route)
    results = s.process_group(raw)
    np.testing.assert_array_equal(outs.bscandisp.numpy(), np.stack([r.bscandisp for r in results]))


def test_no_host_sync_catches_a_host_read():
    x = torch.ones(3)
    with pytest.raises(RuntimeError, match="_local_scalar_dense"), NoHostSync():
        float(x.sum())
    with pytest.raises(RuntimeError, match="lift_fresh"), NoHostSync():
        torch.as_tensor(2.0)


# --------------------------------------------------------------------------
# the keys the session captures its graphs by


def graph_id(s, raw):
    key, state, _ = s._group_step(raw.shape, torch.uint8, 3, 4)
    return key, state


def same(a, b) -> bool:
    return a[0] == b[0] and len(a[1]) == len(b[1]) and all(x is y for x, y in zip(a[1], b[1]))


def test_graph_key_follows_the_state_and_the_static_arguments():
    s, raw = route_session("cpu")
    first = graph_id(s, raw)
    assert same(graph_id(s, raw), first)
    s.key("]")                                    # the f32 floor is a device scalar
    assert same(graph_id(s, raw), first) and float(s._thresh) == THRESHOLD_DEFAULT + 1
    s.data_yp = s.data_yp.clone()                 # as a 'p' capture rebinds it
    second = graph_id(s, raw)
    assert not same(second, first)
    s.data_yb = s.data_yb * 2                     # as a 'b' capture rebinds it
    third = graph_id(s, raw)
    assert not same(third, second)
    s.key("a")                                    # averagestoggle 4 -> 1
    key, state, _ = s._group_step(raw.shape, torch.uint8, 12, s.averagestoggle)
    assert s.averagestoggle == 1 and key != third[0]
    s.key("a")                                    # back to 4
    assert same(graph_id(s, raw), third)
    s.key("q")                                    # clampupper: another program
    assert not same(graph_id(s, raw), third)
    assert graph_id(s, raw[:, :, :128])[0] != third[0]      # another frame shape


def test_int8_graph_key_holds_the_threshold_value():
    """The int8 kernel takes the floor by value: a threshold key makes
    another graph; a rebuilt plan (a capture) too."""
    s, raw = route_session("cpu", matmul_precision="int8_direct")
    first = graph_id(s, raw)
    assert first[0][0] == "int8" and first[1] == (s._i8plan,)
    assert same(graph_id(s, raw), first)
    s.key("[")
    second = graph_id(s, raw)
    assert second[0] != first[0] and second[0][1] == THRESHOLD_DEFAULT - 1
    s.data_yb = s.data_yb * 1.0
    assert not same(graph_id(s, raw), second)


def test_captured_step_lookup_compares_state_by_identity():
    """lookup answers only for the same state objects; the CPU has no graph
    to capture, so the entry is placed by hand."""
    steps = CapturedStep()
    a, b = torch.zeros(2), torch.zeros(2)
    steps._graphs["k"] = types.SimpleNamespace(state=(a,))
    assert steps.lookup("k", (a,)) is not None
    assert steps.lookup("k", (b,)) is None            # equal values, another tensor
    assert steps.lookup("other", (a,)) is None


def test_session_close_frees_the_graphs():
    s, raw = route_session("cpu")
    s.graphs._graphs["k"] = object()
    s.close()
    assert len(s.graphs) == 0


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CUDA_ROUTES = {
    "base-default": dict(),
    "base-highest": dict(matmul_precision="highest"),
    "ratio-kernel": dict(donotnormalize=False),
    "dark": dict(variant="dark"),
    "int8": dict(matmul_precision="int8_direct"),
    "int8+clampupper": dict(matmul_precision="int8_direct", clampupper=True),
    "saveframes": dict(saveframes=True),
    "gather": dict(method="gather"),
    "float64": dict(dtype="float64"),
}


def assert_same_outputs(got: list, want) -> None:
    """Results of process_group against stacked outputs, bit for bit."""
    np.testing.assert_array_equal(np.stack([r.bscandisp for r in got]),
                                  want.bscandisp.cpu().numpy())
    assert torch.equal(torch.stack([r.bscandb for r in got]), want.bscandb)
    assert torch.equal(torch.stack([r.bscan for r in got]), want.bscan)


def eager(s, raw):
    """The session's step for frames ``raw``, called eagerly."""
    _, _, step = s._group_step(raw.shape, torch.uint8, len(raw) // s.averagestoggle,
                               s.averagestoggle)
    return step(torch.as_tensor(raw).to(s.device))[0]


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(CUDA_ROUTES))
def test_cuda_replay_equals_the_eager_step(cuda, route):
    """The first batch captures (and runs the step eagerly), the next
    replay: every display, dB and linear B-scan bit-equal to the eager step
    on the same state, and each call counts the eager step's launches."""
    s, raw = route_session(cuda, **CUDA_ROUTES[route])
    other = raw[::-1].copy()
    kernels.reset_launches()
    first = s.process_group(raw)
    per_call = dict(kernels.LAUNCHES)
    second = s.process_group(other)
    third = s.process_group(raw)
    torch.cuda.synchronize()
    assert s.graphs.captures == 1 and len(s.graphs) == 1
    assert kernels.LAUNCHES == {k: 3 * v for k, v in per_call.items()}
    (_, captured), = s.graphs.items()
    assert captured.launches == {k: v for k, v in per_call.items() if v}
    for got, frames in ((first, raw), (second, other), (third, raw)):
        assert_same_outputs(got, eager(s, frames))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["default", "int8_direct"])
def test_cuda_captures_and_keys_between_batches(cuda, precision):
    """A threshold key, a 'b' and a 'p' capture between batches: the next
    group equals the eager step on the new state (the f32 floor rides a
    device scalar, the int8 one makes a new graph; a capture rebinds the
    calibration frames and the next batch captures again)."""
    s, raw = route_session(cuda, matmul_precision=precision)
    src = SyntheticSource(height=32, width=256, noise=0.02, seed=7)
    s.process_group(raw)
    s.process_group(raw)
    s.key("]")
    assert_same_outputs(s.process_group(raw), eager(s, raw))
    assert s.graphs.captures == (1 if precision == "default" else 2)
    for key, frames in (("b", [src.background()] * 4), ("p", [src.pi_frame()] * 4)):
        before = s.graphs.captures
        s.key(key)
        s.process_group(np.stack(frames))              # the per-frame path takes the capture
        assert_same_outputs(s.process_group(raw), eager(s, raw))
        assert s.graphs.captures == before + 1


@pytest.mark.cuda
def test_cuda_replay_makes_no_host_synchronisation(cuda):
    s, raw = route_session(cuda)
    s.process_group(raw)
    (_, captured), = s.graphs.items()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        captured.replay()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_captured_step_counts_and_evicts(cuda, monkeypatch):
    """A capture counts the eager run's launch only, each replay adds the
    graph's; the least recently used graph goes first; a new state
    recaptures in place."""
    from fdoct_tpu_torch.ops.kernels import fused_recon_raw_accumulate

    rng = np.random.default_rng(0)
    raw = torch.as_tensor(rng.integers(0, 255, (4, 64, 128), dtype=np.uint8)).to(cuda)
    pi = torch.zeros((64, 128), device=cuda)
    inv = torch.full((64, 128), 1 / 128.0, device=cuda)
    op = [torch.as_tensor(rng.normal(size=(128, 64)), dtype=torch.float32).to(cuda)
          for _ in range(2)]

    def fn(x):
        return fused_recon_raw_accumulate(x, pi, inv, *op) * 2

    monkeypatch.setattr(graphs, "MAX_GRAPHS", 2)
    steps = CapturedStep()
    kernels.reset_launches()
    want = steps.capture("a", (pi,), fn, (raw,))
    assert kernels.LAUNCHES["fused_recon_raw_accumulate"] == 1
    c = steps.lookup("a", (pi,))
    assert c.launches == {"fused_recon_raw_accumulate": 1} and c.pool_bytes >= 0
    assert torch.equal(c.replay(), want)
    assert kernels.LAUNCHES["fused_recon_raw_accumulate"] == 2
    steps.capture("b", (pi,), fn, (raw,))
    steps.lookup("a", (pi,))                      # "a" used last: "b" goes first
    steps.capture("c", (pi,), fn, (raw,))
    assert [k for k, _ in steps.items()] == ["a", "c"]
    assert steps.lookup("a", (inv,)) is None
    steps.capture("a", (inv,), fn, (raw,))
    assert len(steps) == 2 and steps.lookup("a", (inv,)) is not None
    steps.clear()
    assert len(steps) == 0
