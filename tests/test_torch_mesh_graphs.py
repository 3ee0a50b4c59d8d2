"""The session's batch steps on the device mesh (``session_mesh_pipeline``
and ``session_mesh_pipeline_int8`` of ``fdoct_tpu_torch.parallel.sharded``)
and the CUDA graphs that ``Session(mesh=)`` replays them through.

On the CPU, one gloo world of 4 ranks (``tests/torch_mesh_worker.py
--graphs``) runs a 3-group batch of every case of ``GRAPH_CASES`` (f32
'default' and 'highest', ``dark``, the 'sim' normalisation, a median k = 5
with its halo, int8, ``keep_frames``) on the 4 × 1, 2 × 2 and 1 × 4 meshes,
the batch step under ``graphs.NoHostSync`` on every rank.  Each case must:

- equal the per-group eager loop ``Session._process_group_mesh`` ran before
  its graph (``torch_mesh_worker.eager_batch``) bit for bit, and move the
  same ``COLLECTIVE_BYTES``;
- match the JAX package's ``build_session_bscan_step[_int8]`` run group by
  group on a JAX mesh of the same layout, within the tolerances
  tests/test_torch_parallel.py holds the float32 mesh session and the int8
  session step to: float32, the linear B-scan and each frame's magnitudes
  rtol 1e-4, atol 1e-6, dB atol 1e-4; int8, the linear B-scan and the
  magnitudes rtol 1e-5, atol 1e-5 of the peak, dB atol 1e-4; the uint8
  displays within 1 level (a knife-edge rounding).

Cases marked ``cuda`` (they skip here; on the card ``python -m pytest
--noconftest -m cuda tests/test_torch_mesh_graphs.py``) run a world of one
with nccl and a 1 × 1 mesh: each mesh route's replay bit-equal to its eager
step, one capture for several batches of a key, a capture again after a 'b'
capture rebinds the background, the launches and collective bytes of each
call the eager step's, and a replay with no host synchronisation.
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mesh_worker import (  # noqa: E402
    CFG8, CFG64, GRAPH_CASES, GRAPH_GROUPS, SESSION_CFG, spawn_world,
)

from fdoct_tpu_torch import graphs  # noqa: E402
from fdoct_tpu_torch.config import PipelineConfig  # noqa: E402
from fdoct_tpu_torch.ops import kernels  # noqa: E402
from fdoct_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from fdoct_tpu_torch.parallel.sharded import batch_block  # noqa: E402
from fdoct_tpu_torch.session import Session  # noqa: E402

LAYOUTS = [(4, 1), (2, 2), (1, 4)]
IDS = [f"{d}x{a}" for d, a in LAYOUTS]
CASES = list(GRAPH_CASES)
WORLD_TIMEOUT_S = 120
PLAN_LEAVES = ("oq_re", "oq_im", "s_re", "s_im", "row_gain_inv", "const_re", "const_im",
               "bg_rank1_resid")
OUTPUTS = ("bscan", "db", "disp", "mags")


# ---------------------------------------------------------------------------
# the JAX side, imported in fixtures (the GPU machine has no JAX)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from fdoct_tpu import parallel
    from fdoct_tpu.calibration import Calibration
    from fdoct_tpu.config import PipelineConfig as JaxConfig
    from fdoct_tpu.int8direct import Int8DirectPlan
    from fdoct_tpu.parallel import sharded
    from fdoct_tpu.sources.synthetic import SyntheticSource
    return dict(jax=jax, jnp=jnp, parallel=parallel, sharded=sharded, Calibration=Calibration,
                Config=JaxConfig, Plan=Int8DirectPlan, Source=SyntheticSource)


@pytest.fixture(scope="module")
def inputs(jx):
    """3 groups of 8 frames (16 × 128 u8) of tests/test_parallel.py's
    source, its background, a π and a dark frame, and the int8 plan the JAX
    package folds from them."""
    src = jx["Source"](height=16, width=128, depths_um=(40.0, 70.0), noise=0.01, seed=7)
    it = iter(src.frames())
    rng = np.random.default_rng(13)
    inp = dict(frames24=np.stack([next(it) for _ in range(8 * GRAPH_GROUPS)]).astype(np.uint8),
               bg=np.maximum(src.background().astype(np.float64), 1.0),
               pi24=rng.uniform(0.0, 8.0, (16, 128)), yd=rng.uniform(0.0, 3.0, (16, 128)))
    cfg8 = jx["Config"](**CFG8)
    plan = jx["Plan"].create(jx["Calibration"].create(cfg8), cfg8, inp["bg"], inp["pi24"])
    for name in PLAN_LEAVES:
        inp["plan24/" + name] = np.asarray(getattr(plan, name))
    return inp, plan


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    """Every rank's outputs; running out of WORLD_TIMEOUT_S fails."""
    try:
        return spawn_world(tmp_path_factory.mktemp("mesh_graphs"), 4, inputs[0],
                           ["--graphs", *IDS], WORLD_TIMEOUT_S)
    except TimeoutError as e:
        pytest.fail(str(e))


def outputs(world, layout, case, prefix=""):
    """Each rank's {output or byte count: array} of a case."""
    head = f"{layout[0]}x{layout[1]}/{case}/{prefix}"
    return [{k[len(head):]: v for k, v in rank.items()
             if k.startswith(head) and not k[len(head):].startswith("eager_")} for rank in world]


def jax_batch(jx, inputs, layout, case) -> dict:
    """JAX's session step of the case, one call a group on a JAX mesh of
    ``layout``: the stacked (bscan, dB, display[, magnitudes])."""
    inp, plan = inputs
    jnp, par, sh = jx["jnp"], jx["parallel"], jx["sharded"]
    change = dict(GRAPH_CASES[case])
    thresh = jnp.asarray(change.pop("thresh", -30.0), jnp.float32)
    dark, keep = change.pop("dark", False), change.pop("keep_frames", False)
    cfg = jx["Config"](**{**CFG64, "dtype": "float32", **change})
    mesh = jx["parallel"].make_mesh(*layout, devices=jx["jax"].devices()[:4])
    if cfg.matmul_precision == "int8_direct":
        step = sh.build_session_bscan_step_int8(mesh, plan, cfg, 8, keep_frames=keep)
        args = (thresh,)
    else:
        step = sh.build_session_bscan_step(mesh, jx["Calibration"].create(cfg), cfg, "fused", 8,
                                           dark=dark, keep_frames=keep)
        args = tuple(jnp.asarray(inp[k], jnp.float32) for k in ("bg", "pi24", "yd")) + (thresh,)
    groups = [step(par.shard_frames(jnp.asarray(inp["frames24"][g * 8:(g + 1) * 8]), mesh), *args)
              for g in range(GRAPH_GROUPS)]
    want = {name: np.stack([np.asarray(o[i]) for o in groups])
            for i, name in enumerate(OUTPUTS[:len(groups[0])])}
    if keep:
        want["mags"] = want["mags"].reshape(-1, *want["mags"].shape[2:])
    return want


# ---------------------------------------------------------------------------
# the batch step on the CPU (gloo)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_mesh_batch_step_equals_the_eager_loop(world, layout, case):
    """Bit for bit on every rank, and the same collective bytes."""
    d, a = layout
    for r, rank in enumerate(world):
        head = f"{d}x{a}/{case}/"
        names = [k[len(head):] for k in rank if k.startswith(head) and "eager_" not in k]
        assert {"bscan", "db", "disp", "bytes_all_reduce"} <= set(names)
        assert ("mags" in names) == GRAPH_CASES[case].get("keep_frames", False)
        for name in names:
            np.testing.assert_array_equal(rank[head + name], rank[head + "eager_" + name],
                                          err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_mesh_batch_step_matches_jax(jx, inputs, world, layout, case):
    """Every rank holds the whole B-scans (and frames): the same on every
    rank, and JAX's session step group by group within the tolerances."""
    ranks = outputs(world, layout, case)
    for rank in ranks[1:]:
        for name in OUTPUTS:
            if name in rank:
                np.testing.assert_array_equal(rank[name], ranks[0][name])
    got, want = ranks[0], jax_batch(jx, inputs, layout, case)
    assert set(want) == {n for n in OUTPUTS if n in got}
    assert got["disp"].dtype == np.uint8 and got["disp"].shape == want["disp"].shape
    assert np.abs(got["disp"].astype(int) - want["disp"].astype(int)).max() <= 1
    np.testing.assert_allclose(got["db"], want["db"], rtol=0, atol=1e-4)
    int8 = "int8" in case
    for name in ("bscan", "mags"):
        if name in want:
            w = want[name]
            np.testing.assert_allclose(got[name], w, rtol=1e-5 if int8 else 1e-4,
                                       atol=1e-5 * np.abs(w).max() if int8 else 1e-6)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_mesh_batch_bytes_match_design(world, layout):
    """Per group one (h_loc × ndisp) sum and 2 scalars, k//2 halo rows of
    its b_loc frames to each 'ascan' neighbour for the median; per batch one
    all-gather of the (groups, 3, ndisp, H) displays."""
    d, a = layout
    h_loc, b_loc, ndisp, item = 16 // a, 8 // d, CFG64["numdisplaypoints"], 4
    for r, rank in enumerate(world):
        got = {case: {k: int(v) for k, v in outputs(world, layout, case, "bytes_")[r].items()}
               for case in ("default", "median5")}
        gathered = GRAPH_GROUPS * 3 * ndisp * 16 * item
        assert got["default"] == {"all_reduce": GRAPH_GROUPS * (h_loc * ndisp + 2) * item,
                                  "all_gather": gathered, "send": 0}
        neighbours = (r % a > 0) + (r % a < a - 1)
        assert got["median5"]["send"] == GRAPH_GROUPS * neighbours * b_loc * 2 * 128
        assert got["median5"]["all_gather"] == gathered


def test_batch_block_is_each_groups_local_block():
    """Rank (d, a)'s blocks of a batch: frames d·b_loc … (d+1)·b_loc of each
    group, rows a·h_loc … (a+1)·h_loc; a strided view, not a copy."""
    frames = np.arange(3 * 8 * 4 * 2).reshape(24, 4, 2)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "ascan"), size=lambda i: (4, 2)[i],
                                 get_local_rank=lambda axis: {"data": 1, "ascan": 1}[axis])
    blocks = batch_block(frames, mesh, 3)
    assert blocks.shape == (3, 2, 2, 2) and np.shares_memory(blocks, frames)
    for g in range(3):
        np.testing.assert_array_equal(blocks[g], frames[g * 8 + 2:g * 8 + 4, 2:4])


# ---------------------------------------------------------------------------
# the counters a capture takes back and a replay adds


def test_captured_replay_adds_launches_and_collective_bytes():
    """A capture records the launches and bytes of the step into its graph
    and takes them back out of the counters (nothing ran); each replay adds
    them.  The CPU has no graph: a stand-in replays nothing."""
    kernels.reset_launches()
    tmesh.reset_collective_bytes()
    launched, moved = dict(kernels.LAUNCHES), dict(tmesh.COLLECTIVE_BYTES)
    kernels.LAUNCHES["fused_recon_raw_accumulate"] += 3         # what a step's capture counts
    tmesh.COLLECTIVE_BYTES["all_reduce"] += 100
    tmesh.COLLECTIVE_BYTES["all_gather"] += 40
    launches = graphs._taken_back(kernels.LAUNCHES, launched)
    moved = graphs._taken_back(tmesh.COLLECTIVE_BYTES, moved)
    assert launches == {"fused_recon_raw_accumulate": 3}
    assert moved == {"all_reduce": 100, "all_gather": 40}
    assert not any(kernels.LAUNCHES.values()) and not any(tmesh.COLLECTIVE_BYTES.values())
    replays = []
    captured = graphs.Captured(types.SimpleNamespace(replay=lambda: replays.append(1)), (), (),
                               (torch.ones(2),), launches, moved, 0)
    for n in (1, 2):
        out = captured.replay()
        assert len(replays) == n and torch.equal(out[0], torch.ones(2))
        assert out[0] is not captured.outputs[0]
        assert kernels.LAUNCHES["fused_recon_raw_accumulate"] == 3 * n
        assert tmesh.COLLECTIVE_BYTES == {"all_reduce": 100 * n, "all_gather": 40 * n, "send": 0}
    kernels.reset_launches()
    tmesh.reset_collective_bytes()


def test_mesh_is_not_an_eager_route():
    assert "mesh" not in graphs.EAGER_ROUTES


# ---------------------------------------------------------------------------
# the session's mesh keys, in a world of one on the CPU


@pytest.fixture
def cpu_world():
    from fdoct_tpu_torch.parallel import WorldOfOne, make_mesh
    with WorldOfOne("cpu"):
        yield make_mesh(1, 1, device_type="cpu")


def mesh_session(mesh, device="cpu", variant="base", **kw):
    """A mesh session with calibration frames set as captures set them (a
    rank-1 background, which the int8 fold takes), and 2 groups of frames."""
    cfg = PipelineConfig(**{**SESSION_CFG, **kw})
    s = Session(cfg, device, variant=variant, mesh=mesh)
    rng = np.random.default_rng(3)
    yb = np.outer(rng.uniform(0.9, 1.1, 16), rng.uniform(80, 180, 64))
    s.data_yb, s.data_yp, s.data_yd = (torch.as_tensor(a, dtype=torch.float32).to(s.device)
                                       for a in (yb, rng.uniform(0, 8, (16, 64)),
                                                 rng.uniform(0, 3, (16, 64))))
    return s, rng.integers(10, 250, (16, 16, 64)).astype(np.uint8)


def mesh_step(s, raw):
    return s._mesh_step(raw.shape, torch.uint8, len(raw) // s.averagestoggle, s.averagestoggle)


def eager_mesh(s, raw):
    """The session's mesh step for frames ``raw``, called eagerly."""
    *_, step = mesh_step(s, raw)
    blocks = batch_block(raw, s.mesh, len(raw) // s.averagestoggle)
    return step(torch.as_tensor(blocks).to(s.device))


def test_mesh_keys_follow_the_state_not_the_threshold(cpu_world):
    """The mesh keys: the route, the static arguments and the layout, no
    threshold (both routes read the floor from the device scalar); the
    state is (yb, yp, yd) or (plan,), compared with ``is``."""
    s, raw = mesh_session(cpu_world)
    key, state, _ = mesh_step(s, raw)
    assert key[0] == "mesh-f32" and key[-1] == (1, 1)
    assert state == (s.data_yb, s.data_yp, s.data_yd)
    s.key("]")
    assert mesh_step(s, raw)[0] == key and float(s._thresh) == s.bscanthreshold
    s.data_yb = s.data_yb * 2                               # as a 'b' capture rebinds it
    assert mesh_step(s, raw)[1][0] is s.data_yb
    assert mesh_step(s, raw[:8])[0] != key                  # another batch shape
    s8, raw8 = mesh_session(cpu_world, matmul_precision="int8_direct")
    key8, state8, _ = mesh_step(s8, raw8)
    s8.key("[")
    assert key8[0] == "mesh-int8" and state8 == (s8._i8plan,) and mesh_step(s8, raw8)[0] == key8


@pytest.mark.parametrize("kw", [{}, {"matmul_precision": "int8_direct", "saveframes": True}],
                         ids=["f32", "int8+saveframes"])
def test_cpu_mesh_session_runs_the_batch_step(cpu_world, kw):
    """On the CPU the session calls its mesh batch step eagerly: the
    displays are the step's, and nothing is captured or said eager."""
    s, raw = mesh_session(cpu_world, **kw)
    results = s.process_group(raw)
    outs, mags = eager_mesh(s, raw)
    np.testing.assert_array_equal(np.stack([r.bscandisp for r in results]), outs.bscandisp)
    assert torch.equal(torch.stack([r.bscandb for r in results]), outs.bscandb)
    assert (mags is not None) == bool(kw.get("saveframes"))
    assert len(s.graphs) == 0 and not any("eager" in m or "mesh unused" in m for m in s.status)


# ---------------------------------------------------------------------------
# on the card: a world of one with nccl and a 1 × 1 mesh


@pytest.fixture
def cuda_world():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from fdoct_tpu_torch.parallel import WorldOfOne, make_mesh
    with WorldOfOne("cuda"):
        yield make_mesh(1, 1, device_type="cuda")


CUDA_ROUTES = {
    "base-default": ("base", {}),
    "base-highest": ("base", {"matmul_precision": "highest"}),
    "sim": ("sim", {"donotnormalize": False}),
    "dark": ("dark", {}),
    "int8": ("base", {"matmul_precision": "int8_direct"}),
    "saveframes": ("base", {"saveframes": True}),
}


def assert_same_outputs(got: list, want) -> None:
    np.testing.assert_array_equal(np.stack([r.bscandisp for r in got]),
                                  want.bscandisp.cpu().numpy())
    assert torch.equal(torch.stack([r.bscandb for r in got]), want.bscandb)
    assert torch.equal(torch.stack([r.bscan for r in got]), want.bscan)


def counted(fn):
    """``fn()``'s result, and the launches and collective bytes it added."""
    kernels.reset_launches()
    tmesh.reset_collective_bytes()
    out = fn()
    torch.cuda.synchronize()
    return out, ({k: v for k, v in kernels.LAUNCHES.items() if v},
                 {k: v for k, v in tmesh.COLLECTIVE_BYTES.items() if v})


@pytest.mark.cuda
@pytest.mark.parametrize("route", list(CUDA_ROUTES))
def test_cuda_mesh_replay_equals_the_eager_step(cuda_world, route):
    """Three batches of one key: the first captures (its step runs eagerly
    once, on a fresh process the warm-up that makes the communicators), the
    next two replay; each bit-equal to the eager step on the same state,
    each with the eager step's launches and collective bytes."""
    variant, kw = CUDA_ROUTES[route]
    s, raw = mesh_session(cuda_world, "cuda", variant, **kw)
    try:
        other = raw[::-1].copy()
        calls = [counted(lambda f=f: (f, s.process_group(f))) for f in (raw, other, raw)]
        assert s.graphs.captures == 1 and len(s.graphs) == 1
        (key, captured), = s.graphs.items()
        assert key[0] == ("mesh-int8" if route == "int8" else "mesh-f32")
        for (frames, results), counts in calls:
            want, want_counts = counted(lambda f=frames: eager_mesh(s, f)[0])
            assert_same_outputs(results, want)
            assert counts == want_counts
        assert (captured.launches, captured.collective_bytes) == want_counts
        assert not any(m.startswith("CUDA graphs") for m in s.status)
    finally:
        s.close()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["default", "int8_direct"])
def test_cuda_mesh_recaptures_after_a_b_capture(cuda_world, precision):
    """A threshold key keeps the graph (the floor is a device scalar); a
    'b' capture rebinds the background and the next batch captures again;
    both give the eager step's outputs."""
    s, raw = mesh_session(cuda_world, "cuda", matmul_precision=precision)
    try:
        s.process_group(raw)
        s.key("]")
        assert_same_outputs(s.process_group(raw), eager_mesh(s, raw)[0])
        assert s.graphs.captures == 1
        s.key("b")
        s.process_group(np.full((8, 16, 64), 120, np.uint8))  # the per-frame path takes it
        assert_same_outputs(s.process_group(raw), eager_mesh(s, raw)[0])
        assert s.graphs.captures == 2
    finally:
        s.close()


@pytest.mark.cuda
def test_cuda_mesh_replay_makes_no_host_synchronisation(cuda_world):
    s, raw = mesh_session(cuda_world, "cuda")
    try:
        s.process_group(raw)
        (_, captured), = s.graphs.items()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with graphs.NoHostSync():
                captured.replay()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    finally:
        s.close()
