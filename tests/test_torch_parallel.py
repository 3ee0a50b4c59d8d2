"""The port's device mesh (``fdoct_tpu_torch.parallel``, ``Session(mesh=)``,
``run_streaming(sharding=)``) against the JAX package's, on the CPU.

One gloo world of 4 ranks per module (``tests/torch_mesh_worker.py``, a
``FileStore`` under the test's temporary directory, no TCP port) runs every
case on the 4 × 1, 2 × 2 and 1 × 4 meshes; each rank writes its local blocks.
Here they are assembled as the layouts say (B-scans ``P(None, 'ascan')``, the
same on every rank of a 'data' group; volumes ``P('data', None, None)`` or
whole with ``gather_full``) and held to the JAX functions on
``make_mesh(d, a, devices=jax.devices()[:4])`` over conftest's 8 virtual CPU
devices, on the inputs of tests/test_parallel.py and tests/test_streaming.py.
The CPU runs the kernels' plain versions.

Tolerances: float64 configs at atol 1e-9 (as the JAX tests; the frame sum
reassociates over 'data'), medians of integers included.  float32: dB
atol 1e-4 and the display in [0, 1] atol 1e-5; uint8 displays within 1 level
(a knife-edge rounding); the int8-direct path dB atol 1e-4, volumes rtol
1e-5, atol 1e-5 of the peak (both packages on one plan).  The collective
byte counts are the design numbers: one (h_loc × ndisp) sum and 2 scalars a
group, the session step the same, k//2 halo rows to each 'ascan' neighbour.

The ``cuda`` cases run a world of one with nccl on the card (``pytest
--noconftest -m cuda``); they import no JAX.
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mesh_worker import CFG8, CFG64, MEDIAN_KS, SESSION_CFG, spawn_world  # noqa: E402

LAYOUTS = [(4, 1), (2, 2), (1, 4)]
IDS = [f"{d}x{a}" for d, a in LAYOUTS]
WORLD_TIMEOUT_S = 120
PLAN_LEAVES = ("oq_re", "oq_im", "s_re", "s_im", "row_gain_inv", "const_re", "const_im",
               "bg_rank1_resid", "oq2_re", "oq2_im", "s2_re", "s2_im", "row_gain2")


# ---------------------------------------------------------------------------
# the JAX side, imported in fixtures (the GPU machine has no JAX)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from fdoct_tpu import parallel, session, streaming
    from fdoct_tpu.calibration import Calibration
    from fdoct_tpu.config import PipelineConfig
    from fdoct_tpu.int8direct import Int8DirectPlan
    from fdoct_tpu.parallel import sharded
    from fdoct_tpu.sources.synthetic import SyntheticSource
    return dict(jax=jax, jnp=jnp, parallel=parallel, sharded=sharded, session=session,
                streaming=streaming, Calibration=Calibration, Config=PipelineConfig,
                Plan=Int8DirectPlan, Source=SyntheticSource)


def rank2_background() -> np.ndarray:
    """tests/test_parallel.py's background for the rank-2 plan."""
    lam = np.linspace(0, 1, 128)
    return np.maximum(
        np.outer(1 + 0.05 * np.sin(np.linspace(0, 3, 16)),
                 np.exp(-(((lam - 0.45) / 0.15) ** 2)) * 180 + 12)
        + 0.25 * np.outer(np.linspace(0, 1, 16), np.exp(-(((lam - 0.65) / 0.08) ** 2)) * 120),
        1.0)


@pytest.fixture(scope="module")
def inputs(jx):
    src = jx["Source"](height=16, width=128, depths_um=(40.0, 70.0), noise=0.01, seed=7)
    it = iter(src.frames())
    frames = np.stack([next(it) for _ in range(8)]).astype(np.uint8)
    bg = np.maximum(src.background().astype(np.float64), 1.0)
    rng = np.random.default_rng(11)
    inp = dict(
        frames=frames, bg=bg, pi=np.zeros_like(bg),
        scaled=frames.astype(np.float64) * (1.0 + 0.5 * np.arange(8))[:, None, None],
        raw_bin=rng.integers(0, 250, (8, 32, 256)).astype(np.uint8),
        bg_bin=np.maximum(rng.integers(80, 180, (16, 128)).astype(np.float64), 1.0),
        yd=np.random.default_rng(5).uniform(0.0, 3.0, (16, 128)),
        rand=np.random.default_rng(3).integers(0, 255, (8, 16, 128)).astype(np.uint8),
        frames16=np.random.default_rng(7).integers(10, 250, (16, 16, 64)).astype(np.uint8))
    cfg8 = jx["Config"](**CFG8)
    cal8 = jx["Calibration"].create(cfg8)
    plans = {"plan/": jx["Plan"].create(cal8, cfg8, bg, np.zeros_like(bg)),
             "plan2/": jx["Plan"].create(cal8, cfg8, rank2_background(),
                                         np.zeros((16, 128)), rank=2)}
    for prefix, plan in plans.items():
        for name in PLAN_LEAVES:
            if getattr(plan, name) is not None:
                inp[prefix + name] = np.asarray(getattr(plan, name))
    return inp, plans


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    """Every rank's outputs; running out of WORLD_TIMEOUT_S fails."""
    try:
        return spawn_world(tmp_path_factory.mktemp("mesh4"), 4, inputs[0], IDS, WORLD_TIMEOUT_S)
    except TimeoutError as e:
        pytest.fail(str(e))


def jmesh(jx, layout):
    return jx["parallel"].make_mesh(*layout, devices=jx["jax"].devices()[:4])


def rank_outputs(world, layout, case, name):
    d, a = layout
    return [world[r][f"{d}x{a}/{case}/{name}"] for r in range(d * a)]


def columns(world, layout, case, name):
    """The whole (..., H) array from the ranks' P(None, 'ascan') blocks,
    each the same on every rank of its 'data' group."""
    d, a = layout
    blocks = rank_outputs(world, layout, case, name)
    for r, b in enumerate(blocks):
        np.testing.assert_array_equal(b, blocks[r % a])
    return np.concatenate(blocks[:a], axis=-1)


def frames_of(world, layout, case, name):
    """The whole (F, ...) array from the ranks' P('data', None, None) blocks,
    each the same on every rank of its 'ascan' group."""
    d, a = layout
    blocks = rank_outputs(world, layout, case, name)
    for r, b in enumerate(blocks):
        np.testing.assert_array_equal(b, blocks[r - r % a])
    return np.concatenate(blocks[::a], axis=0)


def jcfg(jx, **kw):
    return jx["Config"](**{**CFG64, **kw})


def jax_bscan(jx, inputs, layout, frames="frames", **kw):
    """JAX's sharded_bscan_step on its mesh: (dB, display in [0, 1])."""
    inp, _ = inputs
    jnp, par = jx["jnp"], jx["parallel"]
    cfg = jcfg(jx, **kw)
    mesh = jmesh(jx, layout)
    bg = inp["bg"].astype(cfg.dtype)
    db, disp = par.sharded_bscan_step(par.shard_frames(jnp.asarray(inp[frames]), mesh),
                                      jnp.asarray(bg), jnp.zeros_like(jnp.asarray(bg)),
                                      jx["Calibration"].create(cfg), cfg, mesh)
    return np.asarray(db), np.asarray(disp)


# ---------------------------------------------------------------------------
# B-scan steps


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_sharded_bscan_matches_jax(jx, inputs, world, layout):
    db, disp = jax_bscan(jx, inputs, layout)
    np.testing.assert_allclose(columns(world, layout, "bscan", "db"), db, rtol=0, atol=1e-9)
    np.testing.assert_allclose(columns(world, layout, "bscan", "disp"), disp, rtol=0, atol=1e-9)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_sharded_bscan_float32_matches_jax(jx, inputs, world, layout):
    """float32 u8 frames with an identity preprocess: each rank's block
    takes the raw-input group step (kernel 1's plain version here)."""
    db, disp = jax_bscan(jx, inputs, layout, dtype="float32")
    np.testing.assert_allclose(columns(world, layout, "bscan_f32", "db"), db, rtol=0, atol=1e-4)
    np.testing.assert_allclose(columns(world, layout, "bscan_f32", "disp"), disp, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_sharded_clampupper_matches_jax(jx, inputs, world, layout):
    """The absolute-scale pixel (5, 5) lies on exactly one 'ascan' rank."""
    _, disp = jax_bscan(jx, inputs, layout, clampupper=True, clampupperdb=50.0)
    got = columns(world, layout, "clamp", "disp")
    np.testing.assert_allclose(got, disp, rtol=0, atol=1e-9)
    assert got[5, 5] == disp[5, 5]


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_sharded_per_frame_normalization_matches_jax(jx, inputs, world, layout):
    db, _ = jax_bscan(jx, inputs, layout, frames="scaled", donotnormalize=False)
    np.testing.assert_allclose(columns(world, layout, "normalize", "db"), db, rtol=0, atol=1e-9)


@pytest.mark.parametrize("k", MEDIAN_KS)
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_sharded_median_halo_matches_jax(jx, inputs, world, layout, k):
    db, _ = jax_bscan(jx, inputs, layout, mediann=k)
    np.testing.assert_allclose(columns(world, layout, f"median{k}", "db"), db, rtol=0, atol=1e-9)


def test_sharded_median_halo_too_thin_raises(jx, inputs, world):
    """16 rows over 4 'ascan' ranks are 4 rows, fewer than mediann=11's 5:
    both packages refuse, with the same message; a 2-rank 'ascan' axis (8
    rows) and no 'ascan' sharding compute."""
    with pytest.raises(ValueError, match="median halo") as e:
        jax_bscan(jx, inputs, (1, 4), mediann=11)
    assert {str(m) for m in rank_outputs(world, (1, 4), "median_thin", "error")} == {
        str(e.value)}
    for layout in ((4, 1), (2, 2)):
        assert {str(m) for m in rank_outputs(world, layout, "median_thin", "error")} == {""}


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_sharded_median_and_normalize_together_match_jax(jx, inputs, world, layout):
    db, _ = jax_bscan(jx, inputs, layout, mediann=3, donotnormalize=False)
    np.testing.assert_allclose(columns(world, layout, "median_norm", "db"), db, rtol=0,
                               atol=1e-9)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_sharded_median_with_binning_matches_jax(jx, inputs, world, layout):
    """The halo runs on raw rows (median, then bin), 2 raw rows a binned row."""
    inp, _ = inputs
    jnp, par = jx["jnp"], jx["parallel"]
    cfg = jcfg(jx, width=256, height=32, binvalue=2, mediann=3)
    mesh = jmesh(jx, layout)
    db, _ = par.sharded_bscan_step(par.shard_frames(jnp.asarray(inp["raw_bin"]), mesh),
                                   jnp.asarray(inp["bg_bin"]), jnp.zeros((16, 128)),
                                   jx["Calibration"].create(cfg), cfg, mesh)
    np.testing.assert_allclose(columns(world, layout, "median_bin", "db"), np.asarray(db),
                               rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# int8-direct


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_sharded_bscan_int8_matches_jax(jx, inputs, world, layout):
    """The operator whole on every rank, the per-row tables sliced to its rows."""
    inp, plans = inputs
    jnp, par = jx["jnp"], jx["parallel"]
    mesh = jmesh(jx, layout)
    db, disp = par.sharded_bscan_step_int8(par.shard_frames(jnp.asarray(inp["frames"]), mesh),
                                           plans["plan/"], jx["Config"](**CFG8), mesh)
    np.testing.assert_allclose(columns(world, layout, "bscan_int8", "db"), np.asarray(db),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(columns(world, layout, "bscan_int8", "disp"), np.asarray(disp),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_rank2_plan_on_the_mesh_matches_jax(jx, inputs, world, layout):
    inp, plans = inputs
    jnp, sh = jx["jnp"], jx["sharded"]
    mesh = jmesh(jx, layout)
    cfg8 = jx["Config"](**CFG8)
    step = sh.build_session_bscan_step_int8(mesh, plans["plan2/"], cfg8, 8)
    _, db, _ = step(jx["parallel"].shard_frames(jnp.asarray(inp["rand"]), mesh),
                    jnp.asarray(cfg8.bscanthreshold, jnp.float32))
    np.testing.assert_allclose(columns(world, layout, "rank2", "db"), np.asarray(db), rtol=0,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# C-scan volumes


@pytest.mark.parametrize("gather_full", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_sharded_cscan_matches_jax(jx, inputs, world, layout, gather_full):
    inp, _ = inputs
    jnp, par = jx["jnp"], jx["parallel"]
    cfg = jcfg(jx)
    mesh = jmesh(jx, layout)
    want = np.asarray(par.sharded_cscan_volume(
        par.shard_frames(jnp.asarray(inp["frames"]), mesh), jnp.asarray(inp["bg"]),
        jnp.asarray(inp["pi"]), jx["Calibration"].create(cfg), cfg, mesh,
        gather_full=gather_full))
    case = f"cscan_{gather_full}"
    if gather_full:
        for vol in rank_outputs(world, layout, case, "vol"):
            np.testing.assert_allclose(vol, want, rtol=0, atol=1e-9)
    else:
        np.testing.assert_allclose(frames_of(world, layout, case, "vol"), want, rtol=0,
                                   atol=1e-9)


@pytest.mark.parametrize("gather_full", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_sharded_cscan_int8_matches_jax(jx, inputs, world, layout, gather_full):
    inp, plans = inputs
    jnp, par = jx["jnp"], jx["parallel"]
    mesh = jmesh(jx, layout)
    want = np.asarray(par.sharded_cscan_volume_int8(
        par.shard_frames(jnp.asarray(inp["frames"]), mesh), plans["plan/"],
        jx["Config"](**CFG8), mesh, gather_full=gather_full))
    case = f"cscan_int8_{gather_full}"
    got = (rank_outputs(world, layout, case, "vol") if gather_full
           else [frames_of(world, layout, case, "vol")])
    for vol in got:
        np.testing.assert_allclose(vol, want, rtol=1e-5, atol=1e-5 * want.max())


# ---------------------------------------------------------------------------
# the session steps, the session and the stream


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_session_step_matches_jax(jx, inputs, world, layout):
    """dark, keep_frames and keep_binned: (bscan, dB, uint8, each frame's
    magnitudes, the binned frames less the dark frame)."""
    inp, _ = inputs
    jnp, par = jx["jnp"], jx["parallel"]
    cfg = jcfg(jx)
    mesh = jmesh(jx, layout)
    step = jx["sharded"].build_session_bscan_step(mesh, jx["Calibration"].create(cfg), cfg,
                                                  "fused", 8, dark=True, keep_frames=True,
                                                  keep_binned=True)
    want = [np.asarray(x) for x in step(
        par.shard_frames(jnp.asarray(inp["frames"]), mesh), jnp.asarray(inp["bg"]),
        jnp.asarray(inp["pi"]), jnp.asarray(inp["yd"]),
        jnp.asarray(cfg.bscanthreshold, jnp.float64))]
    for name, w in zip(("bscan", "db"), want):
        np.testing.assert_allclose(columns(world, layout, "session_step", name), w, rtol=1e-9,
                                   atol=1e-9)
    disp = columns(world, layout, "session_step", "disp")
    assert disp.dtype == np.uint8
    assert np.abs(disp.astype(int) - want[2].astype(int)).max() <= 1
    d, a = layout
    for i, name in ((3, "mags"), (4, "binned")):
        blocks = rank_outputs(world, layout, "session_step", name)
        whole = np.concatenate([np.concatenate(blocks[di * a:(di + 1) * a], axis=-2)
                                for di in range(d)], axis=0)
        np.testing.assert_allclose(whole, want[i], rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_session_step_int8_matches_jax(jx, inputs, world, layout):
    inp, plans = inputs
    jnp, par = jx["jnp"], jx["parallel"]
    mesh = jmesh(jx, layout)
    cfg8 = jx["Config"](**CFG8)
    step = jx["sharded"].build_session_bscan_step_int8(mesh, plans["plan/"], cfg8, 8,
                                                       keep_frames=True)
    bscan, db, disp, mags = (np.asarray(x) for x in step(
        par.shard_frames(jnp.asarray(inp["frames"]), mesh),
        jnp.asarray(cfg8.bscanthreshold, jnp.float32)))
    np.testing.assert_allclose(columns(world, layout, "session_step_int8", "bscan"), bscan,
                               rtol=1e-5, atol=1e-5 * bscan.max())
    np.testing.assert_allclose(columns(world, layout, "session_step_int8", "db"), db, rtol=0,
                               atol=1e-4)
    got = columns(world, layout, "session_step_int8", "disp")
    assert np.abs(got.astype(int) - disp.astype(int)).max() <= 1
    d, a = layout
    blocks = rank_outputs(world, layout, "session_step_int8", "mags")
    whole = np.concatenate([np.concatenate(blocks[di * a:(di + 1) * a], axis=-2)
                            for di in range(d)], axis=0)
    np.testing.assert_allclose(whole, mags, rtol=1e-5, atol=1e-5 * mags.max())


@pytest.mark.parametrize("precision", ["default", "int8_direct"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_mesh_session_matches_jax(jx, inputs, world, layout, precision):
    """Session(mesh=) over two groups with saveframes: every rank holds the
    whole B-scans and the whole ring of per-frame magnitudes, as the JAX
    mesh session."""
    inp, _ = inputs
    cfg = jx["Config"](**SESSION_CFG, matmul_precision=precision, saveframes=True)
    s = jx["session"].Session(cfg, mesh=jmesh(jx, layout))
    rs = s.process_group(inp["frames16"])
    assert len(rs) == 2
    case = f"session_{precision}"
    for r in range(4):
        got = {n: world[r][f"{layout[0]}x{layout[1]}/{case}/{n}"]
               for n in ("bscan", "db", "disp", "ring")}
        np.testing.assert_allclose(got["bscan"], np.stack([np.asarray(x.bscan) for x in rs]),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["db"], np.stack([np.asarray(x.bscandb) for x in rs]),
                                   rtol=0, atol=1e-4)
        want = np.stack([np.asarray(x.bscandisp) for x in rs]).astype(int)
        assert np.abs(got["disp"].astype(int) - want).max() <= 1
        ring = np.stack([np.asarray(m) for m in s._rings[1]["bscan"]])
        np.testing.assert_allclose(got["ring"], ring, rtol=1e-4, atol=1e-6)


def test_mesh_session_fallback_is_said_once_and_matches_jax(jx, inputs, world):
    """averages 6 on a 'data' axis of 4: both sessions take the
    single-device path, say why once, and compute the same B-scans."""
    inp, _ = inputs
    cfg = jx["Config"](**dict(SESSION_CFG, averages=6))
    s = jx["session"].Session(cfg, mesh=jmesh(jx, (4, 1)))
    rs = s.process_group(inp["frames16"][:12]) + s.process_group(inp["frames16"][:12])
    want = np.stack([np.asarray(r.bscandb) for r in rs])
    for r in range(4):
        np.testing.assert_allclose(world[r]["4x1/fallback/db"], want, rtol=0, atol=1e-4)
        status = str(world[r]["4x1/fallback/status"]).split("\n")
        mesh_lines = [m for m in s.status if "mesh" in m]
        assert [m for m in status if "mesh" in m] == mesh_lines
        assert len(mesh_lines) == 1 and "not divisible by mesh 'data' axis 4" in mesh_lines[0]


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_run_streaming_sharded_matches_jax(jx, inputs, world, layout):
    """run_streaming(sharding=mesh): the step gets each rank's (b_loc,
    h_loc, W) block, only the block copied; the dB matches JAX's stream."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    inp, _ = inputs
    jnp = jx["jnp"]
    cfg = jx["Config"](**SESSION_CFG)
    mesh = jmesh(jx, layout)
    s = jx["session"].Session(cfg, mesh=mesh)
    step = jx["sharded"].build_session_bscan_step(mesh, s.calib, cfg, "fused", 8)
    thresh = jnp.asarray(cfg.bscanthreshold, jnp.float32)
    outs, _ = jx["streaming"].run_streaming(
        iter(list(inp["frames16"])),
        lambda fr: step(fr, s.data_yb, s.data_yp, s.data_yd, thresh)[1],
        batch=8, n_batches=2, sharding=NamedSharding(mesh, P("data", "ascan", None)))
    want = np.stack([np.asarray(o) for o in outs])
    np.testing.assert_allclose(columns(world, layout, "stream", "db"), want, rtol=0, atol=1e-4)
    d, a = layout
    for seen in rank_outputs(world, layout, "stream", "seen"):
        assert seen.tolist() == [[8 // d, 16 // a, 64]] * 2
    assert {int(n) for n in rank_outputs(world, layout, "stream", "frames_in")} == {16}


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_streamed_cscan_matches_jax(jx, inputs, world, layout):
    """Each rank streams its block of the volume; the gathered C-scan on
    every rank is JAX's volume."""
    inp, _ = inputs
    jnp, par = jx["jnp"], jx["parallel"]
    cfg = jcfg(jx)
    mesh = jmesh(jx, layout)
    want = np.asarray(par.sharded_cscan_volume(
        par.shard_frames(jnp.asarray(inp["frames"]), mesh), jnp.asarray(inp["bg"]),
        jnp.asarray(inp["pi"]), jx["Calibration"].create(cfg), cfg, mesh, gather_full=True))
    for vol in rank_outputs(world, layout, "stream_cscan", "vol"):
        np.testing.assert_allclose(vol, want, rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# the collectives' bytes (the counterpart of tests/test_parallel.py's HLO
# accounting through scripts/bench_scaling.collective_bytes)


@pytest.mark.parametrize("layout", LAYOUTS, ids=IDS)
def test_collective_bytes_match_design(world, layout):
    d, a = layout
    h_loc, ndisp, item = 16 // a, CFG64["numdisplaypoints"], 8
    sum_and_scalars = h_loc * ndisp * item + 2 * item
    for r in range(4):
        out = {k.split("/", 1)[1]: v for k, v in world[r].items() if k.startswith(f"{d}x{a}/")}
        assert int(out["bscan/bytes"]) == sum_and_scalars
        # the session step moves what the offline step moves, and gathers nothing
        assert int(out["session_step/all_reduce"]) == sum_and_scalars
        assert int(out["session_step/all_gather"]) == 0
        # the halo: k//2 raw u8 rows of its b_loc frames to each 'ascan'
        # neighbour, nothing else added
        neighbours = (r % a > 0) + (r % a < a - 1)
        for k in MEDIAN_KS:
            assert int(out[f"median{k}/sent"]) == neighbours * (8 // d) * (k // 2) * 128
            assert int(out[f"median{k}/all_reduce"]) == sum_and_scalars
        # the C-scan: its f_loc whole B-scans, then every frame with gather_full
        vol = (8 // d) * ndisp * 16 * item
        assert int(out["cscan_False/gathered"]) == vol
        assert int(out["cscan_True/gathered"]) == vol + 8 * ndisp * 16 * item


# ---------------------------------------------------------------------------
# on the card: a world of one with nccl


@pytest.fixture
def cuda_world():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from fdoct_tpu_torch.parallel import WorldOfOne, make_mesh
    with WorldOfOne("cuda"):
        yield make_mesh(1, 1, device_type="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("precision,variant", [("default", "base"), ("highest", "base"),
                                               ("default", "sim")])
def test_cuda_mesh_session_launches_the_group_kernel_once_a_group(cuda_world, precision,
                                                                  variant):
    """A 1 × 1 nccl mesh session launches what the single-device session
    launches (kernel 1, or kernel 2 after the 'sim' normalization), once a
    group, and its displays are the single-device session's."""
    from fdoct_tpu_torch.config import PipelineConfig
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.session import Session

    cfg = PipelineConfig(**dict(SESSION_CFG, matmul_precision=precision,
                                donotnormalize=variant == "base"))
    frames = np.random.default_rng(7).integers(10, 250, (16, 16, 64)).astype(np.uint8)
    single = Session(cfg, "cuda", variant=variant).process_group(frames)
    kernels.reset_launches()
    mesh = Session(cfg, "cuda", variant=variant, mesh=cuda_world).process_group(frames)
    torch.cuda.synchronize()
    name = "fused_recon_raw_accumulate" if variant == "base" else "fused_recon_accumulate"
    assert {k: v for k, v in kernels.LAUNCHES.items() if v} == {name: 2}
    for a, b in zip(single, mesh):
        assert np.abs(a.bscandisp.astype(int) - b.bscandisp.astype(int)).max() <= 1
        assert float((a.bscandb - b.bscandb).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_mesh_volume_matches_one_device(cuda_world):
    from fdoct_tpu_torch.calibration import Calibration
    from fdoct_tpu_torch.config import PipelineConfig
    from fdoct_tpu_torch.parallel import shard_frames, sharded_cscan_volume
    from fdoct_tpu_torch.pipeline import apodize_ratio, ascan_mags, preprocess

    cfg = PipelineConfig(**dict(CFG64, dtype="float32"))
    cal = Calibration.create(cfg, "cuda")
    frames = np.random.default_rng(1).integers(0, 255, (8, 16, 128)).astype(np.uint8)
    bg = torch.full((16, 128), 100.0, device="cuda")
    pi = torch.zeros_like(bg)
    fr = torch.as_tensor(frames).cuda()
    one = sharded_cscan_volume(fr, bg, pi, cal, cfg)
    mesh = sharded_cscan_volume(shard_frames(frames, cuda_world), bg, pi, cal, cfg, cuda_world,
                                gather_full=True)
    # the mesh runs the chain of torch.matmul products, bit for bit the
    # single card's chain; one card takes the volume's kernel, held to that
    # chain at the kernel's tolerance (the same bf16 operands, the ratio
    # formed by 1/S(k), its f32 sums rounded in another order)
    chain = ascan_mags(apodize_ratio(preprocess(fr, cfg), bg, pi, cfg), cal, "fused",
                       cfg.matmul_precision).transpose(-1, -2)
    torch.testing.assert_close(mesh, chain, rtol=0, atol=0)
    tol = 2e-2                       # chip_smoke.py's TOL["bf16"], the kernel's own
    torch.testing.assert_close(one, chain, rtol=tol, atol=tol * float(chain.abs().max()))


@pytest.mark.cuda
def test_cuda_mesh_stream_gives_the_step_the_source_frames(cuda_world):
    """run_streaming(sharding=) on a 1 × 1 nccl mesh: the rank's block of
    each batch goes through utils.to_device on the side copy stream, and
    the step sees exactly the frames the source gave."""
    from fdoct_tpu_torch.streaming import run_streaming

    frames = np.random.default_rng(2).integers(0, 255, (24, 16, 64), dtype=np.uint8)
    got, stats = run_streaming(iter(list(frames)), lambda d: d.clone(), batch=8, n_batches=3,
                               device="cuda", sharding=cuda_world)
    assert stats.batches_done == 3
    for i, d in enumerate(got):
        assert d.device.type == "cuda"
        np.testing.assert_array_equal(d.cpu().numpy(), frames[8 * i:8 * i + 8])


def test_dataclass_configs_agree(jx):
    """The worker builds the port's configs from the same fields the JAX
    side uses."""
    from fdoct_tpu_torch.config import PipelineConfig
    for kw in (CFG64, CFG8, SESSION_CFG):
        assert dataclasses.asdict(PipelineConfig(**kw)) == dataclasses.asdict(jx["Config"](**kw))
