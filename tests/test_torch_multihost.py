"""Two processes, one mesh: the port's counterpart of tests/test_multihost.py.

Two gloo ranks (``tests/torch_mesh_worker.py`` over a ``FileStore``, no TCP
port) each own half of every batch: frames on a 2 × 1 mesh, rows on a 1 × 2
mesh, so the frame sum, the display scale, the halo and the C-scan's
all-gathers cross the process boundary.  Rank 0's B-scan and every rank's
streamed C-scan are held to the JAX package's single-process pipeline on
the same inputs: float64 at atol 1e-9, the int8-direct path (both packages
on one plan) at dB atol 1e-4.  ``dryrun_multichip`` (the counterpart of
``__graft_entry__.dryrun_multichip``) runs its own spawned world: 2 gloo
ranks here, a world of one with nccl on the card.  The command line runs
in a two-rank world too, where each rank's own source would give it other
frames (several readers of one camera): rank 0 alone reads, and its outputs
are the single-process command's.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_mesh_worker import CFG8, CFG64, spawn_cli, spawn_world  # noqa: E402

LAYOUTS = ["2x1", "1x2"]
WORLD_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from fdoct_tpu.calibration import Calibration
    from fdoct_tpu.config import PipelineConfig
    from fdoct_tpu.int8direct import Int8DirectPlan, reconstruct_int8_direct, to_s8
    from fdoct_tpu.pipeline import form_bscan, reconstruct
    return dict(jnp=jnp, Calibration=Calibration, Config=PipelineConfig, Plan=Int8DirectPlan,
                int8=reconstruct_int8_direct, to_s8=to_s8, form_bscan=form_bscan,
                reconstruct=reconstruct)


@pytest.fixture(scope="module")
def inputs(jx):
    """tests/multihost_worker.py's seeded frames (rng 123) and flat
    background; the worker's other inputs from the same seeds."""
    rng = np.random.default_rng(123)
    frames = rng.integers(0, 255, (8, 16, 128)).astype(np.uint8)
    bg = np.full((16, 128), 100.0)
    inp = dict(frames=frames, bg=bg, pi=np.zeros_like(bg),
               scaled=frames.astype(np.float64), raw_bin=rng.integers(0, 250, (8, 32, 256))
               .astype(np.uint8), bg_bin=np.full((16, 128), 120.0), yd=np.zeros_like(bg),
               rand=frames, frames16=rng.integers(10, 250, (16, 16, 64)).astype(np.uint8))
    cfg8 = jx["Config"](**CFG8)
    plan = jx["Plan"].create(jx["Calibration"].create(cfg8), cfg8, bg, np.zeros_like(bg))
    plan2 = jx["Plan"].create(jx["Calibration"].create(cfg8), cfg8, bg, np.zeros_like(bg),
                              rank=2)
    for prefix, p in (("plan/", plan), ("plan2/", plan2)):
        for name in ("oq_re", "oq_im", "s_re", "s_im", "row_gain_inv", "const_re", "const_im",
                     "bg_rank1_resid", "oq2_re", "oq2_im", "s2_re", "s2_im", "row_gain2"):
            if getattr(p, name) is not None:
                inp[prefix + name] = np.asarray(getattr(p, name))
    return inp, plan


@pytest.fixture(scope="module")
def world(inputs, tmp_path_factory):
    try:
        return spawn_world(tmp_path_factory.mktemp("mesh2"), 2, inputs[0], LAYOUTS,
                           WORLD_TIMEOUT_S)
    except TimeoutError as e:
        pytest.fail(str(e))


def whole_bscan(world, layout, case, name):
    """Rank 0's B-scan: whole on a 2 × 1 mesh, its half joined with rank 1's
    on a 1 × 2 mesh."""
    parts = [world[r][f"{layout}/{case}/{name}"] for r in range(2)]
    if layout == "2x1":
        np.testing.assert_array_equal(parts[0], parts[1])
        return parts[0]
    return np.concatenate(parts, axis=-1)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_two_process_bscan_parity(jx, inputs, world, layout):
    inp, _ = inputs
    jnp = jx["jnp"]
    cfg = jx["Config"](**CFG64)
    mags = jx["reconstruct"](jnp.asarray(inp["frames"]), jnp.asarray(inp["bg"]),
                             jnp.asarray(inp["pi"]), jx["Calibration"].create(cfg), cfg,
                             method="fused")
    want = np.asarray(jx["form_bscan"](mags.sum(0), cfg, averages=8).bscandb)
    np.testing.assert_allclose(whole_bscan(world, layout, "bscan", "db"), want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_two_process_int8_parity(jx, inputs, world, layout):
    """The plan's per-row tables split across the two processes."""
    inp, plan = inputs
    cfg8 = jx["Config"](**CFG8)
    m8 = jx["int8"](jx["jnp"].asarray(jx["to_s8"](inp["frames"])), plan)
    want = np.asarray(jx["form_bscan"](m8.sum(0), cfg8, averages=8).bscandb)
    np.testing.assert_allclose(whole_bscan(world, layout, "bscan_int8", "db"), want, rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_two_process_streaming_cscan(jx, inputs, world, layout):
    """Each process streams its block of the volume into the sharded C-scan;
    the all-gathers assemble the whole volume on both."""
    inp, _ = inputs
    jnp = jx["jnp"]
    cfg = jx["Config"](**CFG64)
    mags = jx["reconstruct"](jnp.asarray(inp["frames"]), jnp.asarray(inp["bg"]),
                             jnp.asarray(inp["pi"]), jx["Calibration"].create(cfg), cfg,
                             method="fused")
    want = np.swapaxes(np.asarray(mags), 1, 2)
    for r in range(2):
        np.testing.assert_allclose(world[r][f"{layout}/stream_cscan/vol"], want, rtol=0,
                                   atol=1e-9)


#: the command lines of the two-rank world: ``live`` on both layouts and
#: ``cscan`` without ``--mesh`` (a mesh over the world, 1 × 2, as the JAX
#: CLI's default)
CLI_RUNS = {"live_2x1": ["live", "--mesh", "2x1"], "live_1x2": ["live", "--mesh", "1x2"],
            "cscan": ["cscan"]}
CLI_CFG = dict(width=256, height=40, binvalue=1, averages=8, numfftpoints=512,
               numdisplaypoints=128, lambdamin=816e-9, lambdamax=884e-9, dirdescr="cli",
               dtype="float64")


def cli_argv(run: str, cfg: str, out: Path, who: str) -> list[str]:
    argv = CLI_RUNS[run] + ["--config", cfg, "--outdir", str(out / who), "--device", "cpu"]
    if run == "cscan":
        return argv + ["--frames", "8"]
    # two groups, each one sharded step; the viewer's B-scan is the last's
    return argv + ["--frames", "16", "--batch", "8", "--viewer", str(out / f"viewer_{who}")]


@pytest.fixture(scope="module")
def cli_world(tmp_path_factory):
    """The output directory of each run, with the two ranks' outputs and
    the single-process command's (no ``--mesh``, one process), and each
    rank's report (:func:`torch_mesh_worker.run_cli`)."""
    from fdoct_tpu_torch.cli import main
    from fdoct_tpu_torch.config import PipelineConfig

    tmp = tmp_path_factory.mktemp("cli2")
    cfg = tmp / "c.json"
    cfg.write_text(PipelineConfig(**CLI_CFG).to_json())
    try:
        reports = spawn_cli(tmp, 2, [cli_argv(run, str(cfg), tmp / run, "rank{rank}")
                                     for run in CLI_RUNS], WORLD_TIMEOUT_S)
    except TimeoutError as e:
        pytest.fail(str(e))
    for run in CLI_RUNS:
        argv = cli_argv(run, str(cfg), tmp / run, "single")
        with pytest.MonkeyPatch.context() as mp:       # no key on stdin
            mp.setattr("select.select", lambda *a, **k: ([], [], []))
            assert main([a for a in argv if a not in ("--mesh", "2x1", "1x2")]) == 0
    return tmp, {run: [r[i] for r in reports] for i, run in enumerate(CLI_RUNS)}


@pytest.mark.parametrize("run", list(CLI_RUNS))
def test_two_process_cli_reads_rank0_frames_and_writes_once(cli_world, run):
    """Rank 1's own source lies elsewhere, yet the ranks' result is the
    single-process command's: the live display within 1 uint8 level (each
    group on the mesh: frames or rows all-gathered), the C-scan at relative
    1e-9 of its largest value (float64).  Rank 0 alone opens the source and
    writes; the C-scan without ``--mesh`` gathers over the world."""
    tmp, report = cli_world
    out = tmp / run
    assert [r["sources"] for r in report[run]] == [1, 0]
    assert not (out / "rank1").exists() and not (out / "viewer_rank1").exists()
    (got,) = (out / "rank0").iterdir()
    (want,) = (out / "single").iterdir()
    assert {p.name for p in got.iterdir()} == {p.name for p in want.iterdir()}
    if run == "cscan":
        assert all(r["all_gather"] > 0 for r in report[run])
        with np.load(got / "BscanFFT.npz") as g, np.load(want / "BscanFFT.npz") as w:
            for name in ("cscan", "surface"):
                np.testing.assert_allclose(g[name], w[name], rtol=0,
                                           atol=1e-9 * np.abs(w[name]).max())
    else:
        from fdoct_tpu_torch.utils.imageio import read_png

        g, w = (read_png(out / f"viewer_{who}" / "bscan.png").astype(int)
                for who in ("rank0", "single"))
        assert g.shape == w.shape and np.abs(g - w).max() <= 1


def test_dryrun_multichip_on_two_gloo_ranks():
    from fdoct_tpu_torch.parallel.dryrun import dryrun_multichip

    report = dryrun_multichip(2, "cpu")
    assert report["mesh"] == [1, 2] and report["ranks"] == 2
    for key in ("bscan_db_err", "session_db_err", "int8_db_err", "risky_db_err"):
        assert report[key] <= 2e-2, (key, report)
    assert report["cscan_err"] <= 1e-3


@pytest.mark.cuda
def test_dryrun_multichip_on_one_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from fdoct_tpu_torch.parallel.dryrun import dryrun_multichip

    report = dryrun_multichip(1, "cuda")
    assert report["mesh"] == [1, 1] and report["bscan_db_err"] <= 2e-2
