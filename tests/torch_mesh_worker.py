"""One rank of the gloo world that tests/test_torch_parallel.py and
tests/test_torch_multihost.py spawn.

Usage: ``python tests/torch_mesh_worker.py RANK WORLD STORE INPUTS OUTDIR
[--graphs] [LAYOUT ...]``, each LAYOUT ``DxA`` (default 4x1 2x2 1x4).  Joins
the world over a ``FileStore`` at STORE, reads the inputs the test wrote
(frames, calibration frames, int8 plans as the JAX package folds them), runs
every case of the port's mesh functions on each layout (with ``--graphs``,
the session's batch steps instead, :func:`run_graph_layout`) and writes
this rank's local blocks to ``OUTDIR/rank{RANK}.npz`` under
``{layout}/{case}/{name}``.  The test process holds them to the JAX
functions on a JAX mesh of the same layout.  ``... RANK WORLD STORE --cli
RUNS`` runs the command lines of the json list RUNS in the world instead
(:func:`run_cli`).  Imports torch and the port only.
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from fdoct_tpu_torch.calibration import Calibration  # noqa: E402
from fdoct_tpu_torch.config import PipelineConfig  # noqa: E402
from fdoct_tpu_torch.graphs import NoHostSync  # noqa: E402
from fdoct_tpu_torch.int8direct import Int8DirectPlan  # noqa: E402
from fdoct_tpu_torch.parallel import (  # noqa: E402
    build_session_bscan_step, build_session_bscan_step_int8, gather_rows, make_mesh, shard_frames,
    sharded_bscan_step, sharded_bscan_step_int8, sharded_cscan_volume, sharded_cscan_volume_int8,
)
from fdoct_tpu_torch.parallel.mesh import COLLECTIVE_BYTES, reset_collective_bytes  # noqa: E402
from fdoct_tpu_torch.parallel.sharded import (  # noqa: E402
    batch_block, gather_frames, local_block, session_mesh_pipeline, session_mesh_pipeline_int8,
)
from fdoct_tpu_torch.session import Session  # noqa: E402
from fdoct_tpu_torch.streaming import run_streaming  # noqa: E402

#: the JAX tests' configs (tests/test_parallel.py, tests/test_streaming.py)
CFG64 = dict(width=128, height=16, binvalue=1, averages=8, numfftpoints=256,
             numdisplaypoints=64, dtype="float64", compat=True)
CFG8 = dict(CFG64, dtype="float32", matmul_precision="int8_direct")
SESSION_CFG = dict(width=64, height=16, averages=8, numfftpoints=128, numdisplaypoints=40,
                   dtype="float32", donotnormalize=True)
MEDIAN_KS = (3, 5, 7)
#: the session's batch steps on the mesh (tests/test_torch_mesh_graphs.py):
#: 3 groups of CFG64's frames in float32, each case's changes to the config
#: and to the step's arguments
GRAPH_GROUPS = 3
GRAPH_CASES = {
    "default": {},
    "highest": {"matmul_precision": "highest"},
    "dark": {"dark": True},
    "normalise": {"donotnormalize": False, "thresh": -np.inf},   # as the 'sim' session
    "median5": {"mediann": 5},
    "keep_frames": {"keep_frames": True},
    "int8": {"matmul_precision": "int8_direct"},
    "int8_keep_frames": {"matmul_precision": "int8_direct", "keep_frames": True},
}


def plan_from(inp: dict, prefix: str) -> Int8DirectPlan:
    return Int8DirectPlan.from_arrays(
        {k[len(prefix):]: v for k, v in inp.items() if k.startswith(prefix)}, "cpu")


def run_layout(mesh, layout: str, inp: dict, out: dict) -> None:
    def put(case: str, **arrays) -> None:
        for name, a in arrays.items():
            out[f"{layout}/{case}/{name}"] = a.numpy() if torch.is_tensor(a) else np.asarray(a)

    t = torch.as_tensor
    frames, bg, pi = inp["frames"], t(inp["bg"]), t(inp["pi"])
    cfg = PipelineConfig(**CFG64)
    calib = Calibration.create(cfg, "cpu")
    fr = shard_frames(frames, mesh)

    reset_collective_bytes()
    db, disp = sharded_bscan_step(fr, bg, pi, calib, cfg, mesh)
    put("bscan", db=db, disp=disp, bytes=COLLECTIVE_BYTES["all_reduce"])

    cfg32 = cfg.replace(dtype="float32")
    db, disp = sharded_bscan_step(fr, bg.float(), pi.float(), Calibration.create(cfg32, "cpu"),
                                  cfg32, mesh)
    put("bscan_f32", db=db, disp=disp)

    cfgc = cfg.replace(clampupper=True, clampupperdb=50.0)
    put("clamp", disp=sharded_bscan_step(fr, bg, pi, calib, cfgc, mesh)[1])

    ncfg = cfg.replace(donotnormalize=False)
    put("normalize", db=sharded_bscan_step(shard_frames(inp["scaled"], mesh), bg, pi, calib, ncfg,
                                           mesh)[0])
    for k in MEDIAN_KS:
        reset_collective_bytes()
        db = sharded_bscan_step(fr, bg, pi, calib, cfg.replace(mediann=k), mesh)[0]
        put(f"median{k}", db=db, sent=COLLECTIVE_BYTES["send"],
            all_reduce=COLLECTIVE_BYTES["all_reduce"])
    try:
        sharded_bscan_step(fr, bg, pi, calib, cfg.replace(mediann=11), mesh)
        put("median_thin", error="")
    except ValueError as e:
        put("median_thin", error=str(e))
    put("median_norm", db=sharded_bscan_step(fr, bg, pi, calib,
                                             cfg.replace(mediann=3, donotnormalize=False),
                                             mesh)[0])
    bcfg = cfg.replace(width=256, height=32, binvalue=2, mediann=3)
    put("median_bin", db=sharded_bscan_step(shard_frames(inp["raw_bin"], mesh), t(inp["bg_bin"]),
                                            torch.zeros(16, 128, dtype=torch.float64),
                                            Calibration.create(bcfg, "cpu"), bcfg, mesh)[0])

    for full in (False, True):
        reset_collective_bytes()
        vol = sharded_cscan_volume(fr, bg, pi, calib, cfg, mesh, gather_full=full)
        put(f"cscan_{full}", vol=vol, gathered=COLLECTIVE_BYTES["all_gather"])

    cfg8 = PipelineConfig(**CFG8)
    plan = plan_from(inp, "plan/")
    for full in (False, True):
        put(f"cscan_int8_{full}", vol=sharded_cscan_volume_int8(fr, plan, cfg8, mesh,
                                                               gather_full=full))
    db, disp = sharded_bscan_step_int8(fr, plan, cfg8, mesh)
    put("bscan_int8", db=db, disp=disp)
    thresh32 = torch.tensor(cfg8.bscanthreshold)
    step2 = build_session_bscan_step_int8(mesh, plan_from(inp, "plan2/"), cfg8, 8)
    put("rank2", db=step2(shard_frames(inp["rand"], mesh), thresh32)[1])

    reset_collective_bytes()
    step = build_session_bscan_step(mesh, calib, cfg, "fused", 8, dark=True, keep_frames=True,
                                    keep_binned=True)
    thresh = torch.tensor(cfg.bscanthreshold, dtype=torch.float64)
    bscan, db, disp, mags, binned = step(fr, bg, pi, t(inp["yd"]), thresh)
    put("session_step", bscan=bscan, db=db, disp=disp, mags=mags, binned=binned,
        all_reduce=COLLECTIVE_BYTES["all_reduce"], all_gather=COLLECTIVE_BYTES["all_gather"])
    step8 = build_session_bscan_step_int8(mesh, plan, cfg8, 8, keep_frames=True)
    put("session_step_int8", **dict(zip(("bscan", "db", "disp", "mags"), step8(fr, thresh32))))

    frames16 = inp["frames16"]
    for precision in ("default", "int8_direct"):
        scfg = PipelineConfig(**SESSION_CFG, matmul_precision=precision, saveframes=True)
        s = Session(scfg, "cpu", mesh=mesh)
        rs = s.process_group(frames16)
        put(f"session_{precision}", bscan=torch.stack([r.bscan for r in rs]),
            db=torch.stack([r.bscandb for r in rs]), disp=np.stack([r.bscandisp for r in rs]),
            ring=torch.stack(s._rings[1]["bscan"]), status="\n".join(s.status))
    s = Session(PipelineConfig(**dict(SESSION_CFG, averages=6)), "cpu", mesh=mesh)
    rs = s.process_group(frames16[:12]) + s.process_group(frames16[:12])
    put("fallback", db=torch.stack([r.bscandb for r in rs]), status="\n".join(s.status))

    scfg = PipelineConfig(**SESSION_CFG)
    s = Session(scfg, "cpu", mesh=mesh)
    sstep = build_session_bscan_step(mesh, s.calib, scfg, "fused", 8)
    seen = []

    def stream_step(block):
        seen.append(tuple(block.shape))
        return sstep(block, s.data_yb, s.data_yp, s.data_yd, torch.tensor(scfg.bscanthreshold))[1]

    outs, stats = run_streaming(iter(list(frames16)), stream_step, batch=8, n_batches=2,
                                device="cpu", sharding=mesh)
    put("stream", db=torch.stack(outs), seen=np.array(seen), frames_in=stats.frames_in)

    # each rank streams its block of the volume, the C-scan gathers it whole
    vols, _ = run_streaming(iter(list(frames)), lambda block: sharded_cscan_volume(
        block, bg, pi, calib, cfg, mesh, gather_full=True), batch=8, n_batches=1, device="cpu",
        sharding=mesh)
    put("stream_cscan", vol=vols[0])


def eager_batch(run, frames, groups: int, avg: int, mesh, keep_frames: bool):
    """A batch as ``Session._process_group_mesh`` ran it before its graph:
    each group's ``local_block`` through the one-group step ``run``, then one
    all-gather of the displays (and each group's frames' magnitudes)."""
    blocks, mags = [], []
    for g in range(groups):
        bscan, db, disp, *extra = run(torch.as_tensor(local_block(frames[g * avg:(g + 1) * avg],
                                                                  mesh)))
        blocks.append(torch.stack([bscan, db, disp.to(bscan.dtype)]))
        if keep_frames:
            mags.append(gather_frames(extra[0], mesh))
    whole = gather_rows(torch.stack(blocks), mesh)
    return (whole[:, 0], whole[:, 1], whole[:, 2].to(torch.uint8),
            torch.cat(mags) if keep_frames else None)


def run_graph_layout(mesh, layout: str, inp: dict, out: dict) -> None:
    """Each case of :data:`GRAPH_CASES`: the batch step
    (``session_mesh_pipeline[_int8]``) on the rank's blocks of the
    ``GRAPH_GROUPS`` groups of ``frames24``, under ``NoHostSync``, and the
    per-group eager loop (:func:`eager_batch`), each with the collective
    bytes it moved."""
    t = torch.as_tensor
    frames = inp["frames24"]
    yb, yp, yd = (t(inp[k]).float() for k in ("bg", "pi24", "yd"))
    avg = CFG64["averages"]
    for case, change in GRAPH_CASES.items():
        change = dict(change)
        thresh = torch.tensor(change.pop("thresh", -30.0))
        dark, keep = change.pop("dark", False), change.pop("keep_frames", False)
        cfg = PipelineConfig(**{**CFG64, "dtype": "float32", **change})
        block = t(batch_block(frames, mesh, GRAPH_GROUPS))
        block = block.reshape(-1, *block.shape[2:])            # (groups·b_loc, h_loc, W)
        reset_collective_bytes()
        if cfg.matmul_precision == "int8_direct":
            plan = plan_from(inp, "plan24/")
            with NoHostSync():
                outs, mags = session_mesh_pipeline_int8(block, plan, thresh, cfg, mesh,
                                                        GRAPH_GROUPS, avg, keep_frames=keep)
            step = build_session_bscan_step_int8(mesh, plan, cfg, avg, keep_frames=keep)
            args = (thresh,)
        else:
            calib = Calibration.create(cfg, "cpu")
            with NoHostSync():
                outs, mags = session_mesh_pipeline(block, yb, yp, yd, thresh, calib, cfg, mesh,
                                                   GRAPH_GROUPS, avg, "fused", dark,
                                                   keep_frames=keep)
            step = build_session_bscan_step(mesh, calib, cfg, "fused", avg, dark=dark,
                                            keep_frames=keep)
            args = (yb, yp, yd, thresh)
        got = dict(bscan=outs.bscan, db=outs.bscandb, disp=outs.bscandisp,
                   **({"mags": mags} if keep else {}),
                   **{f"bytes_{k}": v for k, v in COLLECTIVE_BYTES.items()})
        reset_collective_bytes()
        want = eager_batch(lambda fr: step(fr, *args), frames, GRAPH_GROUPS, avg, mesh, keep)
        got.update({f"eager_{k}": v for k, v in zip(("bscan", "db", "disp", "mags"), want)
                    if v is not None})
        got.update({f"eager_bytes_{k}": v for k, v in COLLECTIVE_BYTES.items()})
        for name, a in got.items():
            out[f"{layout}/{case}/{name}"] = a.numpy() if torch.is_tensor(a) else np.asarray(a)


def run_cli(rank: int, runs: list[list[str]]) -> list[dict]:
    """Each argv of ``runs`` through the port's command line in this world,
    ``{rank}`` in it replaced by the rank.  ``cli._make_source`` is what
    several readers of one camera would see: rank 0 gets the command's own
    source, every other rank one whose scatterers lie elsewhere, so a rank
    that read its own frames would change the result.  Returns, for each
    run, the sources this rank made and the bytes it all-gathered."""
    from fdoct_tpu_torch import cli

    made = []
    make_source = cli._make_source

    def per_rank_source(args, cfg):
        made.append(1)
        src = make_source(args, cfg)
        return dataclasses.replace(src, depths_um=(60.0, 210.0)) if rank else src

    cli._make_source = per_rank_source
    report = []
    for argv in runs:
        made.clear()
        reset_collective_bytes()
        if cli.main([a.replace("{rank}", str(rank)) for a in argv]):
            raise RuntimeError(f"rank {rank}: {argv} failed")
        report.append({"sources": len(made), "all_gather": COLLECTIVE_BYTES["all_gather"]})
    return report


def spawn_world(tmp: Path, world: int, inputs: dict, layouts, timeout_s: float) -> list[dict]:
    """Run ``world`` ranks of this script on ``inputs`` and return each
    rank's outputs.  Raises TimeoutError when the world has not finished
    within ``timeout_s`` (its processes killed), RuntimeError when a rank
    fails."""
    np.savez(tmp / "inputs.npz", **inputs)
    _run_ranks(tmp, world, [str(tmp / "inputs.npz"), str(tmp), *layouts], timeout_s)
    outs = []
    for rank in range(world):
        with np.load(tmp / f"rank{rank}.npz") as z:
            outs.append(dict(z))
    return outs


def spawn_cli(tmp: Path, world: int, runs: list[list[str]],
              timeout_s: float) -> list[list[dict]]:
    """Run ``world`` ranks of this script, each running the command lines
    ``runs`` (:func:`run_cli`), and return each rank's report; errors as
    :func:`spawn_world`'s."""
    import json

    (tmp / "runs.json").write_text(json.dumps(runs))
    _run_ranks(tmp, world, ["--cli", str(tmp / "runs.json")], timeout_s)
    return [json.loads((tmp / f"cli_rank{rank}.json").read_text()) for rank in range(world)]


def _run_ranks(tmp: Path, world: int, tail: list[str], timeout_s: float) -> None:
    import os
    import subprocess
    import time

    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs, logs = [], []
    for rank in range(world):
        logs.append(open(tmp / f"rank{rank}.log", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, str(rank), str(world), str(tmp / "store"), *tail],
            stdin=subprocess.DEVNULL, stdout=logs[-1], stderr=subprocess.STDOUT, env=env))
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise TimeoutError(f"the {world}-rank gloo world did not finish in {timeout_s} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    for rank, p in enumerate(procs):
        if p.returncode:
            tail = (tmp / f"rank{rank}.log").read_text()[-3000:]
            raise RuntimeError(f"rank {rank} exited {p.returncode}:\n{tail}")


def main() -> int:
    rank, world, store = sys.argv[1:4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, int(world)), rank=int(rank),
                            world_size=int(world))
    if sys.argv[4] == "--cli":
        import json

        runs = Path(sys.argv[5])
        report = run_cli(int(rank), json.loads(runs.read_text()))
        (runs.parent / f"cli_rank{rank}.json").write_text(json.dumps(report))
    else:
        inputs, outdir = sys.argv[4:6]
        with np.load(inputs) as z:
            inp = dict(z)
        out: dict = {}
        cases, layouts = run_layout, sys.argv[6:]
        if layouts[:1] == ["--graphs"]:
            cases, layouts = run_graph_layout, layouts[1:]
        for layout in layouts or ["4x1", "2x2", "1x4"]:
            d, a = (int(v) for v in layout.split("x"))
            cases(make_mesh(d, a, device_type="cpu"), layout, inp, out)
        np.savez(Path(outdir) / f"rank{rank}.npz", **out)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
