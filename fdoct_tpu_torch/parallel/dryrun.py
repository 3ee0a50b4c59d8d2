"""A dry run of the mesh at the flagship shape in a world of its own.

The port's counterpart of ``dryrun_multichip`` in ``__graft_entry__.py``:
``dryrun_multichip(n, device_type)`` spawns ``n`` ranks (gloo on the CPU,
nccl with one card a rank on 'cuda') that join over a ``FileStore``, build a
2-D mesh when ``n`` is even (n/2 × 2, else n × 1) and run, at the flagship
(2048-px spectra, 512-row B-scans, 8 frames or the next multiple of the
'data' axis, 512 depths, float32): ``sharded_bscan_step``, the gathered
``sharded_cscan_volume``, ``sharded_bscan_step_int8``, the session step, and
the per-frame normalization with the median halo on a small config.  Rank 0
holds each to the single-device pipeline on the same frames at the JAX dry
run's atol of 2e-2 dB (the volume's first frame at 1e-3 of its peak) and
returns what it read.  Run as a script it is one rank:

    python -m fdoct_tpu_torch.parallel.dryrun RANK WORLD STORE DEVICE_TYPE REPORT
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

DB_ATOL = 2e-2
VOLUME_RTOL = 1e-3
#: seconds the spawned world may take, a card's kernel build included
TIMEOUT_S = 600.0


def dryrun_multichip(n_devices: int, device_type: str = "cuda") -> dict:
    """Spawn ``n_devices`` ranks on ``device_type`` and run the dry run;
    returns rank 0's report (the mesh, each check's worst error, the kernel
    launches of rank 0).  Raises RuntimeError when a rank fails a check or
    exits non-zero, TimeoutError past :data:`TIMEOUT_S` (the ranks
    killed)."""
    if device_type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}, 'cuda') needs {n_devices} cards, "
                           f"PyTorch sees {torch.cuda.device_count()}")
    root = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [root, *filter(None, [os.environ.get("PYTHONPATH")])])}
    with tempfile.TemporaryDirectory(prefix="fdoct_dryrun_") as tmp:
        report = Path(tmp) / "report.json"
        logs = [open(Path(tmp) / f"rank{r}.log", "w+") for r in range(n_devices)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "fdoct_tpu_torch.parallel.dryrun", str(r), str(n_devices),
             str(Path(tmp) / "store"), device_type, str(report)],
            stdout=logs[r], stderr=subprocess.STDOUT, env={**env, "LOCAL_RANK": str(r)})
            for r in range(n_devices)]
        try:
            failed = _wait_all(procs, time.monotonic() + TIMEOUT_S)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            texts = []
            for log in logs:
                log.seek(0)
                texts.append(log.read())
                log.close()
        if failed is None:
            raise TimeoutError(f"dryrun_multichip({n_devices}, {device_type!r}) did not finish "
                               f"in {TIMEOUT_S} s")
        if failed >= 0:
            raise RuntimeError(f"dryrun rank {failed} exited {procs[failed].returncode}:\n"
                               f"{texts[failed][-3000:]}")
        return json.loads(report.read_text())


def _wait_all(procs, deadline: float) -> int | None:
    """-1 when every process exited 0, the index of the first that failed
    (the others are then killed by the caller), None past ``deadline``."""
    while time.monotonic() < deadline:
        codes = [p.poll() for p in procs]
        for i, code in enumerate(codes):
            if code:
                return i
        if all(code == 0 for code in codes):
            return -1
        time.sleep(0.05)
    return None


def _flagship_cfg(averages: int):
    from fdoct_tpu_torch.config import PipelineConfig
    return PipelineConfig(width=2048, height=512, binvalue=1, averages=averages,
                          numfftpoints=2048, numdisplaypoints=512, lambdamin=816e-9,
                          lambdamax=884e-9, dtype="float32", compat=True)


def _check(report: dict, key: str, err: float, limit: float) -> None:
    report[key] = err
    if not err <= limit:
        raise RuntimeError(f"dryrun {key} {err:.3e} above {limit:.1e}")


def run_rank(rank: int, world: int, store: str, device_type: str, report_path: str) -> None:
    """One rank of the dry run (see the module docstring)."""
    from fdoct_tpu_torch.calibration import Calibration
    from fdoct_tpu_torch.int8direct import (
        Int8DirectPlan, reconstruct_int8_direct, shift_u8_to_s8,
    )
    from fdoct_tpu_torch.ops.kernels import LAUNCHES
    from fdoct_tpu_torch.parallel.distributed import backend_for
    from fdoct_tpu_torch.parallel.mesh import make_mesh, mesh_device
    from fdoct_tpu_torch.parallel.sharded import (
        build_session_bscan_step, gather_rows, shard_frames, sharded_bscan_step,
        sharded_bscan_step_int8, sharded_cscan_volume,
    )
    from fdoct_tpu_torch.pipeline import form_bscan, reconstruct, reconstruct_bscan

    if device_type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group(backend_for(device_type), store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        n_ascan = 2 if world % 2 == 0 else 1
        n_data = world // n_ascan
        mesh = make_mesh(n_data, n_ascan, device_type=device_type)
        dev = mesh_device(mesh)
        cfg = _flagship_cfg(max(8, n_data * -(-8 // n_data)))
        calib = Calibration.create(cfg, dev)
        rng = np.random.default_rng(0)
        host = rng.integers(0, 255, (cfg.averages, cfg.oph, cfg.opw)).astype(np.uint8)
        frames = shard_frames(host, mesh)
        bg = torch.full((cfg.oph, cfg.opw), 128.0, device=dev)
        pi = torch.zeros_like(bg)
        lead = rank == 0
        whole = torch.as_tensor(host).to(dev) if lead else None
        report = {"mesh": [n_data, n_ascan], "ranks": world, "device": str(dev)}

        db = gather_rows(sharded_bscan_step(frames, bg, pi, calib, cfg, mesh)[0], mesh)
        vol = sharded_cscan_volume(frames, bg, pi, calib, cfg, mesh, gather_full=True)
        step = build_session_bscan_step(mesh, calib, cfg, "fused", cfg.averages)
        _, sdb, sdisp = step(frames, bg, pi, torch.zeros_like(bg),
                              torch.tensor(cfg.bscanthreshold, device=dev))
        sdb = gather_rows(sdb, mesh)
        cfg8 = cfg.replace(matmul_precision="int8_direct")
        plan = Int8DirectPlan.create(calib, cfg8, bg, pi, device=dev)
        db8 = gather_rows(sharded_bscan_step_int8(frames, plan, cfg8, mesh)[0], mesh)

        # the edge semantics the flagship defaults never take: each frame's
        # own range (donotnormalize off) and the median's halo across the cuts
        rcfg = cfg.replace(width=256, height=32, numfftpoints=256, numdisplaypoints=64,
                           donotnormalize=False, mediann=3)
        rcalib = Calibration.create(rcfg, dev)
        raw = rng.integers(0, 255, (cfg.averages, 32, 256)).astype(np.float32)
        raw *= (1.0 + 0.2 * np.arange(cfg.averages))[:, None, None]
        rbg = torch.full((32, 256), 128.0, device=dev)
        rdb = gather_rows(sharded_bscan_step(shard_frames(raw, mesh), rbg, torch.zeros_like(rbg),
                                             rcalib, rcfg, mesh)[0], mesh)
        if lead:
            ref = reconstruct_bscan(whole, bg, pi, calib, cfg, averages=cfg.averages)
            _check(report, "bscan_db_err", float((db - ref.bscandb).abs().max()), DB_ATOL)
            one = reconstruct_bscan(whole[:1], bg, pi, calib, cfg, averages=1).bscan - 1e-5
            _check(report, "cscan_err",
                   float((vol[0] - one).abs().max() / one.abs().max()), VOLUME_RTOL)
            _check(report, "session_db_err", float((sdb - ref.bscandb).abs().max()), DB_ATOL)
            if sdisp.dtype != torch.uint8:
                raise RuntimeError(f"session step display is {sdisp.dtype}, not uint8")
            m8 = reconstruct_int8_direct(shift_u8_to_s8(whole), plan)
            ref8 = form_bscan(m8.sum(dim=0), cfg8, cfg.averages).bscandb
            _check(report, "int8_db_err", float((db8 - ref8).abs().max()), DB_ATOL)
            rraw = torch.as_tensor(raw).to(dev)
            rmags = sum(reconstruct(f, rbg, torch.zeros_like(rbg), rcalib, rcfg) for f in rraw)
            rref = form_bscan(rmags, rcfg, cfg.averages).bscandb
            _check(report, "risky_db_err", float((rdb - rref).abs().max()), DB_ATOL)
            if device_type == "cuda":
                torch.cuda.synchronize()
            report["launches"] = {k: v for k, v in LAUNCHES.items() if v}
            Path(report_path).write_text(json.dumps(report))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, store_path, kind, out = sys.argv[1:6]
    run_rank(int(r), int(w), store_path, kind, out)
