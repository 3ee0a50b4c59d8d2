"""C-scan volumes: per-frame B-scans of a (F, H, W) frame stack.

The port of ``sharded_cscan_volume`` and ``sharded_cscan_volume_int8`` of
``fdoct_tpu/parallel/sharded.py`` (lines 445-495 and 292-324).  On one
device they compute what the JAX functions compute on a 1 × 1 mesh, every
frame in one batched product on the frames' device: preprocess,
``apodize_ratio`` and ``ascan_mags`` (the f32 path), or the bias shift and
``reconstruct_int8_direct`` (the int8-direct path), then each frame's
(H, ndisp) magnitudes transposed into a (F, ndisp, H) volume.  No kernel of
the port's lies on this path: in the JAX package it is plain XLA products,
here ``torch.matmul`` and ``ops.kernels.int8_matmul``.

The frames are not split into chunks: at the flagship (512 × 2048 u8
frames, 512 depths, float32) F = 512 holds a 2 GiB float32 ratio stack and
1 GiB of products at once, well inside one H100 (``chip_smoke.py`` phase 14
prints the peak of device memory).
"""

from __future__ import annotations

import torch

from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.int8direct import reconstruct_int8_direct, shift_u8_to_s8
from fdoct_tpu_torch.pipeline import apodize_ratio, ascan_mags, preprocess

_MESH = ("a device mesh is not ported to fdoct_tpu_torch yet (ROADMAP Queue 1 item 12); "
         "pass mesh=None")


def sharded_cscan_volume(frames: torch.Tensor, background: torch.Tensor,
                         pi_frame: torch.Tensor, calib: Calibration, cfg, mesh=None,
                         method: str = "fused", gather_full: bool = False) -> torch.Tensor:
    """Volumetric C-scan: per-frame B-scans for a (F, H, W) volume, as a
    (F, ndisp, oph) tensor on the frames' device.

    Each frame is normalized by its own range, as in the session.
    ``gather_full`` (replicate the volume over the mesh's 'data' axis) has
    nothing to gather on one device."""
    if mesh is not None:
        raise NotImplementedError(_MESH)
    yr = apodize_ratio(preprocess(frames, cfg), background, pi_frame, cfg)
    mags = ascan_mags(yr, calib, method, cfg.matmul_precision)       # (F, oph, ndisp)
    return mags.transpose(-1, -2).contiguous()


def sharded_cscan_volume_int8(frames: torch.Tensor, plan, cfg, mesh=None,
                              gather_full: bool = False) -> torch.Tensor:
    """Volumetric C-scan on the int8-direct display path: per-frame raw
    magnitudes like :func:`sharded_cscan_volume`, each frame through the
    folded s8 operator (two s8 products).  ``cfg`` is accepted for interface
    symmetry (the plan already encodes the geometry)."""
    del cfg, gather_full
    if mesh is not None:
        raise NotImplementedError(_MESH)
    mags = reconstruct_int8_direct(shift_u8_to_s8(frames.contiguous()), plan)
    return mags.transpose(-1, -2).contiguous()
