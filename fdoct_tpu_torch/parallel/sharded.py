"""Sharded reconstruction steps over a ('data', 'ascan') device mesh.

The port of ``fdoct_tpu/parallel/sharded.py``, one process per device
(:mod:`fdoct_tpu_torch.parallel.mesh`).  The layouts are the JAX package's:

- raw frame batches (B, H, W): frames over 'data', rows over 'ascan'; a rank
  holds its (b_loc, h_loc, W) block (:func:`shard_frames`);
- calibration frames (background, π, dark) and the calibration: whole on
  every rank; a step takes the rows of its block;
- B-scan outputs (ndisp, H): the rank's (ndisp, h_loc) columns, the same on
  every rank of a 'data' group after the frame sum (JAX's ``P(None,
  'ascan')``);
- C-scan volumes (F, ndisp, H): the rank's (f_loc, ndisp, H) frames, every
  frame with ``gather_full``.

JAX holds global arrays across the mesh; a rank here holds only its block, so
the steps return blocks and :func:`gather_rows` assembles a whole B-scan.

Each rank's block is exactly what the single-device group kernels take, so
the float32 steps run the port's group step on it: kernel 1
(``fused_recon_raw_accumulate``) on u8 frames with an identity preprocess,
kernel 2 (``fused_recon_accumulate``) on the ratio after a median (with its
halo) or a normalizing preprocess (:func:`fdoct_tpu_torch.pipeline.
reconstruct_group`, ``ratio_group_sum``).  The JAX mesh bodies compute the
magnitudes with ``ascan_mags``, an XLA product; the magnitudes of each row
are independent, so the sums are the same.  The int8-direct steps follow
JAX's (``_bscan_step_int8_fn`` there): two s8 products (``reconstruct_int8_direct``
on the rank's rows of the plan) and the shared tail; the fused int8 display
kernel ends in its display epilogue before any 'data' sum, so it has no
place here.

The collectives, each counted in ``mesh.COLLECTIVE_BYTES``:

- ``psum`` over 'data' → one all-reduce SUM of the (h_loc, ndisp) sum;
- ``pmin``/``pmax`` over 'ascan' → one all-reduce MAX of (−min, max), for the
  display scale and for each frame's range under ``donotnormalize`` off;
- the median halo's ``ppermute`` → ``batch_isend_irecv`` of k//2 rows with
  each 'ascan' neighbour;
- ``all_gather`` → ``all_gather_into_tensor`` (C-scan assembly,
  :func:`gather_rows`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from fdoct_tpu_torch.angio import AngioConfig, ratio_ssada
from fdoct_tpu_torch.calibration import Calibration
from fdoct_tpu_torch.int8direct import reconstruct_int8_direct, shift_u8_to_s8
from fdoct_tpu_torch.ops import (
    clamp_pixel, mask_dc_rows, median_blur, minmax_pair, threshold_floor, to_db, to_uint8,
)
from fdoct_tpu_torch.parallel.mesh import (
    COLLECTIVE_BYTES, all_gather, all_reduce, all_reduce_minmax, axis_index, axis_size,
    mesh_device, nbytes,
)
from fdoct_tpu_torch.pipeline import (
    BscanOutputs, apodize_ratio, ascan_mags, preprocess, ratio_group_sum, raw_kernel_applies,
    reconstruct_group,
)
from fdoct_tpu_torch.utils.profiling import count, span

#: the row-indexed leaves of an Int8DirectPlan: a rank keeps its rows of
#: these, and the operator, the scales and the packed operator whole
#: (``_int8_plan_specs`` of the JAX package)
PLAN_ROW_LEAVES = ("row_gain_inv", "const_re", "const_im", "row_gain2")


def _block(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} {n} not divisible by the mesh axis of {parts}")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def local_block(frames, mesh: DeviceMesh):
    """This rank's (b_loc, h_loc, W) block of a (B, H, W) batch, where it
    lies (a view: numpy, or a tensor on any device)."""
    b = _block(frames.shape[0], axis_size(mesh, "data"), axis_index(mesh, "data"), "frames")
    h = _block(frames.shape[-2], axis_size(mesh, "ascan"), axis_index(mesh, "ascan"), "rows")
    return frames[b, h]


def batch_block(frames, mesh: DeviceMesh, groups: int):
    """This rank's blocks of a (groups·avg, H, W) batch of ``groups``
    averaging groups, where they lie (a strided view), as (groups, b_loc,
    h_loc, W): :func:`local_block` of each group.  A group's frames split
    over 'data' within the group, so rank d holds frames g·avg + d·b_loc …
    g·avg + (d+1)·b_loc of group g; that is not ``local_block`` of the whole
    batch."""
    avg = frames.shape[0] // groups
    b = _block(avg, axis_size(mesh, "data"), axis_index(mesh, "data"), "frames")
    h = _block(frames.shape[-2], axis_size(mesh, "ascan"), axis_index(mesh, "ascan"), "rows")
    return frames.reshape(groups, avg, *frames.shape[1:])[:, b, h]


def shard_frames(frames, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's block of a host or device (B, H, W) batch on the rank's
    device: frames over 'data', rows over 'ascan'.  Only the block is
    copied."""
    block = local_block(frames, mesh)
    if not torch.is_tensor(block):
        block = torch.from_numpy(np.ascontiguousarray(block))
    return block.contiguous().to(mesh_device(mesh))


def _rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's rows (axis -2) of a whole (rows, ...) table."""
    return x[..., _block(x.shape[-2], axis_size(mesh, "ascan"), axis_index(mesh, "ascan"),
                         "rows"), :]


def gather_rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """The whole (..., H) B-scan from each rank's (..., h_loc) columns: an
    all-gather over 'ascan'.  JAX's global arrays give this for free; here
    each rank holds only its block."""
    g = all_gather(x, mesh, "ascan")                         # (n_ascan, ..., h_loc)
    return g.movedim(0, -2).reshape(*x.shape[:-1], -1)


def gather_frames(mags: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every frame's whole (B, H, ndisp) magnitudes on every rank from each
    rank's (b_loc, h_loc, ndisp) block: all-gathers over 'ascan', then
    'data' (what reading JAX's global ``mags`` array to the host gives)."""
    g = all_gather(mags, mesh, "ascan").movedim(0, 1)     # (b_loc, n_ascan, h_loc, nd)
    g = g.reshape(mags.shape[0], -1, mags.shape[-1])
    return all_gather(g, mesh, "data").reshape(-1, *g.shape[1:])


def _with_halo(fr: torch.Tensor, h: int, mesh: DeviceMesh) -> torch.Tensor:
    """The block extended by ``h`` rows above and below: its 'ascan'
    neighbours' boundary rows, or its own edge row replicated at the outer
    edges of the frame (what BORDER_REPLICATE pads with)."""
    idx, n = axis_index(mesh, "ascan"), axis_size(mesh, "ascan")
    group = mesh.get_group("ascan")
    shape = (*fr.shape[:-2], h, fr.shape[-1])
    top = fr[..., :1, :].expand(shape).contiguous()
    bot = fr[..., -1:, :].expand(shape).contiguous()
    ops = []
    for nb, send, recv in ((idx - 1, fr[..., :h, :], top), (idx + 1, fr[..., -h:, :], bot)):
        if 0 <= nb < n:
            peer = dist.get_global_rank(group, nb)
            ops += [dist.P2POp(dist.isend, send.contiguous(), peer),
                    dist.P2POp(dist.irecv, recv, peer)]
            COLLECTIVE_BYTES["send"] += nbytes(send)
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.cat([top, fr, bot], dim=-2)


def _preprocess_sharded(fr: torch.Tensor, cfg, mesh: DeviceMesh) -> torch.Tensor:
    """``pipeline.preprocess`` of a rank's block, the median filter's rows
    across the 'ascan' cuts brought by a halo exchange: each rank sends its
    k//2 boundary rows to its neighbours, filters the extended block and
    keeps the interior, the single-device filter's values.  Needs
    k//2 local raw rows (``Session._mesh_ok`` gates on it)."""
    k, n_ascan = cfg.mediann, axis_size(mesh, "ascan")
    if k > 1 and n_ascan > 1:
        h = k // 2
        if fr.shape[-2] < h:
            raise ValueError(
                f"median halo needs >= {h} local rows per 'ascan' shard, "
                f"got {fr.shape[-2]} (mediann={k}, {n_ascan} shards) — use "
                f"fewer 'ascan' shards for this frame height")
        # the kept interior rows never touch median_blur's own pad rows
        fr = median_blur(_with_halo(fr, h, mesh), k)[..., h:-h, :]
        cfg = cfg.replace(mediann=0)
    return preprocess(fr, cfg)


def display_tail(local_sum: torch.Tensor, batch: int, cfg, mesh: DeviceMesh,
                 thresh=None, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor,
                                                           torch.Tensor]:
    """The frame sum and display tail of every mesh step, one implementation
    for the f32 and int8 steps and the session's (JAX's ``_display_tail``;
    the semantics of ``pipeline.form_bscan``, BscanFFT.cpp:1211-1255).

    ``local_sum`` (h_loc, ndisp), the rank's frames' sum, is summed over
    'data' in place; the DC rows mask locally (depth is not sharded); the
    display scale's min and max complete over 'ascan'.  ``thresh`` (a number
    or a 0-d tensor) defaults to the config's ``bscanthreshold``.  Returns
    the rank's (ndisp, h_loc) (linear bscan, dB, display in [0, 1])."""
    group = all_reduce(local_sum, dist.ReduceOp.SUM, mesh, "data")
    bscan = group.T / batch + eps
    db = mask_dc_rows(to_db(bscan, eps=0.0, compat=cfg.compat))
    disp = threshold_floor(db, cfg.bscanthreshold if thresh is None else thresh)
    if cfg.clampupper:
        # the absolute-scale pixel (5, 5) of the whole B-scan ('q',
        # BscanFFT.cpp:1248-53) lies on exactly one 'ascan' rank
        col = 5 - axis_index(mesh, "ascan") * disp.shape[1]
        if 0 <= col < disp.shape[1]:
            disp = clamp_pixel(disp, cfg.clampupperdb, 5, col)
    lo, hi = all_reduce_minmax(*minmax_pair(disp), mesh.get_group("ascan"))
    rng = torch.where(hi > lo, hi - lo, 1.0)
    return bscan, db, (disp - lo) / rng


def _local_sum(fr, yb, yp, yd, calib: Calibration, cfg, method: str, mesh: DeviceMesh,
               keep_frames: bool = False, keep_binned: bool = False):
    """The rank's frame sum (h_loc, ndisp) of |ratio @ M|; with
    ``keep_frames`` also each frame's magnitudes (b_loc, h_loc, ndisp), as
    the single-device session's ``saveframes`` ring takes them (one group
    step per frame, B = 1, the sum taken in frame order); with
    ``keep_binned`` the preprocessed block less the dark frame.  ``yb``,
    ``yp`` and ``yd`` (or None) are whole tables."""
    dtype = getattr(torch, cfg.dtype)
    yb, yp = _rows(yb, mesh).to(dtype), _rows(yp, mesh).to(dtype)
    yd = None if yd is None else _rows(yd, mesh).to(dtype)
    raw_route = raw_kernel_applies(fr, cfg)
    y = None
    if keep_binned or not raw_route:
        y = _preprocess_sharded(fr, cfg, mesh)
        if yd is not None:
            y = y - yd
    if raw_route:
        # identity preprocess and normalization: nothing crosses the mesh,
        # the single-device group step (kernel 1, the dark frame in π)
        def frames_sum(sl):
            return reconstruct_group(fr[sl], yb, yp, calib, cfg, method, yd)
    else:
        yr = apodize_ratio(y, yb, yp, cfg, ascan_axis=mesh.get_group("ascan"))

        def frames_sum(sl):
            return ratio_group_sum(yr[sl], calib, cfg, method)
    if not keep_frames:
        return frames_sum(slice(None)), None, y
    mags = [frames_sum(slice(b, b + 1)) for b in range(fr.shape[0])]
    total = mags[0]
    for m in mags[1:]:
        total = total + m
    return total, torch.stack(mags), y


def _check_batch(fr: torch.Tensor, batch: int, mesh: DeviceMesh) -> None:
    if fr.shape[0] * axis_size(mesh, "data") != batch:
        raise ValueError(f"a block of {fr.shape[0]} frames on a 'data' axis of "
                         f"{axis_size(mesh, 'data')} is not a group of {batch}")


def build_bscan_step(mesh: DeviceMesh, calib: Calibration, cfg, method: str, batch: int):
    """The sharded B-scan step as a callable, ``step(frames, background,
    pi_frame) -> (bscan_db, bscan_disp01)`` on the rank's block of a group
    of ``batch`` frames.  The JAX builder caches its jitted body; nothing
    compiles here, so nothing is cached."""
    def step(frames, background, pi_frame):
        _check_batch(frames, batch, mesh)
        total, _, _ = _local_sum(frames, background, pi_frame, None, calib, cfg, method, mesh)
        return display_tail(total, batch, cfg, mesh)[1:]

    return step


def sharded_bscan_step(frames: torch.Tensor, background: torch.Tensor,
                       pi_frame: torch.Tensor, calib: Calibration, cfg,
                       mesh: DeviceMesh, method: str = "fused"):
    """One averaged B-scan from a rank's block (:func:`shard_frames`) of a
    group of frames: the rank's frame sum, all-reduced over 'data', the
    display scale over 'ascan' — one (h_loc × ndisp) sum and 2 scalars a
    group.  Returns the rank's (ndisp, h_loc) columns of (bscan_db,
    bscan_disp01)."""
    return build_bscan_step(mesh, calib, cfg, method,
                            frames.shape[0] * axis_size(mesh, "data"))(frames, background,
                                                                       pi_frame)


# ---------------------------------------------------------------------------
# int8-direct on the mesh: the operator and its scales whole on every rank,
# the per-row tables (1/u gain, π/dark correction) sliced to the rank's rows
# ---------------------------------------------------------------------------


def _plan_rows(plan, mesh: DeviceMesh):
    """The rank's view of an Int8DirectPlan: its rows of
    :data:`PLAN_ROW_LEAVES` (a rank-1 plan has no ``row_gain2``)."""
    rows = {name: _rows(getattr(plan, name), mesh) for name in PLAN_ROW_LEAVES
            if getattr(plan, name) is not None}
    return dataclasses.replace(plan, oph=rows["const_re"].shape[-2], **rows)


def _int8_mags(fr: torch.Tensor, plan, mesh: DeviceMesh) -> torch.Tensor:
    """Each frame's (b_loc, h_loc, ndisp) magnitudes of the rank's u8 block:
    the device bias shift and the s8 products."""
    return reconstruct_int8_direct(shift_u8_to_s8(fr.contiguous()), _plan_rows(plan, mesh))


def build_bscan_step_int8(mesh: DeviceMesh, plan, cfg, batch: int):
    """The sharded int8-direct B-scan step, ``step(frames_u8) -> (bscan_db,
    bscan_disp01)``."""
    def step(frames):
        _check_batch(frames, batch, mesh)
        return display_tail(_int8_mags(frames, plan, mesh).sum(dim=0), batch, cfg, mesh)[1:]

    return step


def sharded_bscan_step_int8(frames: torch.Tensor, plan, cfg, mesh: DeviceMesh):
    """One averaged B-scan from a rank's u8 block on the int8-direct display
    path; layouts as :func:`sharded_bscan_step`."""
    return build_bscan_step_int8(mesh, plan, cfg,
                                 frames.shape[0] * axis_size(mesh, "data"))(frames)


# ---------------------------------------------------------------------------
# Session-facing steps: what Session.process_group runs with a mesh.  They
# differ from the offline steps in two ways, as in the JAX package: the live
# threshold is an argument (a number or a 0-d tensor, so '['/']' change it
# without a rebuild), and they return the (linear, dB, uint8) triple, plus
# each frame's magnitudes and the binned frames on request.  The session
# runs a batch's groups through session_mesh_pipeline[_int8], which it
# captures on CUDA in one graph with the collectives.
# ---------------------------------------------------------------------------


def build_session_bscan_step(mesh: DeviceMesh, calib: Calibration, cfg, method: str,
                             batch: int, dark: bool = False, keep_frames: bool = False,
                             keep_binned: bool = False):
    """The sharded one-group session step: ``step(frames, yb, yp, yd,
    thresh) -> (bscan, bscandb, bscandisp_u8[, mags][, binned])``, each the
    rank's block (the B-scans (ndisp, h_loc); ``mags`` (b_loc, h_loc,
    ndisp), each frame's magnitudes, one group step per frame; ``binned``
    the preprocessed block less the dark frame).  ``yb``, ``yp``, ``yd`` are
    whole tables.  It moves what the offline step moves: one (h_loc ×
    ndisp) sum and 2 scalars a group."""
    def step(frames, yb, yp, yd, thresh):
        _check_batch(frames, batch, mesh)
        total, mags, y = _local_sum(frames, yb, yp, yd if dark else None, calib, cfg, method,
                                    mesh, keep_frames, keep_binned)
        bscan, db, disp01 = display_tail(total, batch, cfg, mesh, thresh)
        out = [bscan, db, to_uint8(disp01)]
        if keep_frames:
            out.append(mags)
        if keep_binned:
            out.append(y)
        return tuple(out)

    return step


def build_session_bscan_step_int8(mesh: DeviceMesh, plan, cfg, batch: int,
                                  keep_frames: bool = False):
    """The int8-direct session step on the mesh: ``step(frames_u8, thresh)
    -> (bscan, bscandb, bscandisp_u8[, mags])``."""
    def step(frames, thresh):
        _check_batch(frames, batch, mesh)
        mags = _int8_mags(frames, plan, mesh)
        bscan, db, disp01 = display_tail(mags.sum(dim=0), batch, cfg, mesh, thresh)
        return (bscan, db, to_uint8(disp01)) + ((mags,) if keep_frames else ())

    return step


def _mesh_batch(run, frames: torch.Tensor, groups: int, mesh: DeviceMesh, keep_frames: bool):
    """``run`` (a session step of one group) on each group's (b_loc, h_loc,
    W) slice of the rank's (groups·b_loc, h_loc, W) ``frames``, then every
    group's (bscan, dB, display) gathered over 'ascan' in one all-gather
    and, with ``keep_frames``, each group's frame magnitudes over both axes."""
    b_loc = frames.shape[0] // groups
    blocks, mags = [], []
    for g in range(groups):
        bscan, db, disp, *extra = run(frames[g * b_loc:(g + 1) * b_loc])
        blocks.append(torch.stack([bscan, db, disp.to(bscan.dtype)]))
        if keep_frames:
            mags.append(gather_frames(extra[0], mesh))
    whole = gather_rows(torch.stack(blocks), mesh)          # (groups, 3, ndisp, oph)
    outs = BscanOutputs(bscan=whole[:, 0], bscandb=whole[:, 1],
                        bscandisp=whole[:, 2].to(torch.uint8))
    return outs, torch.cat(mags) if keep_frames else None


def session_mesh_pipeline(frames: torch.Tensor, yb: torch.Tensor, yp: torch.Tensor,
                          yd: torch.Tensor, thresh: torch.Tensor, calib: Calibration, cfg,
                          mesh: DeviceMesh, groups: int, averages: int, method: str, dark: bool,
                          keep_frames: bool = False):
    """A batch of ``groups`` averaging groups on the mesh, the mesh
    counterpart of ``session.session_group_pipeline`` and of the JAX
    session's one dispatch a group of its jitted ``shard_map`` step
    (``_jitted_session_bscan_step``): :func:`build_session_bscan_step` on
    each group's slice of the rank's (groups·b_loc, h_loc, W) ``frames``
    (:func:`batch_block`), the display floor read from the 0-d tensor
    ``thresh``, then one all-gather of every group's display.  Returns
    (stacked whole-B-scan ``BscanOutputs``, every frame's whole (groups·
    averages, oph, ndisp) magnitudes or None), the same on every rank.  No
    host synchronisation and nothing decided from data, so that a CUDA
    graph can capture it with its collectives."""
    step = build_session_bscan_step(mesh, calib, cfg, method, averages, dark=dark,
                                    keep_frames=keep_frames)
    return _mesh_batch(lambda fr: step(fr, yb, yp, yd, thresh), frames, groups, mesh,
                       keep_frames)


def session_mesh_pipeline_int8(frames: torch.Tensor, plan, thresh: torch.Tensor, cfg,
                               mesh: DeviceMesh, groups: int, averages: int,
                               keep_frames: bool = False):
    """The int8-direct counterpart of :func:`session_mesh_pipeline` (JAX's
    ``_jitted_session_bscan_step_int8``): :func:`build_session_bscan_step_int8`
    on each group's slice.  It ends in :func:`display_tail`, not in the
    fused int8 kernel, so its floor is a device scalar like the f32 step's."""
    step = build_session_bscan_step_int8(mesh, plan, cfg, averages, keep_frames=keep_frames)
    return _mesh_batch(lambda fr: step(fr, thresh), frames, groups, mesh, keep_frames)


# ---------------------------------------------------------------------------
# C-scan volumes
# ---------------------------------------------------------------------------


def _assemble_volume(mags: torch.Tensor, mesh: DeviceMesh, gather_full: bool) -> torch.Tensor:
    """The rank's (f_loc, h_loc, ndisp) magnitudes → whole B-scans, (f_loc,
    ndisp, H): an all-gather over 'ascan'; with ``gather_full`` also over
    'data', every frame on every rank."""
    g = all_gather(mags, mesh, "ascan")                     # (n_ascan, f_loc, h_loc, nd)
    f_loc, nd = mags.shape[0], mags.shape[-1]
    vol = g.permute(1, 3, 0, 2).reshape(f_loc, nd, -1)     # (f_loc, nd, H)
    if gather_full:
        vol = all_gather(vol, mesh, "data").reshape(-1, *vol.shape[1:])
    return vol


def _sharded_ratio(frames: torch.Tensor, background: torch.Tensor, pi_frame: torch.Tensor,
                   cfg, mesh: DeviceMesh) -> torch.Tensor:
    """The rank's apodization ratio rows of its block of a volume, (f_loc,
    h_loc, W): the sharded preprocess, then the ratio to its rows of S(k)
    and π, each frame normalized by its own range over 'ascan'."""
    dtype = getattr(torch, cfg.dtype)
    y = _preprocess_sharded(frames, cfg, mesh)
    return apodize_ratio(y, _rows(background, mesh).to(dtype), _rows(pi_frame, mesh).to(dtype),
                         cfg, ascan_axis=mesh.get_group("ascan"))


def build_cscan_volume(mesh: DeviceMesh, calib: Calibration, cfg, method: str = "fused",
                       gather_full: bool = False):
    """The sharded C-scan volume as a callable, ``vol(frames, background,
    pi_frame)`` on the rank's block of a (F, H, W) volume."""
    def vol(frames, background, pi_frame):
        yr = _sharded_ratio(frames, background, pi_frame, cfg, mesh)
        return _assemble_volume(ascan_mags(yr, calib, method, cfg.matmul_precision), mesh,
                                gather_full)

    return vol


def sharded_cscan_volume(frames: torch.Tensor, background: torch.Tensor,
                         pi_frame: torch.Tensor, calib: Calibration, cfg, mesh=None,
                         method: str = "fused", gather_full: bool = False) -> torch.Tensor:
    """Volumetric C-scan: per-frame B-scans of a (F, H, W) volume.

    With a mesh, ``frames`` is the rank's block (:func:`shard_frames`):
    each rank reconstructs it, an all-gather over 'ascan' assembles whole
    B-scans, and the rank returns its (f_loc, ndisp, oph) frames, or all F
    with ``gather_full``.  With ``mesh=None`` the whole volume on the
    frames' device (what the JAX function computes on a 1 × 1 mesh), every
    frame in one batched product.  Each frame is normalized by its own
    range, as in the session.  The products are ``torch.matmul`` (in the
    JAX package, XLA products): no kernel of the port's lies on this path.

    The frames are not split into chunks: at the flagship (512 × 2048 u8
    frames, 512 depths, float32) F = 512 holds a 2 GiB float32 ratio stack
    and 1 GiB of products at once, well inside one H100 (``chip_smoke.py``
    phases 14 and 16 print the peak of device memory).

    The span ``cscan.volume`` covers the host's enqueue of the volume."""
    with span("cscan.volume"):
        if mesh is not None:
            return build_cscan_volume(mesh, calib, cfg, method, gather_full)(frames, background,
                                                                             pi_frame)
        yr = apodize_ratio(preprocess(frames, cfg), background, pi_frame, cfg)
        mags = ascan_mags(yr, calib, method, cfg.matmul_precision)       # (F, oph, ndisp)
        return mags.transpose(-1, -2).contiguous()


def sharded_cscan_volume_int8(frames: torch.Tensor, plan, cfg, mesh=None,
                              gather_full: bool = False) -> torch.Tensor:
    """Volumetric C-scan on the int8-direct display path: per-frame raw
    magnitudes like :func:`sharded_cscan_volume`, each frame through the
    folded s8 operator (two s8 products), the rank's rows of the plan on a
    mesh.  ``cfg`` is accepted for interface symmetry (the plan already
    encodes the geometry).  The span ``cscan.volume`` covers the host's
    enqueue of the volume."""
    del cfg
    with span("cscan.volume"):
        if mesh is not None:
            return _assemble_volume(_int8_mags(frames, plan, mesh), mesh, gather_full)
        mags = reconstruct_int8_direct(shift_u8_to_s8(frames.contiguous()), plan)
        return mags.transpose(-1, -2).contiguous()


# ---------------------------------------------------------------------------
# Angiography volumes (split-spectrum amplitude decorrelation, angio.py)
# ---------------------------------------------------------------------------


def sharded_angio_volume(frames: torch.Tensor, background: torch.Tensor,
                         pi_frame: torch.Tensor, op, cfg, mesh=None,
                         acfg: AngioConfig = AngioConfig(),
                         gather_full: bool = False) -> torch.Tensor:
    """The SSADA structure and decorrelation of a volume of position-major
    frames, stacked: (2, P, ndisp, oph), structure first
    (:mod:`fdoct_tpu_torch.angio`; ``op`` its ``SplitSpectrumOperator``).

    The mesh contract is :func:`sharded_cscan_volume`'s: ``frames`` is the
    rank's block (:func:`shard_frames`), frames over 'data', rows over
    'ascan'; each rank's block of frames must be whole groups of
    ``acfg.repeats`` (else ValueError).  One all-gather over 'ascan' (and
    over 'data' with ``gather_full``) assembles both volumes; the rank
    returns its positions, or all P with ``gather_full``.  With
    ``mesh=None`` the whole volume on the frames' device, every frame in
    one product with the stacked operator, each normalized by its own
    range as in the C-scan volume.

    The span ``angio.volume`` covers the host's enqueue of the volume."""
    with span("angio.volume"):
        count("angio.frames", frames.shape[0])
        if mesh is None:
            yr = apodize_ratio(preprocess(frames, cfg), background, pi_frame, cfg)
            s, d = ratio_ssada(yr, op, acfg, cfg.matmul_precision)     # (P, H, nd) each
            return torch.stack([s.transpose(-1, -2), d.transpose(-1, -2)])
        yr = _sharded_ratio(frames, background, pi_frame, cfg, mesh)
        s, d = ratio_ssada(yr, op, acfg, cfg.matmul_precision)         # (p_loc, h_loc, nd) each
        vol = _assemble_volume(torch.cat([s, d], dim=-1), mesh, gather_full)
        return vol.unflatten(1, (2, -1)).movedim(1, 0).contiguous()
