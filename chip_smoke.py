#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (fdoct_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

(``python3 chip_smoke.py --mesh-turns [--tree DIR]`` runs only phase 16's
mesh group times, of the checkout DIR: see :func:`mesh_turns`.)

Phases, each printed on its own line; any failure raises and exits non-zero:

1. device  — needs CUDA (there is no CPU branch); prints the card's name and
   power limit and turns TF32 off for matmuls and cuDNN.
2. build   — compiles csrc/fused_recon.cu, csrc/int8_bscan.cu and
   csrc/angio_product.cu with nvcc for sm_90a (one nvcc per source, in
   parallel) and prints ptxas's registers, shared memory and spills per
   kernel, and for each of the six
   warp-specialised kernels (fused_recon_ws_kernel<u8, u16, f32 input;
   MULTI: more frames than are in flight>) its registers at launch, the
   registers of each role after setmaxnreg and its spills (a spill is
   reported, not refused).
3. kernels — each instance of kernels 1-2 (raw u8 frames or an f32 ratio,
   against a float32 or a bfloat16 operator) against its plain PyTorch
   version on the card, at the flagship shape (8 frames of 512 x 2048 u8,
   the flagship M from Calibration.create, 512 depths), at a ragged shape,
   at RESIDENT_RAGGED and at the tensor-core schedule's edge shapes
   (ops.kernels.EDGE_SHAPES), each line with the schedule the instance took
   (ops.kernels.bf16_schedule / f32_schedule: the warp-specialised TMA +
   wgmma one, bf16 or 3xTF32 on the Calibration's TF32 table, where TMA can
   address the inputs, else mma.sync); the flagship and RESIDENT_RAGGED must
   take wgmma.  At those two shapes each instance, bf16 and f32, is also run
   on the same values through a view one element off a 16-byte boundary,
   which its C entry sends to mma.sync, and the two outputs must be equal
   (torch.equal; the line also gives the worst share of F64_TOL between
   them).
   Tolerance: float32 operator rtol 1e-4, atol 1e-4*max (3xTF32 against
   cuBLAS f32 with TF32 off); bfloat16 operator rtol 1e-5, atol 1e-5*max
   (TC_TOL: both round the same f32 ratio to bf16, so only the order of the
   f32 sums differs).  The float32-operator instance and cuBLAS f32 are also
   held to the float64 product of the same f32 ratio and operator at
   F64_TOL, rtol 5e-6, atol 5e-6*max, which a TF32 control (cuBLAS with
   TF32 on) must fail at every shape.  Each bf16 instance and cuBLAS f32 on
   its bf16-rounded operands (its plain version) are held to the float64
   product of those operands at BF16_F64_TOL, rtol 2e-6, atol 2e-6*max
   (4x what cuBLAS f32 reads at the flagship), so that a drift of the
   tensor cores' truncating sums shows; at the flagship the chain of k16
   steps truncated to 24 bits (truncating_chain) is read beside them, and
   the same chain at 23 bits, a control, must fail the limit.  Then on u8
   white noise against the flagship M (random_problem, seed SEED + 21,
   whose ratio has a large mean that M cancels: the hardest case for the
   sums), white_noise_phase holds kernels 1-2's bf16 instances (kernel 2 on
   the noise's ratio) and the resident entry, each in both schedules and
   equal bit for bit, to BF16_F64_TOL, beside cuBLAS f32, the model of the
   schedules' sums (the 24-bit chain rounded every ROUND_STAGES stages of
   csrc/fused_recon.cu), the chain never rounded and the 23-bit control,
   which must fail.  Prints each worst share of tolerance.
4. slice   — the port's main path at the flagship config, one Session per
   instance (SESSION_PATHS): 'base' (the raw kernel) and 'sim' with
   donotnormalize off, as `fdoct sim` sets it (the ratio kernel), each at
   'default' (bf16 operator on CUDA) and 'highest' (f32 operator).  Each
   captures 'b' and 'p', then the launch counts are set to 0 just before its
   process_group calls (4 batches of 16 frames, 8 groups, for 'base'; one,
   2 groups, for 'sim') and read just after: exactly one launch of its
   kernel per group, and no other.  Its last group is compared with the
   plain version plus form_bscan: bf16, 2e-2 dB on pixels within 40 dB of
   the peak; f32, the linear B-scan at rtol 1e-4, atol 1e-4*max, and
   against form_bscan of the float64 product at F64_TOL; uint8 within 1
   level.  Then a 'base' session at dtype="float64" runs one group on the
   card through the plain chain (pipeline.group_kernel_applies) with no
   kernel launch, held to form_bscan of the float64 product at rtol 1e-9.
5. times   — CUDA-event medians of 20 calls of each instance and its plain
   version at the flagship shape, each call timed alone ("ms", which
   includes the wrapper's host time where that is longer than the kernel)
   and as the mean of 10 back-to-back calls ("ms_b2b", where the host's
   time hides behind the device's); the cuBLAS product of the (B*rows x
   n_in) stack by the concatenated (n_in x 2*ndisp) operator, f32 (TF32
   off) and bf16 ("product_ms": the product alone, not the function); and
   per session time_session: the host-clock time per group of
   process_group, then a torch.profiler pass (device busy time, idle share,
   H2D and group-kernel time per group).  bench_sessions.py times the
   kernels and the sessions of another checkout with these functions.
   Then the bf16 schedule's L2 traffic (l2_phase): for kernel 1 on u8 and
   u16 frames, kernel 2, the resident entry and a group of one frame the
   modelled bytes a flagship launch reads from the L2 (wgmma_l2_bytes, a
   count from the tile's shape, not a trace: every row tile reads the
   whole operator) beside its device time and the rate they imply.
6. int8 kernels — int8_bscan_display_fused against its plain version
   (torch._int_mm + torch epilogue) on the card, with and without the linear
   output, at the flagship shape (8 s8 frames of 512 x 2048 and the plan
   folded from the synthetic background and pi) and at a ragged shape,
   printing the schedule each takes (ops.kernels.int8_schedule: the
   warp-specialised TMA + s8 wgmma one where n_in % 16 == 0 and the bases
   are 16-byte aligned, else mma.sync).  Tolerance: dB and the min/max
   partials rtol 1e-5, atol 1e-4; linear rtol 1e-5.  Then every output (db,
   mn, mx, linear) of the wgmma schedule torch.equal to the mma.sync one's
   on the same values through a misaligned view, at the flagship and at
   RESIDENT_RAGGED (ragged in rows, samples and depths at strides TMA
   takes; RAGGED's n_in of 300 takes mma.sync either way).
7. int8 slice — the int8-direct display mode at the flagship config: a 'base'
   Session with matmul_precision 'int8_direct' captures 'b' and 'p' from the
   synthetic source, prints the plan's rank-1 residual, then process_group
   on 4 batches of 16 frames (8 groups, one int8 kernel launch each).  Launch
   counts are reset just before and read just after.  One group is held to
   form_bscan(reconstruct_int8_direct(...).sum(0)) (dB rtol 1e-5, atol 1e-4;
   uint8 within 1) and, on pixels within 30 dB of the peak, to a 'bf16'
   session on the same captures within 0.35 dB.
8. int8 times — the kernel (with the plan's packed operator, as the
   session calls it) against its plain version, hot (the same group every
   call) and streamed (each call the next of 32 distinct groups, 256 MiB,
   more than the L2 holds), timed both ways as in phase 5, its device time
   (torch.profiler, the int8 kernel alone), the torch._int_mm product and
   the bound, beside the parent's mma.sync times (PARENT_B2B_MS), and the
   int8 session by time_session.
9. resident kernels — fused_recon_resident (its C entry runs kernel 1 u8
   bf16's schedules) against its plain version (the raw-input plain version
   with the operator rounded to bf16) and against kernel 1's bf16 instance
   (bit for bit), at the flagship shape, the ragged shape, a shape ragged
   in every tile of the wgmma schedule (RESIDENT_RAGGED) and every
   EDGE_SHAPES entry, with a float32 and a bfloat16 operator passed in (the
   wrapper casts to bf16), printing the schedule each shape takes (the
   flagship and RESIDENT_RAGGED must take "wgmma").  Tolerance rtol 1e-5,
   atol 1e-5*max: all three round the same f32 ratio, so only the order of
   the f32 sums differs.  Each shape also against the float64 product at
   BF16_F64_TOL, as in phase 3.  Times, both ways as in phase 5: the kernel
   and its plain version hot and streamed over 32 groups, and kernel 1 bf16
   on the same sum, beside the earlier resident kernel's recorded times.
10. resident bench — fdoct_tpu_torch.bench_resident at the flagship: every
   reconstruction route of one group (f32, default, int8, int8_direct, plain
   bf16, kernels 1, 2 and the resident kernel), each within 5e-2 of the f32
   route, timed hot and streamed over 32 distinct groups.  Launch counts are
   reset just before and read just after; the resident kernel must launch.
11. stream  — the streaming ingest (fdoct_tpu_torch.streaming): a flagship
   'base' 'default' Session behind run_streaming, step = process_group, one
   averaging group (8 frames) per batch, the seeded synthetic frames (a
   cycle of STREAM_POOL, each copy stamped with its index so every frame
   differs, made before the stream as a camera's ring holds them) paced at
   500 fps, lossless, the step keeping each group's uint8 display (as a
   live viewer does), for STREAM_GROUPS_RUN groups after
   a stream of STREAM_WARMUP_GROUPS that pays the start-up (its first
   group's latency is printed).  Prints groups done, dropped (must be 0),
   sustained fps and the frame->display latency p50 / p99 (host clock: from
   the moment the source yields a group's last frame to the moment
   process_group has its uint8 display in host memory, both read by
   wrapping the iterator and the step here); launch counts reset just before and read just after: exactly one
   fused_recon_raw_accumulate launch per group; every display byte-equal to
   a direct process_group on the same frames and captures.  Then the
   profiler's breakdown (device busy, idle share, H2D and the part of it
   beside kernels, group kernel; as time_session reports them) of 16 of
   those groups streamed again, paced and unpaced (from a list, so the next
   batch is queued when a step starts and its copy is issued before the
   step), and fdoct_tpu_torch.bench_ingest at the flagship (phases 1-5:
   pageable and pinned H2D bandwidth, the host copy into a pinned slot,
   ingest-inclusive A-scans/s, the 500 fps FLIR emulation, the bandwidth
   500 fps needs, the camera ring's frames to the device per frame).
12. stepwise — Session(method="gather") and Session(method="hilbert"), one
   flagship 'base' group each on the card, in float32 and float64, with no
   kernel launch (counts reset around each): gather against the
   method="fused_exact" session's linear B-scan at rtol = atol/max 1e-4
   (float32) and GATHER_F64_TOL = 1e-8 (float64); hilbert's peak depth
   equal to gather's on every A-scan; each method's group time
   (time_session).
13. session state — the rest of the session at the flagship, each path's
   launch counts set to 0 just before its groups and read just after: a
   'dark' 'default' Session ('o'/'r'/'t' captures, then process_group:
   one kernel 1 bf16 launch per group, the dark frame folded into pi; its
   last group against fused_recon_raw_accumulate_reference with pi = yp + yd
   and form_bscan within phase 4's bf16 limits); a 'dark' 'int8_direct'
   Session (one kernel 3 launch per group, on the plan that folds the dark
   frame; held to its plain chain as in phase 7); a 'peak' 'highest' Session
   (one kernel 1 f32 launch per group and none of kernel 3) running the
   three vibrometry holds, still, still and vibrating at VIB_NM, to a finite
   displacement; a 'base' 'default' Session with saveframes,
   saveinterferograms, J-lockin and a RunWriter in a temporary directory
   (averages launches per group, B = 1 each, for the ring's per-frame
   magnitudes; every group's subtracted display; an 's' save writing
   exactly the files the JAX session names, whose PNGs decode to the
   displays, the source's raw frames and the plain chain's per-frame
   display); a 'spinj' Session with bscanbinx = 2 (the per-frame path,
   averages launches per group) against bscan_rebin of the plain chain.
   Each path's group time (time_session).
14. cli     — the command line (fdoct_tpu_torch.cli.main, in process, on the
   default device cuda) at the flagship config (a JSON --config), each command's
   launch counts set to 0 just before it and read just after, and its exit
   status, files and stdout checked: selftest; sim --frames 8 (kernel 2,
   one launch per frame: 64) and live --frames 64 --batch 8 (one launch per
   group: 8 of kernel 1, or of kernel 3 under int8_direct) at 'default',
   'highest' and 'int8_direct'; live --checkpoint then --resume (kernel 1);
   cscan --frames 512 --dispersion-sweep at 'default' and 'int8_direct' and
   sweep --joint (no launch: the volume is torch.matmul / _int_mm products,
   as the JAX volume is XLA products). Then the C-scan's numbers at F = 512
   (CSCAN_FRAMES): the cscan command's wall seconds (frames from the
   synthetic source in host memory to cscan.npz) beside the host seconds
   of that source's 512 frames alone; the volume reconstruction's device ms
   (CUDA events, frames on the card), frames/s and peak device memory
   (max_memory_allocated) beside its bound (2 x F x 512 x 2048 x 512
   multiply-adds at the bf16, f32 and s8 peaks, and the bytes); the
   dispersion sweep's ms (33 candidates on 32 rows) and the joint sweep's
   (33 x 16). The card's volume of 16 seeded noisy frames is held to the
   port's float64 volume of the same frames on the card: 'default' and
   'int8_direct' at atol CSCAN_TOL of the float64 peak.
15. viewer and analysis — the live viewer (fdoct_tpu_torch.viewer,
   viewer_server) and the analysis modules at the flagship config: a 'base'
   'default' Session drives Viewer(mode="http", port=0) as `live` does for
   VIEWER_GROUPS groups (counts reset around the loop: one kernel 1 bf16
   launch per group); a POSTed ']' key, config edit and ROI drag reach the
   session; GET /frame/bscan.png decodes to render_bscan of the last group
   byte for byte; /status.json lists show, status and bscan.  Then `live
   --frames 64 --batch 8` with --viewer DIR, with --viewer-mode http
   --viewer-port 0 (its URL on stderr) and with --viewer DIR --precision
   int8_direct (8 launches of kernel 1 or kernel 3; the windows decode),
   the host-clock time per group of process_group + show_session_frame with
   no viewer, files and http (turns N F H H F N), and each window's PNG
   encode.  Doppler and OCT-A on 8 flagship frames (a scatterer moving
   DOPPLER_STEP_NM a frame; a jittering and a static one) at 'default' and
   'highest' against the float64 Doppler on the card (DOPPLER_TOL_NM,
   OCTA_TOL, the step within DOPPLER_STEP_TOL), the spectrometer (512
   A-scans of 3648 px, measured lambda, nfft 3 x 3648) and the three Wang
   estimators (512 rows, n = 1024) in float32 against float64 numpy at
   ANALYSIS_RTOL, each launching no kernel, with device ms (CUDA events)
   and Doppler's bound (2 x 8 x 512 x 2048 x 512 multiply-adds).
16. mesh    — the device mesh (fdoct_tpu_torch.parallel) on a world of one
   with nccl (WorldOfOne("cuda"), a 1 x 1 mesh; the machine has one card).
   For 'base' 'default' (kernel 1 bf16), 'base' 'highest' (kernel 1 f32),
   'sim' 'default' (kernel 2 bf16) and 'base' 'default' with mediann = 3
   (kernel 2 bf16 after the median): sharded_bscan_step on one group
   (exactly one launch, its dB against the single-device session's group
   within 1e-4, its collective bytes printed), then an 8-group
   Session(mesh=) on the captures of a single-device session, counts set to
   0 just before and read just after (exactly one launch a group), its
   displays held to the single-device session's on the same frames: uint8
   within 1 level (the pixels that differ printed; 0 expected), dB within
   1e-4.  The 'base' 'default' group time of the single-device and the mesh
   session, host clock, turns P C C P, and the mesh session's profiled
   breakdown.  'base' 'int8_direct' on the mesh (no launch: the mesh int8
   step is two torch._int_mm products and the shared tail, as in the JAX
   package) against the single-device int8 session (kernel 3): uint8 within
   1, dB rtol 1e-5, atol 1e-4.  The F = 512 volume, 'default' and
   'int8_direct', on the mesh (gather_full) and with mesh=None, turns P C C
   P, device ms (CUDA events) and peak device memory above the frames, equal
   within 1e-6 of the peak, and the host time that enqueues each volume's
   launches.  The mesh session's CUDA graphs (mesh_graph_phase): for
   'base' 'default' and 'highest', 'sim', 'dark', 'int8_direct' and
   saveframes, three batches of 2 groups, the first capturing the batch's
   graph with its NCCL collectives, the next two replaying it, each
   bit-equal to the eager step (session_mesh_pipeline[_int8]) with its
   launches and collective bytes, each graph's pool printed; a threshold
   key (no new capture) and a 'b' capture (a new one); a 'base' 'default'
   mesh group's host time in parts, eager and replayed, and group ms,
   device busy and idle share, turns E R R E.  Then `live --frames 64
   --batch 8 --mesh 1x1` (8 kernel 1 launches) and `cscan --frames 64 --mesh
   1x1` (none), each opening and closing its own world of one, and
   dryrun_multichip(1, "cuda") (one spawned nccl rank at the flagship, each
   check within 2e-2 dB).
17. kernel1_u16 — kernel 1 on 16-bit frames (u16_phases): both u16
   instances against their plain versions and the float64 product, at the
   flagship on the full 16-bit range and on Mono16 frames, at RAGGED
   (the element loads; mma.sync) and at RESIDENT_RAGGED, the bf16
   instance's schedule printed (wgmma at the flagship and RESIDENT_RAGGED,
   and there torch.equal to mma.sync through a misaligned view, as in
   phase 3); their times; a 12-bit flagship 'base' session at
   'default' and 'highest' (one kernel 1 launch a group, no kernel 2;
   displays within 1 uint8 level of the kernel-2 route that 16-bit frames
   took before; group times of both routes, turns P C C P).
18. bench   — `fdoct-torch bench` in process (bench_phase): its JSON line
   with every key of bench.py's or the row named in "dropped", the card's
   name and power limit, kernel 1 once a headline group and nothing else,
   one headline display byte-equal to Session.process_group's.  The line is
   printed.
19. graphs  — the captured group steps (fdoct_tpu_torch.graphs, graphs_phase):
   for each session path of PERF.md §5 (GRAPH_PATHS: 'base' and 'sim' at
   'default' and 'highest', 'base' and 'dark' at 'int8_direct', 'dark'
   'default', 'peak' 'highest', 'base' with both rings, the 12-bit 'base'
   at 'default' and 'highest', and 'base' 'default' on a 1 x 1 mesh in a
   world of one) three process_group calls of 2 groups, the
   first capturing the step's CUDA graph (it runs the step eagerly once),
   the next two replaying it: every display, dB and linear B-scan equal to
   the eager step (session_group_pipeline[_int8]) on the same state bit for
   bit, the launch counts the eager step's, each graph's pool printed; a
   threshold key and a 'b' capture between batches at 'default' and
   'int8_direct' (the next group equal to the eager step, the graph
   captured again where its state or its int8 floor changed); then a
   'base' 'default' group's host time in parts (route, np.copyto staging,
   H2D enqueue, step, D2H, bookkeeping), eager and replayed, beside the
   parent's per-group copy of its display floor, and group ms, device busy
   and idle share of the eager step and of the replay, turns E R R E.

20. angio   — the angiography volume's split-spectrum product
   (angio_product_phase): ops.kernels.split_spectrum_mags at the
   octa500-angio800 cell's full shape: the cell's volume entry
   (sharded_angio_volume, one card, 'highest', float32) on 800 seeded
   frames launches it once and no other kernel (counts set to 0 just
   before); then on 800 frames x 400 A-lines of seeded ratio rows, 2048
   samples, the cell's operator of 3,200 columns, its TF32 table from
   SplitSpectrumOperator.create, the schedule it takes (wgmma),
   against its plain version (cuBLAS f32 and the magnitudes) at TOL["f32"]
   and against the float64 product on every 97th row at F64_TOL (the TF32
   control beyond it), bit for bit kernel 2's f32 instance at B = 1 on the
   same stack and its mma.sync form on 16 frames through a misaligned view;
   ptxas's registers and spills of split_spectrum_mags_kernel; its times
   beside the plain version's, the bound and cuBLAS's f32 product of the
   stack with [op_re | op_im].

On CUDA every session path of phases 4-18 that takes process_group's fast
path replays its captured graph, the mesh's too (the per-frame path runs
eagerly),
and `fdoct-torch bench`'s chained rows replay theirs: their times are the
graphs'.

The line before the last is {"kernels": [...]}, one entry per instance
(kernels 1-2 each with a bf16 and an f32 operator, kernel 1's two u16
instances ("input": "u16", launches from phase 17's sessions), kernel 3,
the resident kernel, and phase 20's split-spectrum product, which replaces
no TPU kernel: "replaces" null, "launches" from its phase's volume): every time in it was measured in this run; "ms"/"plain_ms" are
single calls and "ms_b2b"/"plain_ms_b2b" back-to-back calls (phase 5);
"launches" is the count from the instance's session paths, phases 4, 13,
14, 15 and 16 (for the resident kernel, which no session runs, the count from
phase 10's bench_resident run, with the counts set to 0 just before it;
its entry adds
its schedule, streamed times and kernel 1 bf16's times); kernel 1 bf16's
entry adds "streamed_session_launches", phase 11's count; the kernel 1-2
entries add "mesh_launches", phase 16's count (included in "launches");
"bound_ms" is the larger of the bytes (each input read and each output
written once, at 3.35 TB/s) and the product's operations at the dense peak
of the operator type (bf16 989 TFLOP/s, s8 1,979 TOPS; an f32 operator as
three TF32 products at 495 TFLOP/s), computed from this run's inputs;
"library_ms" is null (no single PyTorch call computes sum_b |x_b @ M|) and
"product_ms" times the operator product alone; "mma" names the
tensor-core instruction and "schedule" the schedule the instance took at
the flagship ("wgmma" or "mma.sync") with "bit_equal_to_mma_sync", the
outcome of the misaligned-view checks; the float32-operator entries add their worst
shares of F64_TOL and those of cuBLAS f32 and of the TF32 control, the
bf16 entries theirs of BF16_F64_TOL and cuBLAS f32's (kernels 1-2 also the
24- and 23-bit chains' at the flagship), "white_noise_share_of_bf16_f64_tol"
(the worse schedule's on white noise against the flagship M) and
"round_stages" (ROUND_STAGES of csrc/fused_recon.cu).  The line before it gives the
script's total wall time.  The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import itertools
import json
import re
import statistics
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
FLAGSHIP = dict(width=2048, height=512, binvalue=1, averages=8,
                numfftpoints=2048, numdisplaypoints=512,
                lambdamin=816e-9, lambdamax=884e-9,
                increasefftpointsmultiplier=1, dtype="float32", compat=True)
RAGGED = (3, 100, 300, 77)         # B, rows, n_in, ndisp
#: ragged in every tile of the resident kernel's wgmma schedule (rows % 16,
#: n_in % 64, ndisp % 128) at strides TMA takes
RESIDENT_RAGGED = (8, 70, 1040, 200)
TOL = {"f32": 1e-4, "bf16": 2e-2}
REPLACES = {
    "fused_recon_raw_accumulate": "fdoct_tpu/ops/pallas_kernels.py:147",
    "fused_recon_accumulate": "fdoct_tpu/ops/pallas_kernels.py:297",
    "int8_bscan_display_fused": "fdoct_tpu/ops/pallas_kernels.py:244",
    "fused_recon_resident": "fdoct_tpu/ops/pallas_kernels.py:109",
}
SOURCE = "fdoct_tpu_torch/csrc/fused_recon.cu"
INT8_SOURCE = "fdoct_tpu_torch/csrc/int8_bscan.cu"
INT8_TOL = (1e-5, 1e-4)            # rtol, atol of dB and of the min/max partials
RESIDENT_TOL = 1e-5                # rtol = atol/max of the resident kernel
#: rtol = atol/max of the bf16 tensor-core instances: they round the same f32
#: ratio to bf16 as their plain versions, so only the order of the f32 sums
#: differs (the f32 instances keep TOL["f32"])
TC_TOL = {("fused_recon_raw_accumulate", "bf16"): 1e-5, ("fused_recon_accumulate", "bf16"): 1e-5}
#: rtol = atol/max of the f32 instances and of cuBLAS f32 against the float64
#: product of the same f32 ratio and operator: float32-grade products pass
#: it, one TF32 product per multiply-add (~3 decimal digits) does not, nor
#: do 3xTF32 products chained in one tensor-core accumulator
F64_TOL = 5e-6
#: rtol = atol/max of every bf16 instance (kernels 1-2, the resident kernel)
#: and of cuBLAS f32 against the float64 product of the same bf16-rounded
#: ratio and operator.  Set on camera-like flagship frames, where cuBLAS f32
#: reads at most 5.2e-7 (NVIDIA H100 80GB HBM3, 700 W).  It holds white noise
#: against the flagship M too, whose ratio has a large mean that M cancels:
#: there cuBLAS f32 reads 0.48-0.50 of it and the bf16 schedules, their sums
#: rounded every ROUND_STAGES stages, 0.14-0.15, where the same sums chained
#: unrounded (the 24-bit truncating_chain) read 3.2; the 23-bit control fails
#: it on every kind of frames
BF16_F64_TOL = 2e-6
#: rtol = atol/max of the float64 session's B-scan against form_bscan of
#: the float64 product: both run float64 products, in another order
F64_SESSION_TOL = 1e-9
#: the bf16 instances' schedule (the resident entry's too), where TMA can
#: address the inputs; elsewhere they run MMA_SYNC_BF16, the same sums
MMA_BF16 = ("wgmma.mma_async.m64n128k16.f32.bf16.bf16 (warp-specialised: a TMA producer "
            "warpgroup, a warpgroup forming each A tile, two consumer warpgroups of 64 depths "
            "reading it, A and B from shared memory; each round of ROUND_STAGES stages summed "
            "in a fragment added in round-to-nearest f32)")
MMA_SYNC_BF16 = ("mma.sync.m16n8k16.f32.bf16.bf16.f32 (each round of ROUND_STAGES stages summed "
                 "in a fragment added in round-to-nearest f32)")
#: the parent's back-to-back flagship ms of the bf16 instances on the
#: mma.sync schedule and of the earlier resident kernel (PERF.md §6,
#: NVIDIA H100 80GB HBM3, 700 W), printed beside this run's
PARENT_B2B_MS = {("fused_recon_raw_accumulate", "bf16"): "0.1609-0.1699",
                 ("fused_recon_accumulate", "bf16"): "0.1239-0.1255",
                 "u16 bf16": "0.1705-0.1709", "fused_recon_resident": "0.0621-0.0647",
                 ("fused_recon_raw_accumulate", "f32"): "0.3652",
                 ("fused_recon_accumulate", "f32"): "0.3274", "u16 f32": "0.3850",
                 "int8_bscan_display_fused": ("hot 0.0904, streamed 0.0800 b2b; 68-69 us "
                                              "device")}
#: the f32-operator instances' schedule where TMA can address the inputs;
#: elsewhere they run MMA_SYNC_TF32X3, the same sums
MMA_TF32X3 = ("wgmma.mma_async.m64n128k8.f32.tf32.tf32 (3xTF32: lo.hi + hi.lo + hi.hi, "
              "each stage's sums added in round-to-nearest f32; warp-specialised: a TMA "
              "producer warpgroup, two consumer warpgroups, A from registers, the K-major "
              "TF32 table from shared memory)")
MMA_SYNC_TF32X3 = "mma.sync.m16n8k8.f32.tf32.tf32.f32 (3xTF32)"
MMA = {("fused_recon_raw_accumulate", "bf16"): MMA_BF16,
       ("fused_recon_raw_accumulate", "f32"): MMA_TF32X3,
       ("fused_recon_accumulate", "bf16"): MMA_BF16,
       ("fused_recon_accumulate", "f32"): MMA_TF32X3,
       "int8_bscan_display_fused": ("wgmma.mma_async.m64n256k32.s32.s8.s8 (warp-specialised: "
                                    "a TMA producer warpgroup, two consumer warpgroups, frames "
                                    "and the packed operator K-major from shared memory)")}
#: kernel 3 where TMA cannot address the frames (n_in % 16 != 0 or a base
#: off 16 bytes); every output the same bit for bit
MMA_SYNC_S8 = "mma.sync.m16n8k32.s32.s8.s8.s32"
#: the session paths of phase 4: (variant, matmul_precision, kernel, operator,
#: batches of 16 frames = 2 groups each)
SESSION_PATHS = [("base", "default", "fused_recon_raw_accumulate", "bf16", 4),
                 ("base", "highest", "fused_recon_raw_accumulate", "f32", 4),
                 ("sim", "default", "fused_recon_accumulate", "bf16", 1),
                 ("sim", "highest", "fused_recon_accumulate", "f32", 1)]
#: dense peaks of one H100 SXM at 700 W (operations per second) and the
#: operations each multiply-add of the operator product costs there: an f32
#: operator runs as three TF32 products
PEAK = {"bf16": 989e12, "f32": 495e12, "s8": 1979e12}
OPS_PER_MAC = {"bf16": 2, "f32": 6, "s8": 2}
HBM_BYTES_PER_S = 3.35e12
B2B = 10                           # back-to-back calls per sample of the *_b2b times
STREAM_GROUPS = 32
SESSION_CALLS = 20                 # timed process_group calls per session, after one pass
STREAM_FPS = 500                   # the source rate of the streamed session (PERF.md §2)
STREAM_GROUPS_RUN = 128            # groups of the streamed session's latency run
STREAM_WARMUP_GROUPS = 8           # groups of the stream before it
STREAM_GROUPS_PROFILED = 16        # groups of each profiled streamed pass
STREAM_POOL = 64                   # distinct synthetic frames the stream cycles through
#: rtol = atol/max of the float64 gather session against the float64
#: fused_exact session (PARITY.md layer 3)
GATHER_F64_TOL = 1e-8
#: frames of the phase-14 C-scan (the volume users acquire, autofocus.py:4-5)
#: and the atol, as a share of the float64 volume's peak, of the card's
#: 'default' (bf16 operands) and 'int8_direct' volumes of 16 frames against
#: it (NVIDIA H100 80GB HBM3, 700 W: 1.5e-3 and 2.2e-3 of the peak)
CSCAN_FRAMES = 512
CSCAN_TOL = 5e-3
#: f32 products outside the tensor cores (TF32 off), as 'default' runs the
#: C-scan's products on bf16-rounded operands
F32_SIMT_PEAK = 67e12
#: displayed B-scans per vibrometry hold in phase 13, and the vibrating
#: source's amplitude (nm) for its third hold
PEAK_HOLD = 4
VIB_NM = 60.0
#: phase 15: groups of the http viewer loop and of each timed turn
VIEWER_GROUPS = 8
VIEWER_TIMED_GROUPS = 16
#: phase 15's Doppler frames: a scatterer moving DOPPLER_STEP_NM a frame, its
#: velocity at the scatterer within DOPPLER_STEP_TOL of the step; the worst
#: velocity error (nm) against the float64 Doppler on the card where the
#: magnitude is above twice the floor, and OCT-A's worst speckle-variance error
#: there as a share of its peak, at 'default' (bf16 operands) and 'highest'
#: (an emulation on the CPU read 0.0053 nm and 1.8e-3 for 'default', 3.4e-6 nm
#: and 1.2e-6 for 'highest')
DOPPLER_FRAMES = 8
DOPPLER_STEP_NM = 30.0
DOPPLER_STEP_TOL = 0.02
DOPPLER_TOL_NM = {"default": 0.1, "highest": 1e-3}
OCTA_TOL = {"default": 2e-2, "highest": 1e-4}
#: phase 15's spectrometer (the reference's Ocean Optics width) and Wang
#: estimators, float32 on the card against float64 numpy at rtol = atol/max
#: ANALYSIS_RTOL
SPEC_ASCANS, SPEC_PIXELS = 512, 3648
WANG_ROWS, WANG_N = 512, 1024
ANALYSIS_RTOL = 1e-5


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def phase(name: str, text: str) -> None:
    print(f"[{name}] {text}", flush=True)


def compare(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float) -> dict:
    """Max abs error and the worst error as a share of rtol·|want| + atol."""
    got, want = got.double(), want.double()
    err = (got - want).abs()
    return {"max_abs_err": float(err.max()),
            "worst_share_of_tol": float((err / (rtol * want.abs() + atol)).max()),
            "finite": bool(torch.isfinite(got).all())}


def random_problem(shape, seed: int, dev: torch.device) -> dict:
    """Random u8 frames, pi, inv_background, an f32 ratio and an operator
    (f32 and its bf16 rounding) of shape (B, rows, n_in, ndisp)."""
    B, rows, n_in, ndisp = shape
    rng = np.random.default_rng(seed)
    inp = {
        "raw": torch.as_tensor(rng.integers(0, 255, (B, rows, n_in), dtype=np.uint8)).to(dev),
        "pi": torch.as_tensor(rng.uniform(0, 50, (rows, n_in))).to(dev, torch.float32),
        "inv": torch.as_tensor(1.0 / rng.uniform(50, 200, (rows, n_in))).to(dev, torch.float32),
        "yr": torch.as_tensor(rng.normal(size=(B, rows, n_in))).to(dev, torch.float32),
    }
    mr, mi = (torch.as_tensor(rng.normal(size=(n_in, ndisp))).to(dev, torch.float32)
              for _ in range(2))
    inp["f32"], inp["bf16"] = (mr, mi), (mr.to(torch.bfloat16), mi.to(torch.bfloat16))
    inp["tf32"] = tf32_table(mr, mi)
    return inp


def tf32_table(mr: torch.Tensor, mi: torch.Tensor) -> torch.Tensor:
    """The f32 instances' TF32 table of (mr, mi), packed once per problem as
    a Calibration packs it, outside every timed call."""
    from fdoct_tpu_torch.ops.kernels import pack_tf32_operator
    return pack_tf32_operator(mr, mi)


def table_kw(inp: dict, op: str) -> dict:
    """The keyword a kernel wrapper takes beside operator ``op`` of problem
    ``inp``: the TF32 table with an f32 operator."""
    return {"op_tf32": inp["tf32"]} if op == "f32" else {}


def captured_session(session_cls, cfg, variant: str, src, frames, calib, dev, **kw):
    """A session with its 'b' and 'p' captures done: 'sim' from its source,
    any other variant from 8 background frames and the pi frame + 7 frames,
    then one group.  ``kw`` goes to the session (a sink)."""
    s = session_cls(cfg, device=dev, variant=variant, calib=calib,
                    **({"source": src} if variant == "sim" else {}), **kw)
    s.key("b")
    if variant != "sim":
        for _ in range(cfg.averages):                 # S(k) from 8 background frames
            s.process(src.background())
    s.key("p")
    first = [src.pi_frame()] if variant != "sim" else []
    for f in first + [next(frames) for _ in range(cfg.averages - len(first))]:
        s.process(f)
    check(s.indextemp == 0 and not s._pending, f"{variant} captures left it mid-group")
    return s


def bound_keys(op: str, macs: int, inputs, outputs) -> dict:
    """The least time of the card for the work: the larger of each input read
    and each output written once at the HBM rate, and the product's
    operations at the dense peak of the operator type."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in list(inputs) + list(outputs if isinstance(outputs, (list, tuple))
                                              else [outputs]))
    ops_ms = macs * OPS_PER_MAC[op] / PEAK[op] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms}


def bf16_f64_keys(shares: dict) -> dict:
    """The kernels line's float64 keys of a bf16 instance, from its
    {shape: bf16_f64_shares} readings."""
    return {"bf16_f64_tol": BF16_F64_TOL,
            "worst_share_of_bf16_f64_tol": worst_shares({k: v["kernel"] for k, v in shares.items()}),
            "cublas_f32_share_of_bf16_f64_tol": max(v["cuBLAS f32"] for v in shares.values()),
            **{f"{k.replace(' ', '_')}_share_of_bf16_f64_tol": v
               for k, v in shares["flagship"].items() if k.startswith("chain")}}


def worst_shares(shares: dict) -> dict:
    """Worst share of tolerance at the flagship, the ragged shape and over
    the edge shapes."""
    return {"flagship": shares["flagship"], "ragged": shares["ragged"],
            "edges": max(v for k, v in shares.items() if k.startswith("edge"))}


def product_times(fn) -> tuple[float, float]:
    """Median ms of single calls and of back-to-back calls of one product."""
    return cuda_ms(fn)[0], cuda_ms(fn, per=B2B)[0]


def f64_product(x32: torch.Tensor, op_re: torch.Tensor, op_im: torch.Tensor) -> torch.Tensor:
    """Σ_b |x32[b] @ (op_re + i·op_im)| in float64, from the float32 ratio
    and operator that the kernels take."""
    x = x32.double()
    return torch.hypot(x @ op_re.double(), x @ op_im.double()).sum(0)


def bf16_f64_product(x32: torch.Tensor, op_re: torch.Tensor, op_im: torch.Tensor) -> torch.Tensor:
    """Σ_b |bf16(x32[b]) @ (op_re + i·op_im)| in float64, from the float32
    ratio and the bf16 operator of a bf16 instance."""
    return f64_product(x32.to(torch.bfloat16).float(), op_re.float(), op_im.float())


def bf16_f64_shares(kernel: torch.Tensor, cublas: torch.Tensor, want: torch.Tensor,
                    **more: torch.Tensor) -> dict:
    """Worst shares of BF16_F64_TOL of a bf16 instance, of cuBLAS f32 on
    the same rounded operands (its plain version) and of ``more``, against
    ``want``."""
    atol = BF16_F64_TOL * float(want.abs().max())
    return {k: compare(v, want, BF16_F64_TOL, atol)["worst_share_of_tol"]
            for k, v in {"kernel": kernel, "cuBLAS f32": cublas, **more}.items()}


def truncating_chain(x32: torch.Tensor, op_re: torch.Tensor, op_im: torch.Tensor,
                     bits: int, round_stages: int | None = None) -> torch.Tensor:
    """Σ_b |bf16(x32[b]) @ (op_re + i·op_im)| with re and im each summed as a
    chain of 16-sample steps (one wgmma or mma.sync k16 step each): every
    step's partial sum exact (float64), the running sum truncated toward
    zero to ``bits`` significant bits after each step.  At 24 bits it models
    the tensor cores' truncating f32 sums; at fewer, a drift that
    BF16_F64_TOL must reject.  With ``round_stages`` the chain starts anew
    every ``round_stages`` stages of 64 samples and each round's sum is
    added to float32 running sums in round-to-nearest: at 24 bits and
    :func:`ws_round_stages`, a model of the bf16 schedules' sums."""
    x = x32.to(torch.bfloat16).double()
    op = torch.cat([op_re, op_im], 1).double()
    mask = -(1 << (53 - bits))               # sign, exponent and ``bits`` - 1 stored bits
    n_in = x.shape[-1]
    span = 64 * round_stages if round_stages else n_in
    acc = torch.zeros((*x.shape[:-1], op.shape[1]), dtype=torch.float32, device=x.device)
    for r0 in range(0, n_in, span):          # a round's chain, then its sum added (exact: 24 bits)
        part = torch.zeros(acc.shape, dtype=torch.float64, device=x.device)
        for k in range(r0, min(r0 + span, n_in), 16):
            part = ((part + x[..., k:k + 16] @ op[k:k + 16]).view(torch.int64) & mask
                    ).view(torch.float64)
        acc += part.float()
    re, im = acc.double().split(op_re.shape[1], -1)
    return torch.hypot(re, im).sum(0)


def ws_round_stages(source: Path | None = None) -> int:
    """ROUND_STAGES of namespace ws of csrc/fused_recon.cu (this checkout's,
    or ``source``): the stages of 64 samples whose products the bf16
    schedules sum in one tensor-core fragment before they add it to float32
    running sums in round-to-nearest."""
    text = (source or Path(__file__).resolve().parent / SOURCE).read_text()
    body = text[text.index("namespace ws {"):text.index("}  // namespace ws")]
    return int(re.search(r"constexpr int ROUND_STAGES = (\d+);", body).group(1))


def tf32_control(x32: torch.Tensor, op_re: torch.Tensor, op_im: torch.Tensor) -> torch.Tensor:
    """The same sum with one TF32 product per multiply-add (cuBLAS with TF32
    on): what F64_TOL must reject."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.hypot(x32 @ op_re, x32 @ op_im).sum(0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def union_us(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, end = 0.0, -float("inf")
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def profiled(fn) -> tuple[list, float, dict]:
    """One call of ``fn`` under ``torch.profiler``: the device events of the
    trace, the call's host-clock ms, and the CUDA streams that ran its H2D
    copies ("h2d") and its other device work ("other")."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    streams = {"h2d": set(), "other": set()}
    for k in prof.profiler.kineto_results.events():
        if k.device_type() == cuda:
            streams["h2d" if "HtoD" in k.name() else "other"].add(k.device_resource_id())
    return [e for e in prof.events() if e.device_type == cuda], wall_ms, streams


def wgmma_l2_bytes(B: int, rows: int, n_in: int, ndisp: int, elem: int, raw: bool) -> int:
    """The modelled bytes one launch of the bf16 wgmma schedule reads from
    the L2, counted from its tile, not traced: each row tile (WGMMA_TILE's
    pairs: 8 rows of 8 frames in flight) reads the operator of every depth
    tile (re and im, bf16); each depth tile reads the input rows of the B
    frames (``elem`` bytes a sample; the frames in flight past B are TMA's
    zeros, read from nowhere) and, for raw frames, pi and inv_background
    (f32)."""
    from fdoct_tpu_torch.ops.kernels import WGMMA_TILE
    pairs, depths = WGMMA_TILE
    row_tiles, depth_tiles = -(-rows // (pairs // 8)), -(-ndisp // depths)
    operator = row_tiles * depth_tiles * n_in * depths * 2 * 2
    inputs = depth_tiles * (B * rows * n_in * elem + (2 * rows * n_in * 4 if raw else 0))
    return operator + inputs


def l2_phase(flag_in: dict, card_line: str) -> None:
    """Phase 5's lines on the bf16 schedule's L2 traffic: each bf16
    instance's modelled bytes a flagship launch (wgmma_l2_bytes) beside its
    device time (torch.profiler) and the rate they imply."""
    from fdoct_tpu_torch.ops import kernels
    raw, pi, inv, ops = flag_in["raw"], flag_in["pi"], flag_in["inv"], flag_in["bf16"]
    B, rows, n_in = raw.shape
    ndisp = ops[0].shape[1]
    raw16 = torch.as_tensor(raw.cpu().numpy().astype(np.uint16) << 4).to(raw.device)
    calls = {"kernel 1 u8": (lambda: kernels.fused_recon_raw_accumulate(raw, pi, inv, *ops),
                             B, 1, True),
             "kernel 1 u16": (lambda: kernels.fused_recon_raw_accumulate(raw16, pi, inv, *ops),
                              B, 2, True),
             "kernel 2": (lambda: kernels.fused_recon_accumulate(flag_in["yr"], *ops), B, 4, False),
             "resident": (lambda: kernels.fused_recon_resident(raw, pi, inv, *ops), B, 1, True),
             "kernel 1 u8, one frame": (
                 lambda: kernels.fused_recon_raw_accumulate(raw[:1], pi, inv, *ops), 1, 1, True)}
    for label, (fn, frames, elem, is_raw) in calls.items():
        nbytes = wgmma_l2_bytes(frames, rows, n_in, ndisp, elem, is_raw)
        operator = wgmma_l2_bytes(0, rows, n_in, ndisp, elem, False)
        us = device_us(fn)
        phase("l2", f"{label} bf16 flagship: {nbytes / 2**20:.0f} MiB modelled from the L2 a "
              f"launch ({operator / 2**20:.0f} MiB of it the operator), device {us:.2f} us "
              f"(torch.profiler, median of 20) -> {nbytes / (us * 1e-6) / 1e12:.2f} TB/s "
              f"modelled | {card_line}")


def device_us(fn, calls: int = 20, name: str = "") -> float:
    """Median device time (us) of the kernels that ``calls`` calls of ``fn``
    launch (those whose name holds ``name``), after one call outside the
    trace."""
    fn()
    dev, _, _ = profiled(lambda: [fn() for _ in range(calls)])
    return statistics.median(e.time_range.elapsed_us() for e in dev if name in e.name)


def host_group_ms(session, batches, groups_per_call: int = 2) -> list[float]:
    """Host-clock ms per group of SESSION_CALLS ``process_group`` calls (each
    ending in the D2H of its displays), after one warm-up pass."""
    for b in batches:
        session.process_group(b)
    ms = []
    for i in range(SESSION_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        session.process_group(batches[i % len(batches)])
        ms.append((time.perf_counter() - t0) / groups_per_call * 1e3)
    return ms


def time_session(session, batches, groups_per_call: int = 2) -> dict:
    """Host-clock ms per group of ``process_group`` (which ends in the D2H of
    the displays): one warm-up pass over ``batches``, then SESSION_CALLS
    timed calls; then ``torch.profiler`` over one more pass: per group the
    device's busy time (the union of its kernel and copy intervals), its
    idle share of the profiled host time, the H2D copies and the group
    kernels (every fused_recon* and int8_bscan* kernel)."""
    ms = host_group_ms(session, batches, groups_per_call)
    out = {"group_ms": statistics.median(ms), "group_ms_min": min(ms),
           "group_ms_max": max(ms), "groups": groups_per_call * len(ms)}
    return {**out, **device_breakdown(lambda: [session.process_group(b) for b in batches],
                                      groups_per_call * len(batches))}


def device_breakdown(fn, groups: int) -> dict:
    """One call of ``fn`` under ``torch.profiler``, per group: the host-clock
    ms, the device's busy time (the union of its kernel and copy intervals),
    its idle share of the host time, the H2D copies, the group kernels
    (every fused_recon* and int8_bscan* kernel) and the part of the H2D
    copies that ran while a kernel ran (``h2d_overlap_ms``: copy and
    compute on two streams at once), and the streams of each."""
    dev, wall_ms, streams = profiled(fn)
    if not dev:
        return {"profiled": "not measured: no device events in the trace"}
    span = [(e.time_range.start, e.time_range.end) for e in dev]
    busy = union_us(span) / 1e3
    copies = [(e.time_range.start, e.time_range.end) for e in dev if "HtoD" in e.name]
    compute = [(e.time_range.start, e.time_range.end) for e in dev if "Memcpy" not in e.name
               and "Memset" not in e.name]
    kern = sum(e.time_range.elapsed_us() for e in dev
               if "fused_recon" in e.name or "int8_bscan" in e.name) / 1e3
    return {"profiled_group_ms": wall_ms / groups, "device_busy_ms": busy / groups,
            "idle_share": 1.0 - busy / wall_ms,
            "h2d_ms": sum(e - s for s, e in copies) / 1e3 / groups,
            "group_kernel_ms": kern / groups,
            "h2d_overlap_ms": (union_us(copies) + union_us(compute) - union_us(copies + compute))
            / 1e3 / groups,
            "h2d_streams": sorted(streams["h2d"]), "other_streams": sorted(streams["other"])}


def describe_session(t: dict) -> str:
    head = (f"median {t['group_ms']:.3f} ms (min {t['group_ms_min']:.3f}, max "
            f"{t['group_ms_max']:.3f}; {t['groups']} groups after one warm-up pass; host clock)")
    return f"{head}; {describe_breakdown(t)}"


def describe_breakdown(t: dict) -> str:
    if "profiled_group_ms" not in t:
        return f"profiler {t['profiled']}"
    return (f"profiled pass {t['profiled_group_ms']:.3f} ms/group: device busy "
            f"{t['device_busy_ms']:.3f} ms (idle share {t['idle_share']:.3f}), H2D "
            f"{t['h2d_ms']:.3f} ms ({t['h2d_overlap_ms']:.3f} ms of it beside kernels; H2D on "
            f"streams {t['h2d_streams']}, the rest on {t['other_streams']}), group kernel "
            f"{t['group_kernel_ms']:.3f} ms")


def cuda_ms(fn, runs: int = 20, warmup: int = 3, per: int = 1) -> tuple[float, float, float]:
    """Median, min and max milliseconds per call over ``runs`` samples, each
    timed with CUDA events around ``per`` back-to-back calls.  One call
    between two events also times the wrapper's host work when the kernel
    is shorter than it; with ``per`` > 1 that work overlaps the device's
    work on the call before."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times), min(times), max(times)


def timed_pair(kernel, plain) -> dict:
    """cuda_ms of a kernel and of its plain version, single and back-to-back
    calls."""
    return {"kernel": cuda_ms(kernel), "plain": cuda_ms(plain),
            "kernel_b2b": cuda_ms(kernel, per=B2B), "plain_b2b": cuda_ms(plain, per=B2B)}


def describe(t: dict) -> str:
    return "; ".join(f"{what} median {m:.4f} ms (min {lo:.4f}, max {hi:.4f})"
                     for what, (m, lo, hi) in t.items()) + \
        f"; 20 samples, CUDA events, *_b2b = {B2B} back-to-back calls per sample"


def time_keys(t: dict, prefix: str = "") -> dict:
    """The kernels line's times of a timed_pair: ms, plain_ms, ms_b2b,
    plain_ms_b2b (after ``prefix``)."""
    return {f"{prefix}ms": t["kernel"][0], f"{prefix}plain_ms": t["plain"][0],
            f"{prefix}ms_b2b": t["kernel_b2b"][0], f"{prefix}plain_ms_b2b": t["plain_b2b"][0]}


def schedule_of(x: torch.Tensor, ops, *terms: torch.Tensor, table=None) -> str:
    """The schedule an instance takes for input rows ``x``, the operator
    pair ``ops``, (raw frames) pi and inv_background ``terms`` and (an f32
    operator) the TF32 ``table``: what its C entry chooses before the launch
    (ops.kernels.bf16_schedule, f32_schedule)."""
    from fdoct_tpu_torch.ops.kernels import bf16_schedule, f32_schedule
    if ops[0].dtype == torch.bfloat16:
        return bf16_schedule(x.dtype, x.shape[-1], ops[0].shape[1],
                             [t.data_ptr() for t in (x, *ops, *terms)])
    return f32_schedule(x.dtype, x.shape[-1], ops[0].shape[1],
                        [t.data_ptr() for t in (x, table, *terms)])


def misaligned(x: torch.Tensor) -> torch.Tensor:
    """The same values through a view one element past an aligned buffer:
    not 16-byte aligned, so every instance takes the mma.sync schedule."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.flatten()
    return flat[1:].view(x.shape)


def bit_equal_schedules(run, x: torch.Tensor, ops, *terms: torch.Tensor,
                        table=None) -> tuple[bool, float]:
    """Whether ``run(x)`` on the wgmma schedule equals ``run`` on the same
    values through a misaligned view (the mma.sync schedule) bit for bit,
    and the worst share of F64_TOL between the two; checks that each took
    the schedule it should."""
    y = misaligned(x)
    check(schedule_of(x, ops, *terms, table=table) == "wgmma",
          "the aligned input does not take wgmma")
    check(schedule_of(y, ops, *terms, table=table) == "mma.sync",
          "the misaligned view does not take mma.sync")
    got, want = run(x), run(y)
    torch.cuda.synchronize()
    share = compare(got, want, F64_TOL, F64_TOL * float(want.abs().max()))["worst_share_of_tol"]
    return bool(torch.equal(got, want)), share


def white_noise_phase(label: str, run, plain, x: torch.Tensor, x32: torch.Tensor, ops,
                      *terms: torch.Tensor, chains: bool = False) -> dict:
    """A bf16 instance on white-noise frames against the flagship M, where
    the ratio's large mean, which M cancels, makes its sums hardest:
    ``run(rows)`` on its input rows ``x`` (the wgmma schedule) and on the
    same values through a misaligned view (mma.sync), and ``plain()``
    (cuBLAS f32 on the same rounded operands), against the float64 product
    of the rounded operands at BF16_F64_TOL; with ``chains`` also the model
    of the schedules' sums (truncating_chain at 24 bits, rounded every
    ROUND_STAGES stages), the chain never rounded (the sums before the
    rounding) and the 23-bit control.  Checks both schedules within the
    limit, equal bit for bit, and the control beyond it; prints the worst
    shares and returns them."""
    y = misaligned(x)
    check(schedule_of(x, ops, *terms) == "wgmma" and schedule_of(y, ops, *terms) == "mma.sync",
          f"{label} white noise: the schedules are not wgmma and mma.sync")
    got, got_mma = run(x), run(y)
    torch.cuda.synchronize()
    rs = ws_round_stages()
    more = {"mma.sync": got_mma}
    if chains:
        more.update({f"model rounded every {rs} stages": truncating_chain(x32, *ops, 24, rs),
                     "chain 24 bits never rounded": truncating_chain(x32, *ops, 24),
                     "chain 23 bits": truncating_chain(x32, *ops, 23)})
    shares = bf16_f64_shares(got, plain(), bf16_f64_product(x32, *ops), **more)
    same = bool(torch.equal(got, got_mma))
    phase("kernels", f"{label} white noise {tuple(x.shape)} against the flagship M op=bf16 "
          f"(ROUND_STAGES {rs}), against the float64 product of the rounded operands: "
          + ", ".join(f"{k} worst {v:.3e}" for k, v in shares.items())
          + f" of tol (rtol=atol/max={BF16_F64_TOL}); wgmma torch.equal mma.sync {same}")
    check(shares["kernel"] <= 1.0 and shares["mma.sync"] <= 1.0,
          f"{label}: the bf16 sums on white noise drift from the float64 product")
    check(same, f"{label}: the two bf16 schedules differ on white noise")
    check(shares.get("chain 23 bits", 2.0) > 1.0,
          f"{label}: the bf16 float64 limit passes a 23-bit truncating chain on white noise")
    return shares


def white_noise_keys(shares: dict) -> dict:
    """The kernels line's white-noise keys of a bf16 entry."""
    return {"white_noise_share_of_bf16_f64_tol": max(shares["kernel"], shares["mma.sync"]),
            "round_stages": ws_round_stages()}


def ptxas_summary(log: str, src: str | None = None, int8_src: str | None = None) -> list[str]:
    """One line per warp-specialised kernel of ptxas's -v output (the bf16
    schedule ws and the 3xTF32 one ws32, each on u8, u16 and f32 rows, and
    kernel 3's int8_bscan_ws_kernel, each with and without MULTI): its
    registers at launch (every thread), the registers a thread of each role
    takes after setmaxnreg (read from PRODUCER_REGS, FORMER_REGS and
    CONSUMER_REGS of each kernel's namespace in ``src`` and ``int8_src``,
    the texts of fused_recon.cu and int8_bscan.cu, by default this
    checkout's), shared memory, stack and spills."""
    here = Path(__file__).resolve().parent
    src = src or (here / SOURCE).read_text()
    texts = {ns: src[src.index(f"namespace {ns} {{"):src.index(f"}}  // namespace {ns}")]
             for ns in ("ws", "ws32")}
    texts["int8"] = int8_src or (here / INT8_SOURCE).read_text()
    roles = {f: {k: (m.group(1) if (m := re.search(rf"constexpr int {k} = (\d+);", text))
                     else None) for k in ("PRODUCER_REGS", "FORMER_REGS", "CONSUMER_REGS")}
             for f, text in texts.items()}
    types = {"h": "u8", "t": "u16", "f": "f32"}
    out, name, props = [], None, {}
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            continue
        k = re.search(r"fused_recon_(ws|ws32)_kernelI([htf])Lb([01])E", name or "")
        i8 = re.search(r"int8_bscan_ws_kernelILb([01])E", name or "")
        if not (k or i8):
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            props["stack"], props["stores"], props["loads"] = m.groups()
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            smem = re.search(r"(\d+) bytes smem", ln)
            label, r = ((f"fused_recon_{k.group(1)}_kernel<{types[k.group(2)]}, "
                         f"MULTI={k.group(3)}>", roles[k.group(1)]) if k else
                        (f"int8_bscan_ws_kernel<MULTI={i8.group(1)}>", roles["int8"]))
            former = (f", the forming warpgroup {r['FORMER_REGS']}" if r["FORMER_REGS"] else "")
            out.append(f"{label}: "
                       f"{m.group(1)} registers a thread at launch; after setmaxnreg the "
                       f"producer warpgroup {r['PRODUCER_REGS']}{former}, the consumer "
                       f"warpgroups {r['CONSUMER_REGS']}; static smem "
                       f"{smem.group(1) if smem else 0} B "
                       f"(the ring is dynamic); stack {props.get('stack')} B, spill stores "
                       f"{props.get('stores')} B, loads {props.get('loads')} B"
                       + (" (a spill: a finding)" if props.get("stores", "0") != "0" else ""))
            name, props = None, {}
    return out


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from fdoct_tpu_torch.bench_resident import card_line as card
    from fdoct_tpu_torch.calibration import Calibration
    from fdoct_tpu_torch.config import PipelineConfig
    from fdoct_tpu_torch.ops import _build, kernels
    from fdoct_tpu_torch.ops.kernels import (
        EDGE_SHAPES, LAUNCHES, fused_recon_accumulate, fused_recon_accumulate_reference,
        fused_recon_raw_accumulate, fused_recon_raw_accumulate_reference, fused_recon_resident,
        fused_recon_resident_reference,
    )
    from fdoct_tpu_torch.pipeline import apodize_ratio, form_bscan, preprocess, use_bf16
    from fdoct_tpu_torch.session import Session
    from fdoct_tpu_torch.sources.synthetic import SyntheticSource
    check("jax" not in sys.modules, "the port imported jax")

    # 1. device ---------------------------------------------------------
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = card()
    phase("device", f"{card_line} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    print(card_line, flush=True)

    # 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.library_path().with_suffix(".log").read_text()
             .splitlines() if "registers" in ln or "spill" in ln or "entry function" in ln]
    phase("build", f"{build_s:.1f} s -> {_build.library_path().name}")
    for ln in ptxas:
        phase("build", ln)
    summary = ptxas_summary(_build.library_path().with_suffix(".log").read_text())
    check(len(summary) == 14, f"ptxas reported {len(summary)} warp-specialised kernels, not 14")
    for ln in summary:
        phase("build", ln)

    # 3. kernels against their plain versions ---------------------------
    cfg = PipelineConfig(**FLAGSHIP)
    t0 = time.perf_counter()
    calib = Calibration.create(cfg, dev)
    phase("calib", f"flagship M {tuple(calib.op_re.shape)} built in "
          f"{time.perf_counter() - t0:.1f} s")
    src = SyntheticSource(height=cfg.height, width=cfg.width, lambda0=cfg.lambda0,
                          dlambda=cfg.lambdabw * 2.3548 / 4.0, noise=0.02, seed=SEED)
    frames = src.frames()
    batch = np.stack([next(frames) for _ in range(cfg.averages)])
    bg = torch.as_tensor(np.maximum(src.background(), 1)).to(dev, torch.float32)
    pi = torch.as_tensor(src.pi_frame()).to(dev, torch.float32)
    flag_in = {
        "raw": torch.as_tensor(batch).to(dev), "pi": pi, "inv": (1.0 / bg).contiguous(),
        "yr": apodize_ratio(preprocess(torch.as_tensor(batch).to(dev), cfg), bg, pi,
                            cfg.replace(donotnormalize=False)).contiguous(),
        "f32": (calib.op_re, calib.op_im), "bf16": (calib.op_re_bf16, calib.op_im_bf16),
        "tf32": calib.op_tf32,
    }
    rag_in = random_problem(RAGGED, SEED, dev)

    def run_raw(inp, op, kernel=True):
        if not kernel:
            return fused_recon_raw_accumulate_reference(inp["raw"], inp["pi"], inp["inv"],
                                                        *inp[op])
        return fused_recon_raw_accumulate(inp["raw"], inp["pi"], inp["inv"], *inp[op],
                                          **table_kw(inp, op))

    def run_yr(inp, op, kernel=True):
        if not kernel:
            return fused_recon_accumulate_reference(inp["yr"], *inp[op])
        return fused_recon_accumulate(inp["yr"], *inp[op], **table_kw(inp, op))

    def ratio32(inp, name):
        """The f32 ratio each kernel takes or forms (rounded as it forms it)."""
        if name == "fused_recon_raw_accumulate":
            return (inp["raw"].float() - inp["pi"]) * inp["inv"]
        return inp["yr"]

    runners = {"fused_recon_raw_accumulate": run_raw, "fused_recon_accumulate": run_yr}
    shares = {}                                      # (name, op) -> {shape: worst share of tol}
    f64_shares = {}                                  # name -> {shape: {reading: worst share}}
    bf16_f64 = {}                                    # the same for the bf16 instances
    errors = {}
    problems = [("flagship", flag_in), ("ragged", rag_in),
                ("resident ragged", random_problem(RESIDENT_RAGGED, SEED + 3, dev))] + [
        (f"edge {label}", random_problem(shape, SEED + 2, dev))
        for label, shape in EDGE_SHAPES.items()]

    def input_rows(inp, name):
        """The instance's input rows and, for raw frames, pi and inv_background."""
        if name == "fused_recon_raw_accumulate":
            return inp["raw"], (inp["pi"], inp["inv"])
        return inp["yr"], ()

    bit_equal = {}                                   # (name, op, shape) -> wgmma == mma.sync
    for shape_name, inp in problems:
        for name, run in runners.items():
            for op in ("f32", "bf16"):
                got = run(inp, op)
                torch.cuda.synchronize()
                want = run(inp, op, kernel=False)             # rtol = atol/max = tol
                tol = TC_TOL.get((name, op), TOL[op])
                res = compare(got, want, tol, tol * float(want.abs().max()))
                errors[(name, shape_name, op)] = res
                shares.setdefault((name, op), {})[shape_name] = res["worst_share_of_tol"]
                x, terms = input_rows(inp, name)
                sched = schedule_of(x, inp[op], *terms, table=inp["tf32"])
                phase("kernels", f"{name} {shape_name} {tuple(inp['raw'].shape)}->"
                      f"{tuple(got.shape)} op={op} schedule {sched}: max_abs_err "
                      f"{res['max_abs_err']:.3e}, worst {res['worst_share_of_tol']:.3e} of tol "
                      f"(rtol=atol/max={tol})")
                check(res["finite"] and res["worst_share_of_tol"] <= 1.0,
                      f"{name} {shape_name} {op} disagrees with its plain version")
                check(sched == "wgmma" or shape_name not in ("flagship", "resident ragged"),
                      f"{name} {shape_name} {op} takes the {sched} schedule, not wgmma")
            for op in (("f32", "bf16") if shape_name in ("flagship", "resident ragged") else ()):
                # the same values through a misaligned view: the mma.sync schedule
                x, terms = input_rows(inp, name)
                if name == "fused_recon_raw_accumulate":
                    def run_x(x, inp=inp, op=op):
                        return fused_recon_raw_accumulate(x, inp["pi"], inp["inv"], *inp[op],
                                                          **table_kw(inp, op))
                else:
                    def run_x(x, inp=inp, op=op):
                        return fused_recon_accumulate(x, *inp[op], **table_kw(inp, op))
                eq, share = bit_equal_schedules(run_x, x, inp[op], *terms, table=inp["tf32"])
                bit_equal[(name, op, shape_name)] = eq
                phase("kernels", f"{name} {shape_name} op={op}: the wgmma schedule against the "
                      f"mma.sync schedule on the same values (a misaligned view): torch.equal "
                      f"{eq}, worst {share:.3e} of F64_TOL apart")
                check(eq, f"{name} {shape_name}: the two {op} schedules differ")
            # the f32 instance and cuBLAS f32 against the float64 product, and
            # the TF32 control that the limit must reject
            x32, ops32 = ratio32(inp, name), inp["f32"]
            want = f64_product(x32, *ops32)
            atol = F64_TOL * float(want.abs().max())
            readings = {"kernel": run(inp, "f32"), "cuBLAS f32": run(inp, "f32", kernel=False),
                        "TF32 control": tf32_control(x32, *ops32)}
            got = {k: compare(v, want, F64_TOL, atol)["worst_share_of_tol"]
                   for k, v in readings.items()}
            f64_shares.setdefault(name, {})[shape_name] = got
            phase("kernels", f"{name} {shape_name} op=f32 against the float64 product: " +
                  ", ".join(f"{k} worst {v:.3e}" for k, v in got.items()) +
                  f" of tol (rtol=atol/max={F64_TOL}; the TF32 control must exceed 1)")
            check(got["kernel"] <= 1.0 and got["cuBLAS f32"] <= 1.0,
                  f"{name} {shape_name} f32 is not float32-grade against float64")
            check(got["TF32 control"] > 1.0,
                  f"{name} {shape_name}: the float64 limit passes one TF32 product")
            # the bf16 instance and cuBLAS f32 on its rounded operands against
            # the float64 product of those operands; at the flagship also the
            # chain of k16 steps with truncating sums, at 24 bits and at 23
            # (the control that the limit must reject)
            chains = ({f"chain {bits} bits": truncating_chain(x32, *inp["bf16"], bits)
                       for bits in (24, 23)} if shape_name == "flagship" else {})
            got = bf16_f64_shares(run(inp, "bf16"), run(inp, "bf16", kernel=False),
                                  bf16_f64_product(x32, *inp["bf16"]), **chains)
            bf16_f64.setdefault(name, {})[shape_name] = got
            phase("kernels", f"{name} {shape_name} op=bf16 against the float64 product of the "
                  "bf16-rounded operands: " + ", ".join(f"{k} worst {v:.3e}" for k, v in got.items())
                  + f" of tol (rtol=atol/max={BF16_F64_TOL}"
                  + ("; the 23-bit chain must exceed 1)" if chains else ")"))
            check(got["kernel"] <= 1.0 and got["cuBLAS f32"] <= 1.0,
                  f"{name} {shape_name} bf16 sums drift from the float64 product")
            check(got.get("chain 23 bits", 2.0) > 1.0,
                  f"{name} {shape_name}: the bf16 float64 limit passes a 23-bit truncating chain")

    # u8 white noise against the flagship M: kernels 1-2's bf16 instances (kernel
    # 2 on the noise's ratio) and the resident entry, in both schedules
    noise = random_problem((cfg.averages, cfg.height, cfg.width, 1), SEED + 21, dev)
    nx32, nterms, nops = ratio32(noise, "fused_recon_raw_accumulate"), (noise["pi"], noise["inv"]), \
        flag_in["bf16"]
    white = {
        "fused_recon_raw_accumulate": white_noise_phase(
            "fused_recon_raw_accumulate u8",
            lambda r: fused_recon_raw_accumulate(r, *nterms, *nops),
            lambda: fused_recon_raw_accumulate_reference(noise["raw"], *nterms, *nops),
            noise["raw"], nx32, nops, *nterms, chains=True),
        "fused_recon_accumulate": white_noise_phase(
            "fused_recon_accumulate (the u8 noise's ratio)",
            lambda r: fused_recon_accumulate(r, *nops),
            lambda: fused_recon_accumulate_reference(nx32, *nops), nx32, nx32, nops),
        "fused_recon_resident": white_noise_phase(
            "fused_recon_resident u8",
            lambda r: fused_recon_resident(r, *nterms, *nops),
            lambda: fused_recon_resident_reference(noise["raw"], *nterms, *nops),
            noise["raw"], nx32, nops, *nterms)}
    del noise, nx32, nterms

    # 4. the sessions: one per instance, counts at 0 just before each ------
    batches = [np.stack([next(frames) for _ in range(16)]) for _ in range(4)]
    sessions, launches = {}, {}
    for variant, precision, name, op, nbatches in SESSION_PATHS:
        scfg = cfg.replace(matmul_precision=precision, donotnormalize=variant == "base")
        s = captured_session(Session, scfg, variant, src, frames, calib, dev)
        kernels.reset_launches()
        results = [r for b in batches[:nbatches] for r in s.process_group(b)]
        torch.cuda.synchronize()
        ran = {k: v for k, v in LAUNCHES.items() if v}
        groups = 2 * nbatches
        check(len(results) == groups, f"{variant} {precision} gave {len(results)} B-scans")
        for r in results:
            check(r.bscandisp.dtype == np.uint8 and r.bscandisp.shape == (512, 512),
                  f"bscandisp {r.bscandisp.dtype} {r.bscandisp.shape}")
            check(bool(torch.isfinite(r.bscandb).all()), "non-finite bscandb")
        check(ran == {name: groups},
              f"{variant} {precision}: launches {ran} for {groups} groups, not {name}: {groups}")
        sessions[(variant, precision)] = s
        launches[(name, op)] = ran[name]
        phase("slice", f"{variant} '{precision}': {groups} B-scans "
              f"{results[0].bscandisp.shape} uint8 through {name} op={op}; launches this "
              f"path {ran}")

        # the last group against the plain versions + form_bscan
        last = torch.as_tensor(batches[nbatches - 1][-cfg.averages:]).to(dev)
        check(use_bf16(precision, torch.float32, dev) == (op == "bf16"),
              f"'{precision}' does not take the {op} operator on CUDA")
        ops = flag_in[op]
        if variant == "base":
            mag = fused_recon_raw_accumulate_reference(
                last, s.data_yp, (1.0 / s.data_yb).contiguous(), *ops)
        else:
            mag = fused_recon_accumulate_reference(
                apodize_ratio(preprocess(last, scfg), s.data_yb, s.data_yp, scfg), *ops)
        want = form_bscan(mag, scfg, cfg.averages, bscanthreshold=s.bscanthreshold)
        got = results[-1]
        u8_err = int(np.abs(got.bscandisp.astype(int)
                            - want.bscandisp.cpu().numpy().astype(int)).max())
        if op == "bf16":
            near = want.bscandb >= want.bscandb.max() - 40.0
            db_err = float((got.bscandb - want.bscandb).abs()[near].max())
            phase("slice", f"{variant} '{precision}' group vs plain pipeline: max |dB err| "
                  f"{db_err:.3e} on {int(near.sum())} px within 40 dB of peak (limit 2e-2); "
                  f"max uint8 diff {u8_err} (limit 1)")
            ok = db_err <= 2e-2
        else:
            tol = TOL["f32"]
            res = compare(got.bscan, want.bscan, tol, tol * float(want.bscan.abs().max()))
            x32 = ((last.float() - s.data_yp) * (1.0 / s.data_yb) if variant == "base" else
                   apodize_ratio(preprocess(last, scfg), s.data_yb, s.data_yp, scfg))
            want64 = form_bscan(f64_product(x32, *ops).float(), scfg, cfg.averages,
                                bscanthreshold=s.bscanthreshold).bscan
            res64 = compare(got.bscan, want64, F64_TOL, F64_TOL * float(want64.abs().max()))
            phase("slice", f"{variant} '{precision}' group vs plain pipeline: linear max_abs_err "
                  f"{res['max_abs_err']:.3e}, worst {res['worst_share_of_tol']:.3e} of tol "
                  f"(rtol=atol/max={tol}); vs the float64 product: worst "
                  f"{res64['worst_share_of_tol']:.3e} of tol (rtol=atol/max={F64_TOL}); max "
                  f"uint8 diff {u8_err} (limit 1)")
            ok = res["worst_share_of_tol"] <= 1.0 and res64["worst_share_of_tol"] <= 1.0
        check(ok and u8_err <= 1, f"{variant} '{precision}' slice disagrees with plain pipeline")

    # the float64 config: the plain chain on the card, no kernel launch
    calib64 = Calibration.create(cfg.replace(dtype="float64"), dev)
    f64_session_phase(cfg, calib64, src, frames, batches[0][:cfg.averages], dev)

    # 5. times --------------------------------------------------------------
    times = {}
    for name, run in runners.items():
        for op_name in ("bf16", "f32"):
            times[(name, op_name)] = t = timed_pair(lambda: run(flag_in, op_name),
                                                    lambda: run(flag_in, op_name, kernel=False))
            parent = (f" | the parent's mma.sync b2b {PARENT_B2B_MS[(name, op_name)]} ms "
                      "(PERF.md §6)")
            phase("times", f"{name} flagship op={op_name}: {describe(t)}{parent} | {card_line}")
    n_in = flag_in["yr"].shape[-1]
    stack = {"f32": flag_in["yr"].reshape(-1, n_in)}
    stack["bf16"] = stack["f32"].to(torch.bfloat16)
    products = {}
    for op_name in ("bf16", "f32"):
        cat = torch.cat(flag_in[op_name], dim=1).contiguous()
        products[op_name] = product_times(lambda: torch.matmul(stack[op_name], cat))
        phase("times", f"product {tuple(stack[op_name].shape)} @ {tuple(cat.shape)} "
              f"{op_name} (cuBLAS, TF32 off): median {products[op_name][0]:.4f} ms single, "
              f"{products[op_name][1]:.4f} ms b2b | {card_line}")
    l2_phase(flag_in, card_line)
    h2d = cuda_ms(lambda: torch.as_tensor(batches[0]).to(dev))
    mag = fused_recon_raw_accumulate(flag_in["raw"], flag_in["pi"], flag_in["inv"],
                                     *flag_in["bf16"])
    base = sessions[("base", "default")]
    display = cuda_ms(lambda: form_bscan(mag, cfg, cfg.averages,
                                         bscanthreshold=base.bscanthreshold).bscandisp.cpu())
    phase("times", f"breakdown: H2D of 16 pageable frames (16 MiB) median {h2d[0]:.4f} ms "
          f"(min {h2d[1]:.4f}, max {h2d[2]:.4f}); form_bscan + D2H of one uint8 display "
          f"median {display[0]:.4f} ms (min {display[1]:.4f}, max {display[2]:.4f}); "
          f"20 single calls, CUDA events | {card_line}")
    for (variant, precision), s in sessions.items():
        phase("times", f"Session.process_group per group, {variant} '{precision}' (8 frames "
              f"512x2048 u8 from host memory to uint8 display on host): "
              f"{describe_session(time_session(s, batches))} | {card_line}")

    int8_entry = int8_phases(cfg, calib, src, frames, card_line, dev)
    resident_entry = resident_phases(flag_in, rag_in, products["bf16"], card_line, dev)
    stream_launches = streaming_phases(cfg, calib, src, frames, card_line, dev)
    stepwise_phase(cfg, calib, calib64, sessions[("base", "default")], frames, card_line, dev)
    for key, n in [*session_state_phase(cfg, calib, src, frames, card_line, dev).items(),
                   *cli_phase(cfg, calib, card_line, dev).items(),
                   *viewer_phase(cfg, calib, src, frames, card_line, dev).items()]:
        if key == ("int8_bscan_display_fused", "s8"):
            int8_entry["launches"] += n
        else:
            launches[key] += n
    analysis_phase(cfg, calib, calib64, card_line, dev)
    mesh_launches = mesh_phase(cfg, calib, src, frames, card_line, dev)
    for key, n in mesh_launches.items():
        launches[key] += n
    u16_entries = u16_phases(cfg, calib, products, card_line, dev)
    angio_entry = angio_product_phase(card_line, dev)
    bench_phase(card_line, dev)
    for key, n in graphs_phase(cfg, calib, card_line, dev).items():
        if key == ("int8_bscan_display_fused", "s8"):
            int8_entry["launches"] += n
        else:
            launches[key] += n

    entries = []
    for name in runners:
        for op in ("bf16", "f32"):
            ins = ([flag_in["raw"], flag_in["pi"], flag_in["inv"]]
                   if name == "fused_recon_raw_accumulate" else [flag_in["yr"]])
            x = ins[0]
            flag64 = f64_shares[name]["flagship"]
            f64 = ({"f64_tol": F64_TOL,
                    "worst_share_of_f64_tol": worst_shares(
                        {k: v["kernel"] for k, v in f64_shares[name].items()}),
                    "cublas_f32_share_of_f64_tol": flag64["cuBLAS f32"],
                    "tf32_control_share_of_f64_tol": flag64["TF32 control"]}
                   if op == "f32" else {**bf16_f64_keys(bf16_f64[name]),
                                        **white_noise_keys(white[name])})
            entries.append({
                "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
                "launches": launches[(name, op)], "operator": op, "mma": MMA[(name, op)],
                "schedule": schedule_of(ins[0], flag_in[op], *ins[1:], table=flag_in["tf32"]),
                "bit_equal_to_mma_sync": all(v for (n, o, _), v in bit_equal.items()
                                             if (n, o) == (name, op)),
                "max_abs_err": errors[(name, "flagship", op)]["max_abs_err"],
                "worst_share_of_tol": worst_shares(shares[(name, op)]), **f64,
                **time_keys(times[(name, op)]),
                **bound_keys(op, 2 * x.numel() * calib.op_re.shape[1],
                             ins + list(flag_in[op]), mag),
                "library_ms": None, "product_ms": products[op][0],
                "product_ms_b2b": products[op][1]})
            if (name, op) == ("fused_recon_raw_accumulate", "bf16"):
                entries[-1]["streamed_session_launches"] = stream_launches
            if (name, op) in mesh_launches:
                entries[-1]["mesh_launches"] = mesh_launches[(name, op)]
    phase("total", f"{time.perf_counter() - t_start:.1f} s wall clock, the build included")
    resident_entry.update(white_noise_keys(white["fused_recon_resident"]))
    print(json.dumps({"kernels": entries + u16_entries + [int8_entry, resident_entry,
                                                          angio_entry]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


def f64_session_phase(cfg, calib64, src, frames, group: np.ndarray, dev: torch.device) -> None:
    """Phase 4's float64 case: a 'base' session at dtype="float64" runs one
    group on the card through the plain chain (pipeline.group_kernel_applies
    refuses a float64 operator) with no kernel launch; its B-scan is held to
    form_bscan of the float64 product written out here (rtol = atol/max
    F64_SESSION_TOL; uint8 within 1)."""
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.ops.kernels import LAUNCHES
    from fdoct_tpu_torch.pipeline import form_bscan, group_kernel_applies
    from fdoct_tpu_torch.session import Session

    cfg64 = cfg.replace(dtype="float64")
    check(calib64.op_re.dtype == torch.float64 and not group_kernel_applies(calib64.op_re.dtype),
          "a float64 config's operator is taken by the group kernels")
    s = captured_session(Session, cfg64, "base", src, frames, calib64, dev)
    kernels.reset_launches()
    got = s.process_group(group)
    torch.cuda.synchronize()
    ran = {k: v for k, v in LAUNCHES.items() if v}
    check(len(got) == 1 and ran == {}, f"float64 session: {len(got)} B-scans, launches {ran}")
    x = (torch.as_tensor(group).to(dev).double() - s.data_yp) / s.data_yb
    want = form_bscan(torch.hypot(x @ calib64.op_re, x @ calib64.op_im).sum(0), cfg64,
                      cfg.averages, bscanthreshold=s.bscanthreshold)
    res = compare(got[0].bscan, want.bscan, F64_SESSION_TOL,
                  F64_SESSION_TOL * float(want.bscan.abs().max()))
    u8_err = int(np.abs(got[0].bscandisp.astype(int)
                        - want.bscandisp.cpu().numpy().astype(int)).max())
    phase("slice", f"base dtype=float64: 1 B-scan {got[0].bscandisp.shape} uint8 through the "
          f"plain chain, launches this path {ran}; linear B-scan vs form_bscan of the float64 "
          f"product: max_abs_err {res['max_abs_err']:.3e}, worst {res['worst_share_of_tol']:.3e} "
          f"of tol (rtol=atol/max={F64_SESSION_TOL}); max uint8 diff {u8_err} (limit 1)")
    check(got[0].bscan.dtype == torch.float64 and res["finite"]
          and res["worst_share_of_tol"] <= 1.0 and u8_err <= 1,
          "the float64 session disagrees with its float64 plain chain")


def int8_phases(cfg, calib, src, frames, card_line: str, dev: torch.device) -> dict:
    """Phases 6-8: the int8-direct kernel, slice and times; returns the
    kernel's entry of the {"kernels": [...]} line."""
    from fdoct_tpu_torch.int8direct import (
        Int8DirectPlan, reconstruct_int8_direct, shift_u8_to_s8,
    )
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.ops.kernels import (
        LAUNCHES, int8_bscan_display_fused, int8_bscan_display_fused_reference,
    )
    from fdoct_tpu_torch.pipeline import form_bscan
    from fdoct_tpu_torch.session import Session

    name = "int8_bscan_display_fused"
    rtol, atol = INT8_TOL
    i8_cfg = cfg.replace(matmul_precision="int8_direct")

    # 6. the kernel against its plain version --------------------------------
    bg = np.mean([src.background().astype(np.float64) for _ in range(cfg.averages)], axis=0)
    t0 = time.perf_counter()
    plan = Int8DirectPlan.create(calib, i8_cfg, bg, src.pi_frame(), device=dev)
    phase("int8 kernels", f"flagship Int8DirectPlan.create (host float64 fold + quantize, "
          f"tables to the card) {time.perf_counter() - t0:.3f} s; host clock")
    s8 = shift_u8_to_s8(torch.as_tensor(np.stack([next(frames)
                                                  for _ in range(cfg.averages)])).to(dev))
    flag_args = [s8, plan.oq_re, plan.oq_im, plan.s_re, plan.s_im, plan.row_gain_inv,
                 plan.const_re, plan.const_im]
    rag_args = int8_random_args(RAGGED, np.random.default_rng(SEED + 1), dev)
    thresh = cfg.bscanthreshold

    def schedule8(frames_s8, packed):
        return kernels.int8_schedule(frames_s8.shape[-1], [frames_s8.data_ptr(),
                                                           packed.data_ptr()])

    flag_err = None
    for shape_name, args in (("flagship", flag_args), ("ragged", rag_args)):
        n = args[0].shape[0]
        phase("int8 kernels", f"{name} {shape_name} {tuple(args[0].shape)} takes "
              f"{schedule8(args[0], kernels.pack_int8_operator(args[1], args[2]))}")
        for with_linear in (False, True):
            got = int8_bscan_display_fused(*args, thresh, n, with_linear=with_linear)
            torch.cuda.synchronize()
            want = int8_bscan_display_fused_reference(*args, thresh, n, with_linear=with_linear)
            res = {part: compare(getattr(got, part), getattr(want, part), rtol, atol)
                   for part in ("db", "mn", "mx")}
            if with_linear:
                res["linear"] = compare(got.linear, want.linear, rtol, 0.0)
            else:
                check(got.linear is None, "linear output written with a null pointer")
            if shape_name == "flagship" and not with_linear:
                flag_err = res["db"]["max_abs_err"]
            phase("int8 kernels", f"{name} {shape_name} {tuple(got.db.shape)} linear="
                  f"{with_linear}: " + "; ".join(
                      f"{part} max_abs_err {r['max_abs_err']:.3e} worst "
                      f"{r['worst_share_of_tol']:.3e} of tol" for part, r in res.items())
                  + f" (rtol {rtol}, atol {atol}; linear atol 0)")
            check(all(r["finite"] and r["worst_share_of_tol"] <= 1.0 for r in res.values()),
                  f"{name} {shape_name} linear={with_linear} disagrees with its plain version")
    # the wgmma schedule against the mma.sync one on the same values
    bit_equal = {}
    for shape_name, args in (("flagship", flag_args),
                             ("RESIDENT_RAGGED", int8_random_args(
                                 RESIDENT_RAGGED, np.random.default_rng(SEED + 2), dev))):
        packed = kernels.pack_int8_operator(args[1], args[2])
        y = misaligned(args[0])
        check(schedule8(args[0], packed) == "wgmma", f"{shape_name}: the aligned frames do not "
              "take wgmma")
        check(schedule8(y, packed) == "mma.sync", f"{shape_name}: the misaligned view does not "
              "take mma.sync")
        n = args[0].shape[0]
        got = int8_bscan_display_fused(*args, thresh, n, with_linear=True, oq_packed=packed)
        want = int8_bscan_display_fused(y, *args[1:], thresh, n, with_linear=True,
                                        oq_packed=packed)
        torch.cuda.synchronize()
        equal = {part: bool(torch.equal(getattr(got, part), getattr(want, part)))
                 for part in got._fields}
        bit_equal[shape_name] = all(equal.values())
        phase("int8 kernels", f"{name} {shape_name} {tuple(args[0].shape)}: wgmma against "
              f"{MMA_SYNC_S8} through a misaligned view, torch.equal {equal}")
        check(bit_equal[shape_name], f"{name} {shape_name}: wgmma and mma.sync differ")

    # 7. the int8-direct slice -------------------------------------------------
    kernels.reset_launches()
    t_slice = time.perf_counter()
    i8 = Session(i8_cfg, device=dev, variant="base", calib=calib)
    i8.key("b")
    for _ in range(cfg.averages):                   # S(k) from 8 background frames
        i8.process(src.background())
    i8.key("p")
    for f in [src.pi_frame()] + [next(frames) for _ in range(cfg.averages - 1)]:
        i8.process(f)
    check(i8.indextemp == 0 and not i8._pending, "captures left the int8 session mid-group")
    batches = [np.stack([next(frames) for _ in range(16)]) for _ in range(4)]
    results = [r for b in batches for r in i8.process_group(b)]
    torch.cuda.synchronize()
    launches = LAUNCHES[name]
    slice_s = time.perf_counter() - t_slice
    plan = i8._i8plan
    check(plan is not None, "the int8 session refused its plan")
    resid = float(plan.bg_rank1_resid)
    check(len(results) == 8, f"int8 session gave {len(results)} B-scans, not 8")
    for r in results:
        check(r.bscandisp.dtype == np.uint8 and r.bscandisp.shape == (512, 512),
              f"bscandisp {r.bscandisp.dtype} {r.bscandisp.shape}")
        check(bool(torch.isfinite(r.bscandb).all()), "non-finite bscandb")
    check(launches >= 8, f"{name} launched {launches} times for 8 groups")
    phase("int8 slice", f"base int8_direct: plan rank-1 residual {resid:.3e} (gate "
          f"{Session.INT8_RESID_ACT}); 8 B-scans {results[0].bscandisp.shape} uint8 through "
          f"{name} (+{launches} launches); launches this run {dict(LAUNCHES)}; {slice_s:.2f} s")

    last = shift_u8_to_s8(torch.as_tensor(batches[-1][-cfg.averages:]).to(dev))
    plain = form_bscan(reconstruct_int8_direct(last, plan).sum(0), i8_cfg, cfg.averages,
                       bscanthreshold=i8.bscanthreshold)
    got = results[-1]
    db_res = compare(got.bscandb, plain.bscandb, rtol, atol)
    lin_res = compare(got.bscan, plain.bscan, rtol, 0.0)
    u8_err = int(np.abs(got.bscandisp.astype(int)
                        - plain.bscandisp.cpu().numpy().astype(int)).max())
    phase("int8 slice", f"group vs form_bscan(reconstruct_int8_direct(...).sum(0)): dB "
          f"max_abs_err {db_res['max_abs_err']:.3e} (worst {db_res['worst_share_of_tol']:.3e} "
          f"of rtol {rtol} + atol {atol}); linear worst {lin_res['worst_share_of_tol']:.3e} "
          f"of rtol {rtol}; max uint8 diff {u8_err} (limit 1)")
    check(db_res["worst_share_of_tol"] <= 1.0 and lin_res["worst_share_of_tol"] <= 1.0
          and u8_err <= 1, "int8 slice disagrees with its plain chain")

    bf16 = Session(cfg.replace(matmul_precision="bf16"), device=dev, variant="base",
                   calib=calib)
    bf16.data_yb, bf16.data_yp = i8.data_yb, i8.data_yp
    ref = bf16.process_group(batches[-1])[-1].bscandb
    near = ref >= ref.max() - 30.0
    db_gap = float((got.bscandb - ref).abs()[near].max())
    phase("int8 slice", f"group vs the bf16 session on the same captures: max |dB diff| "
          f"{db_gap:.4f} on {int(near.sum())} px within 30 dB of the peak (limit 0.35)")
    check(db_gap <= 0.35, "int8 display is not within 0.35 dB of the bf16 session")

    # 8. times -------------------------------------------------------------------
    packed = plan.oq_packed
    hot = timed_pair(lambda: int8_bscan_display_fused(*flag_args, thresh, cfg.averages,
                                                      oq_packed=packed),
                     lambda: int8_bscan_display_fused_reference(*flag_args, thresh,
                                                                cfg.averages))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    groups = torch.randint(-128, 128, (STREAM_GROUPS, *s8.shape), dtype=torch.int8,
                           generator=gen, device=dev)
    stream = itertools.cycle(list(groups))
    streamed = timed_pair(
        lambda: int8_bscan_display_fused(next(stream), *flag_args[1:], thresh, cfg.averages,
                                         oq_packed=packed),
        lambda: int8_bscan_display_fused_reference(next(stream), *flag_args[1:], thresh,
                                                   cfg.averages))
    del groups, stream
    phase("int8 times", f"{name} flagship, plain = torch._int_mm + torch "
          f"epilogue; hot: {describe(hot)} | {card_line}")
    phase("int8 times", f"{name} flagship streamed over {STREAM_GROUPS} groups: "
          f"{describe(streamed)} | {card_line}")
    phase("int8 times", f"int8_direct Session.process_group per group (8 frames 512x2048 u8 "
          f"from host memory to uint8 display on host): "
          f"{describe_session(time_session(i8, batches))} | {card_line}")
    x2 = s8.reshape(-1, s8.shape[-1])
    cat = torch.cat([plan.oq_re, plan.oq_im], dim=1).contiguous()
    product = product_times(lambda: torch._int_mm(x2, cat))
    phase("int8 times", f"product {tuple(x2.shape)} @ {tuple(cat.shape)} s8 (torch._int_mm): "
          f"median {product[0]:.4f} ms single, {product[1]:.4f} ms b2b | {card_line}")
    out = int8_bscan_display_fused(*flag_args, thresh, cfg.averages, oq_packed=packed)
    schedule = schedule8(s8, packed)
    bound = bound_keys("s8", 2 * s8.numel() * plan.oq_re.shape[1], [s8, packed] + flag_args[3:],
                       [out.db, out.mn, out.mx])
    dev_us = device_us(lambda: int8_bscan_display_fused(*flag_args, thresh, cfg.averages,
                                                        oq_packed=packed), name="int8_bscan")
    phase("int8 times", f"{name} flagship on {schedule}: device {dev_us:.1f} us (torch.profiler, "
          f"median of 20 calls, the int8 kernel alone), b2b hot {hot['kernel_b2b'][0]:.4f} ms, "
          f"streamed {streamed['kernel_b2b'][0]:.4f} ms, bound {bound['bound_ms']:.4f} ms "
          f"({bound['bound_by']}), _int_mm b2b {product[1]:.4f} ms | the parent's {MMA_SYNC_S8} "
          f"{PARENT_B2B_MS[name]} (PERF.md §6) | {card_line}")
    return {"name": name, "route": "cuda", "source": INT8_SOURCE, "replaces": REPLACES[name],
            "launches": launches, "operator": "s8",
            "mma": MMA[name] if schedule == "wgmma" else MMA_SYNC_S8, "schedule": schedule,
            "bit_equal_to_mma_sync": all(bit_equal.values()), "max_abs_err": flag_err,
            "device_us": dev_us, **time_keys(hot), **time_keys(streamed, "streamed_"), **bound,
            "library_ms": None, "product_ms": product[0], "product_ms_b2b": product[1]}


def int8_random_args(shape, rng: np.random.Generator, dev: torch.device) -> list[torch.Tensor]:
    """Kernel 3's positional arguments at ``shape`` (B, rows, n_in, ndisp),
    drawn from ``rng``: s8 frames and operator, scales and constants that
    make dB values of a few tens."""
    B, rows, n_in, ndisp = shape
    return [torch.as_tensor(a).to(dev) for a in (
        rng.integers(-128, 128, (B, rows, n_in)).astype(np.int8),
        rng.integers(-127, 128, (n_in, ndisp)).astype(np.int8),
        rng.integers(-127, 128, (n_in, ndisp)).astype(np.int8),
        rng.uniform(1e-4, 2e-4, ndisp).astype(np.float32),
        rng.uniform(1e-4, 2e-4, ndisp).astype(np.float32),
        rng.uniform(0.5, 2.0, (rows, 1)).astype(np.float32),
        rng.normal(0, 0.5, (rows, ndisp)).astype(np.float32),
        rng.normal(0, 0.5, (rows, ndisp)).astype(np.float32))]


def resident_phases(flag_in: dict, rag_in: dict, product: tuple, card_line: str,
                    dev: torch.device) -> dict:
    """Phases 9-10: the resident kernel against its plain version, kernel 1
    and the float64 product, its schedules and times, then the resident
    bench; returns the kernel's entry of the {"kernels": [...]} line."""
    from fdoct_tpu_torch import bench_resident
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.ops.kernels import (
        EDGE_SHAPES, LAUNCHES, WGMMA_TILE, fused_recon_raw_accumulate, fused_recon_resident,
        fused_recon_resident_reference,
    )

    name = "fused_recon_resident"
    tol = RESIDENT_TOL

    # 9. the kernel against its plain version, kernel 1 and float64 -----------
    pairs, depths = WGMMA_TILE
    phase("resident kernels", f"kernel 1 u8 bf16's schedules: blocks of {pairs} (row, frame) "
          f"pairs x {depths} depths, {MMA_BF16}; shapes TMA cannot address run "
          f"{MMA_SYNC_BF16}")
    problems = [("flagship", flag_in), ("ragged", rag_in),
                ("ragged wgmma", random_problem(RESIDENT_RAGGED, SEED + 3, dev))] + [
        (f"edge {label}", random_problem(shape, SEED + 4, dev))
        for label, shape in EDGE_SHAPES.items()]
    flag_err, shares, f64 = None, {}, {}
    for shape_name, inp in problems:
        x = (inp["raw"], inp["pi"], inp["inv"])
        sched = schedule_of(inp["raw"], inp["bf16"], inp["pi"], inp["inv"])
        check(sched == "wgmma" or shape_name not in ("flagship", "ragged wgmma"),
              f"{name} {shape_name} takes the {sched} schedule, not wgmma")
        k1 = fused_recon_raw_accumulate(*x, *inp["bf16"])
        same = bool(torch.equal(fused_recon_resident(*x, *inp["bf16"]), k1))
        phase("resident kernels", f"{name} {shape_name}: equal to kernel 1 u8 bf16 bit for bit "
              f"{same} (one schedule serves both entries)")
        check(same, f"{name} {shape_name} differs from kernel 1 u8 bf16")
        for op in ("f32", "bf16"):
            got = fused_recon_resident(*x, *inp[op])
            torch.cuda.synchronize()
            want = fused_recon_resident_reference(*x, *inp[op])
            res = {"plain": compare(got, want, tol, tol * float(want.abs().max())),
                   "kernel 1": compare(got, k1, tol, tol * float(k1.abs().max()))}
            if shape_name == "flagship" and op == "bf16":
                flag_err = res["plain"]["max_abs_err"]
            shares[(shape_name, op)] = max(r["worst_share_of_tol"] for r in res.values())
            phase("resident kernels", f"{name} {shape_name} {tuple(inp['raw'].shape)}->"
                  f"{tuple(got.shape)} schedule {sched} op={op} passed in: " +
                  "; ".join(f"vs {k} max_abs_err {r['max_abs_err']:.3e}, worst "
                            f"{r['worst_share_of_tol']:.3e} of tol" for k, r in res.items())
                  + f" (rtol=atol/max={tol})")
            check(all(r["finite"] and r["worst_share_of_tol"] <= 1.0 for r in res.values()),
                  f"{name} {shape_name} {op} disagrees with its plain version or kernel 1")
        x32 = (inp["raw"].float() - inp["pi"]) * inp["inv"]
        f64[shape_name] = got64 = bf16_f64_shares(
            fused_recon_resident(*x, *inp["bf16"]), fused_recon_resident_reference(*x, *inp["bf16"]),
            bf16_f64_product(x32, *inp["bf16"]))
        phase("resident kernels", f"{name} {shape_name} against the float64 product of the "
              "bf16-rounded operands: " + ", ".join(f"{k} worst {v:.3e}" for k, v in got64.items())
              + f" of tol (rtol=atol/max={BF16_F64_TOL})")
        check(got64["kernel"] <= 1.0 and got64["cuBLAS f32"] <= 1.0,
              f"{name} {shape_name} drifts from the float64 product")

    # times: hot and streamed, beside kernel 1 bf16 and the cuBLAS product
    x16 = (flag_in["raw"], flag_in["pi"], flag_in["inv"], *flag_in["bf16"])
    hot = timed_pair(lambda: fused_recon_resident(*x16),
                     lambda: fused_recon_resident_reference(*x16))
    k1_hot = product_times(lambda: fused_recon_raw_accumulate(*x16))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    groups = torch.randint(0, 255, (STREAM_GROUPS, *x16[0].shape), dtype=torch.uint8,
                           generator=gen, device=dev)
    stream = itertools.cycle(list(groups))
    streamed = timed_pair(lambda: fused_recon_resident(next(stream), *x16[1:]),
                          lambda: fused_recon_resident_reference(next(stream), *x16[1:]))
    k1_streamed = product_times(lambda: fused_recon_raw_accumulate(next(stream), *x16[1:]))
    del groups, stream
    phase("resident kernels", f"{name} flagship op=bf16 hot: {describe(hot)} | the earlier "
          f"resident kernel b2b {PARENT_B2B_MS[name]} ms (PERF.md §6) | {card_line}")
    phase("resident kernels", f"{name} flagship streamed over {STREAM_GROUPS} groups: "
          f"{describe(streamed)} | {card_line}")
    phase("resident kernels", f"kernel 1 bf16 on the same sum: hot median {k1_hot[0]:.4f} ms "
          f"single, {k1_hot[1]:.4f} ms b2b; streamed {k1_streamed[0]:.4f} / "
          f"{k1_streamed[1]:.4f} | {card_line}")
    phase("resident kernels", f"product {tuple(flag_in['yr'].reshape(-1, x16[0].shape[-1]).shape)}"
          f" @ (n_in x 2 ndisp) bf16 (cuBLAS): median {product[0]:.4f} ms single, "
          f"{product[1]:.4f} ms b2b | {card_line}")

    # 10. the resident bench -----------------------------------------------------
    kernels.reset_launches()
    t0 = time.perf_counter()
    rows = bench_resident.run(dev, card=card_line,
                              log=lambda s: phase("resident bench", s))
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    phase("resident bench", f"{len(rows)} rows in {time.perf_counter() - t0:.1f} s; "
          f"launches this run {launches}")
    check(launches[name] > 0, f"{name} was not launched by the resident bench")
    out = fused_recon_resident(*x16)
    return {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "operator": "bf16", "mma": MMA_BF16,
            "schedule": schedule_of(x16[0], x16[3:], *x16[1:3]),
            "max_abs_err": flag_err,
            "worst_share_of_tol": worst_shares({k: v for (k, op), v in shares.items()
                                                if op == "bf16"}),
            **bf16_f64_keys(f64), **time_keys(hot), **time_keys(streamed, "streamed_"),
            "kernel1_bf16_ms": list(k1_hot), "kernel1_bf16_streamed_ms": list(k1_streamed),
            **bound_keys("bf16", 2 * x16[0].numel() * out.shape[1], x16, out),
            "library_ms": None, "product_ms": product[0], "product_ms_b2b": product[1]}


def stamped_frames(pool: np.ndarray, n: int) -> list[np.ndarray]:
    """``n`` frames cycling through ``pool``, each a copy with its index
    written into its first four pixels, so that every frame differs; made
    before a stream, as a camera's ring holds them."""
    out = []
    for i in range(n):
        f = pool[i % len(pool)].copy()
        f[0, :4] = np.frombuffer(i.to_bytes(4, "little"), np.uint8)
        out.append(f)
    return out


def yield_timed(frames: list, yielded: list):
    """``frames`` one by one, keeping the host-clock moment each is yielded."""
    for f in frames:
        yielded.append(time.perf_counter())
        yield f


def streaming_phases(cfg, calib, src, frames, card_line: str, dev: torch.device) -> int:
    """Phase 11: a flagship 'base' 'default' session behind run_streaming
    (one averaging group per batch, lossless, the source paced at
    STREAM_FPS) for STREAM_GROUPS_RUN groups, after a stream of
    STREAM_WARMUP_GROUPS that pays the start-up: groups done, dropped (must be
    0), sustained fps, frame→display latency p50/p99 (from the moment the
    source yields a group's last frame to the moment its uint8 display is
    in host memory), exactly one kernel 1 launch per group (counts set to 0
    just before, read just after) and every display byte-equal to a direct
    process_group on the same frames and captures.  Then the profiler's
    breakdown of 16 of those groups streamed again, paced and unpaced, and
    fdoct_tpu_torch.bench_ingest at the flagship (phases 1-5).  Returns the streamed run's launch count."""
    from fdoct_tpu_torch import bench_ingest
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.ops.kernels import LAUNCHES
    from fdoct_tpu_torch.session import Session
    from fdoct_tpu_torch.streaming import run_streaming

    name = "fused_recon_raw_accumulate"
    scfg = cfg.replace(matmul_precision="default", donotnormalize=True)
    s = captured_session(Session, scfg, "base", src, frames, calib, dev)
    pool = np.stack([next(frames) for _ in range(STREAM_POOL)])
    made = stamped_frames(pool, STREAM_GROUPS_RUN * cfg.averages)
    yielded, done = [], []

    def step(batch):
        # a live viewer shows each display and lets the group's device
        # B-scans go; so does this run (holding 128 groups of them would
        # grow the device allocator under the stream)
        out = [r.bscandisp for r in s.process_group(batch)]
        done.append(time.perf_counter())
        return out

    def stream(groups: int):
        yielded.clear()
        done.clear()
        return run_streaming(yield_timed(made, yielded), step, cfg.averages, groups,
                             device=dev, rate_fps=STREAM_FPS)

    # a first stream pays the process's start-up (pinned host memory, the
    # copy stream's first device buffers): its first group is the start-up
    # latency, and the latency run that follows reads the steady state
    stream(STREAM_WARMUP_GROUPS)
    startup = (done[0] - yielded[cfg.averages - 1]) * 1e3
    kernels.reset_launches()
    results, stats = stream(STREAM_GROUPS_RUN)
    torch.cuda.synchronize()
    launches = {k: v for k, v in LAUNCHES.items() if v}
    fps_stats = stats.fps
    groups = len(results)
    check(groups == STREAM_GROUPS_RUN and all(len(r) == 1 for r in results),
          f"streamed session gave {groups} batches of {[len(r) for r in results][:4]} B-scans")
    check(stats.dropped == 0, f"the lossless stream dropped {stats.dropped} frames")
    check(launches == {name: groups}, f"streamed session: launches {launches} for {groups} groups")
    last = [yielded[cfg.averages * (g + 1) - 1] for g in range(groups)]
    lat = np.array(done[:groups]) - np.array(last)
    sustained = groups * cfg.averages / (done[groups - 1] - yielded[0])
    phase("stream", f"base 'default' behind run_streaming at {STREAM_FPS} fps, lossless, "
          f"{cfg.averages}-frame batches: {groups} groups, dropped {stats.dropped}, launches "
          f"{launches}; sustained {sustained:.1f} fps (first yield to last display; "
          f"StreamStats.fps {fps_stats:.1f}); frame->display latency p50 "
          f"{np.percentile(lat, 50) * 1e3:.3f} ms, p99 {np.percentile(lat, 99) * 1e3:.3f} ms, "
          f"max {lat.max() * 1e3:.3f} ms (host clock, yield of a group's last frame to its "
          f"uint8 display on the host, after a stream of {STREAM_WARMUP_GROUPS} groups whose "
          f"first took {startup:.3f} ms) | {card_line}")

    twin = Session(scfg, device=dev, calib=calib)
    twin.data_yb, twin.data_yp = s.data_yb, s.data_yp
    unequal = [g for g in range(groups) if not np.array_equal(
        results[g][0],
        twin.process_group(np.stack(made[cfg.averages * g:cfg.averages * (g + 1)]))[0].bscandisp)]
    phase("stream", f"{groups} streamed displays against a direct process_group on the same "
          f"frames and captures: {groups - len(unequal)} byte-equal")
    check(not unequal, f"streamed displays differ from direct process_group: groups {unequal}")

    # the same frames again, paced, then from a list as fast as the
    # producer queues them (the next batch is then queued when a step starts,
    # so its copy is issued before the step, on the side stream)
    frames_run = made[:STREAM_GROUPS_PROFILED * cfg.averages]
    for rate in (STREAM_FPS, None):
        t = device_breakdown(lambda: run_streaming(
            iter(frames_run), s.process_group, cfg.averages, STREAM_GROUPS_PROFILED, device=dev,
            rate_fps=rate), STREAM_GROUPS_PROFILED)
        phase("stream", f"{STREAM_GROUPS_PROFILED} groups streamed "
              f"{f'at {rate} fps' if rate else 'from a list, unpaced'}: "
              f"{describe_breakdown(t)} | {card_line}")

    kernels.reset_launches()
    t0 = time.perf_counter()
    bench_ingest.run(dev, card=card_line, log=lambda line: phase("bench_ingest", line))
    torch.cuda.synchronize()
    phase("bench_ingest", f"phases 1-5 in {time.perf_counter() - t0:.1f} s; launches this run "
          f"{ {k: v for k, v in LAUNCHES.items() if v} }")
    return launches[name]


def stepwise_phase(cfg, calib, calib64, captured, frames, card_line: str,
                   dev: torch.device) -> None:
    """Phase 12: one flagship 'base' group through Session(method="gather")
    and Session(method="hilbert") on the card with zero launches (counts set
    to 0 just before each, read just after), on the captures of ``captured``.
    Gather is held to the method="fused_exact" session's linear B-scan in
    float32 (rtol = atol/max TOL["f32"]) and in float64 (GATHER_F64_TOL);
    hilbert to gather on the depth of each A-scan's peak.  Then each
    method's group time (time_session)."""
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.ops.kernels import LAUNCHES
    from fdoct_tpu_torch.session import Session

    group = np.stack([next(frames) for _ in range(cfg.averages)])
    batches = [np.stack([next(frames) for _ in range(16)]) for _ in range(4)]
    sessions = {}
    for dtype, cal in (("float32", calib), ("float64", calib64)):
        scfg = cfg.replace(dtype=dtype, donotnormalize=True)
        out = {}
        for method in ("fused_exact", "gather", "hilbert"):
            s = sessions[(dtype, method)] = Session(scfg, device=dev, calib=cal, method=method)
            s.data_yb = captured.data_yb.to(getattr(torch, dtype))
            s.data_yp = captured.data_yp.to(getattr(torch, dtype))
            kernels.reset_launches()
            (out[method],) = s.process_group(group)
            torch.cuda.synchronize()
            ran = {k: v for k, v in LAUNCHES.items() if v}
            check(method == "fused_exact" or ran == {},
                  f"{method} {dtype} session launched {ran}")
            check(out[method].bscan.dtype == getattr(torch, dtype)
                  and bool(torch.isfinite(out[method].bscan).all()),
                  f"{method} {dtype}: {out[method].bscan.dtype} or non-finite")
            if method != "fused_exact":
                phase("stepwise", f"base {dtype} method={method}: 1 B-scan "
                      f"{out[method].bscandisp.shape} uint8, launches this path {ran}")
        tol = TOL["f32"] if dtype == "float32" else GATHER_F64_TOL
        want = out["fused_exact"].bscan
        res = compare(out["gather"].bscan, want, tol, tol * float(want.abs().max()))
        peaks = {m: out[m].bscan[2:].argmax(0) for m in ("gather", "hilbert")}
        same = int((peaks["gather"] == peaks["hilbert"]).sum())
        phase("stepwise", f"{dtype}: gather vs the fused_exact session, linear max_abs_err "
              f"{res['max_abs_err']:.3e}, worst {res['worst_share_of_tol']:.3e} of tol "
              f"(rtol=atol/max={tol}); hilbert's peak depth equals gather's on {same} of "
              f"{peaks['gather'].numel()} A-scans")
        check(res["finite"] and res["worst_share_of_tol"] <= 1.0,
              f"gather {dtype} disagrees with the fused_exact session")
        check(same == peaks["gather"].numel(), f"hilbert {dtype} peaks differ from gather's")
    for method in ("gather", "hilbert", "fused_exact"):
        phase("stepwise", f"Session.process_group per group, base float32 method={method} "
              f"(8 frames 512x2048 u8 from host memory to uint8 display on host): "
              f"{describe_session(time_session(sessions[('float32', method)], batches))} | "
              f"{card_line}")


def session_state_phase(cfg, calib, src, frames, card_line: str, dev: torch.device) -> dict:
    """Phase 13: the dark, peak and spinj variants and the rings, J-lockin
    and saves of a 'base' session at the flagship, each path's launch counts
    set to 0 just before its groups and read just after.  Returns the
    launches of each (kernel, operator) on these paths."""
    import tempfile

    from fdoct_tpu_torch.int8direct import reconstruct_int8_direct, shift_u8_to_s8
    from fdoct_tpu_torch.ops import kernels, normalize_minmax, to_db, to_uint8
    from fdoct_tpu_torch.ops.filters import bscan_rebin
    from fdoct_tpu_torch.ops.kernels import LAUNCHES, fused_recon_raw_accumulate_reference
    from fdoct_tpu_torch.pipeline import form_bscan
    from fdoct_tpu_torch.session import Session
    from fdoct_tpu_torch.sinks import RunWriter
    from fdoct_tpu_torch.sources.synthetic import SyntheticSource
    from fdoct_tpu_torch.utils.imageio import read_png

    avg = cfg.averages
    counts: dict = {}
    k1 = "fused_recon_raw_accumulate"
    bf16_ops = (calib.op_re_bf16, calib.op_im_bf16)

    def batches(n: int = 2) -> list:
        return [np.stack([next(frames) for _ in range(2 * avg)]) for _ in range(n)]

    def drive(s, what: str, bs: list, expect: dict, op: str) -> list:
        kernels.reset_launches()
        results = [r for b in bs for r in s.process_group(b)]
        torch.cuda.synchronize()
        ran = {k: v for k, v in LAUNCHES.items() if v}
        groups = sum(len(b) for b in bs) // avg
        check(len(results) == groups, f"{what}: {len(results)} B-scans for {groups} groups")
        for r in results:
            check(r.bscandisp.dtype == np.uint8 and r.bscandisp.shape == (calib.ndisp, cfg.oph)
                  and bool(torch.isfinite(r.bscandb).all()), f"{what}: a bad B-scan")
        check(ran == expect, f"{what}: launches {ran}, not {expect}")
        for name, n in ran.items():
            counts[(name, op)] = counts.get((name, op), 0) + n
        phase("session state", f"{what}: {groups} B-scans {results[0].bscandisp.shape} uint8; "
              f"launches this path {ran} ({ {k: v / groups for k, v in ran.items()} } per group)")
        return results

    def bf16_check(what: str, got, want) -> None:
        near = want.bscandb >= want.bscandb.max() - 40.0
        db_err = float((got.bscandb - want.bscandb).abs()[near].max())
        u8_err = int(np.abs(got.bscandisp.astype(int)
                            - want.bscandisp.cpu().numpy().astype(int)).max())
        phase("session state", f"{what}: last group vs its plain chain: max |dB err| "
              f"{db_err:.3e} on {int(near.sum())} px within 40 dB of peak (limit "
              f"{TOL['bf16']}); max uint8 diff {u8_err} (limit 1)")
        check(db_err <= TOL["bf16"] and u8_err <= 1, f"{what} disagrees with its plain chain")

    def timed(what: str, s, bs: list) -> None:
        phase("session state", f"Session.process_group per group, {what} (8 frames 512x2048 "
              f"u8 from host memory to uint8 display on host): "
              f"{describe_session(time_session(s, bs))} | {card_line}")

    def dark_session(precision: str):
        s = Session(cfg.replace(matmul_precision=precision, donotnormalize=True), device=dev,
                    variant="dark", calib=calib)
        # a dark frame of 1/16 of the source spectrum, the two arms the spectrum
        arms = (("o", lambda: src.background() // 16), ("r", src.background),
                ("t", src.background))
        for key, make in arms:
            s.key(key)
            for _ in range(avg):
                s.process(make())
        check(not s._pending and s.indextemp == 0 and float(s.data_yd.max()) > 0,
              f"dark '{precision}': the o/r/t captures did not complete")
        return s

    # 'dark' 'default': kernel 1 with pi = yp + yd -----------------------------
    s = dark_session("default")
    bs = batches()
    res = drive(s, "dark 'default' (kernel 1 bf16, dark frame folded into pi)", bs,
                {k1: 2 * len(bs)}, "bf16")
    last = torch.as_tensor(bs[-1][-avg:]).to(dev)
    mag = fused_recon_raw_accumulate_reference(last, (s.data_yp + s.data_yd).contiguous(),
                                               (1.0 / s.data_yb).contiguous(), *bf16_ops)
    bf16_check("dark 'default'", res[-1], form_bscan(mag, s.cfg, avg,
                                                     bscanthreshold=s.bscanthreshold))
    timed("dark 'default'", s, bs)

    # 'dark' 'int8_direct': kernel 3 on the plan that folds the dark frame ----
    s = dark_session("int8_direct")
    bs = batches()
    res = drive(s, "dark 'int8_direct' (kernel 3)", bs,
                {"int8_bscan_display_fused": 2 * len(bs)}, "s8")
    plan = s._i8plan
    plain = form_bscan(reconstruct_int8_direct(shift_u8_to_s8(torch.as_tensor(
        bs[-1][-avg:]).to(dev)), plan).sum(0), s.cfg, avg, bscanthreshold=s.bscanthreshold)
    rtol, atol = INT8_TOL
    db_res = compare(res[-1].bscandb, plain.bscandb, rtol, atol)
    u8_err = int(np.abs(res[-1].bscandisp.astype(int)
                        - plain.bscandisp.cpu().numpy().astype(int)).max())
    phase("session state", f"dark 'int8_direct': plan rank-1 residual "
          f"{float(plan.bg_rank1_resid):.3e}; last group vs "
          f"form_bscan(reconstruct_int8_direct(...).sum(0)): dB worst "
          f"{db_res['worst_share_of_tol']:.3e} of rtol {rtol} + atol {atol}; max uint8 diff "
          f"{u8_err} (limit 1)")
    check(db_res["worst_share_of_tol"] <= 1.0 and u8_err <= 1,
          "dark int8_direct disagrees with its plain chain")
    timed("dark 'int8_direct'", s, bs)

    # 'peak' 'highest': kernel 1 f32, three vibrometry holds -------------------
    pcfg = cfg.replace(matmul_precision="highest", donotnormalize=True,
                       peakholdnumframes=PEAK_HOLD)
    s = captured_session(Session, pcfg, "peak", src, frames, calib, dev)
    s.set_roi(cfg.oph * 3 // 16, 8, 16, calib.ndisp)          # lateral 96-111, depths from 8
    s.ascanat = cfg.oph * 3 // 16 + 4
    vib = SyntheticSource(height=cfg.height, width=cfg.width, lambda0=cfg.lambda0,
                          dlambda=cfg.lambdabw * 2.3548 / 4.0, noise=0.02, seed=SEED + 5,
                          vibration_amp_nm=VIB_NM).frames()
    plugin = s.plugins[0]
    kernels.reset_launches()
    groups = 0
    for key, it in (("1", frames), ("2", frames), ("3", vib)):
        s.key(key)
        while plugin.active_hold is not None:
            groups += len(s.process_group(np.stack([next(it) for _ in range(avg)])))
    torch.cuda.synchronize()
    ran = {k: v for k, v in LAUNCHES.items() if v}
    check(ran == {k1: groups}, f"peak 'highest': launches {ran} for {groups} groups")
    counts[(k1, "f32")] = counts.get((k1, "f32"), 0) + groups
    finite = (plugin.dispnm is not None and np.isfinite(plugin.dispnm)
              and bool(np.isfinite(plugin.profile).all()))
    phase("session state", f"peak 'highest' (kernel 1 f32): three holds of {PEAK_HOLD} "
          f"B-scans, {groups} groups, launches this path {ran}, none of kernel 3; displacement "
          f"{plugin.dispnm} +- {plugin.errnm} nm (source {VIB_NM} nm), profile "
          f"{np.round(plugin.profile, 2).tolist()} nm")
    check(finite, "peak: the three holds gave no finite displacement")
    staged = torch.as_tensor(np.stack([next(frames) for _ in range(avg)])).to(dev)
    sched = schedule_of(staged, (calib.op_re, calib.op_im), s.data_yp,
                        (1.0 / s.data_yb).contiguous(), table=calib.op_tf32)
    phase("session state", f"peak 'highest': kernel 1 f32 takes the {sched} schedule on the "
          f"Calibration's TF32 table {tuple(calib.op_tf32.shape)}")
    check(sched == "wgmma", f"peak 'highest' takes the {sched} schedule, not wgmma")
    timed("peak 'highest'", s, batches())

    # 'base' 'default' with the rings, J-lockin and a sink ---------------------
    with tempfile.TemporaryDirectory() as tmp:
        fcfg = cfg.replace(matmul_precision="default", donotnormalize=True, saveframes=True,
                           saveinterferograms=True)
        sink = RunWriter(tmp, "chip_smoke", fmt="npz")
        s = captured_session(Session, fcfg, "base", src, frames, calib, dev, sink=sink)
        s.key("j")
        s.process_group(np.stack([next(frames) for _ in range(avg)]))
        check(s.jlockin and s.jscansave is not None, "'j' did not start J-lockin")
        bs = batches()
        res = drive(s, "base 'default' + saveframes + saveinterferograms + J-lockin + RunWriter "
                    "(kernel 1 bf16, B = 1 per frame)", bs, {k1: avg * 2 * len(bs)}, "bf16")
        check(all(r.sub_disp is not None and r.sub_disp.dtype == np.uint8 for r in res),
              "a J-lockin group without its subtracted display")
        held = bs[-1][-avg:]                     # the group the inactive ring holds
        s.key("s")
        (saved,) = s.process_group(np.stack([next(frames) for _ in range(avg)]))
        s.close()
        d = sink.dir
        names = {p.name for p in d.iterdir()}
        want = ({"bscan001.png", "bscanc001.png", "BscanFFT.npz"}
                | {f"{p}-{i:03d}.png" for p in ("rawframe001", "bscan001", "rawframeb000")
                   for i in range(avg)}
                | {f"bscansub{c}{m:03d}.png" for c in ("", "c")
                   for m in range(1, s.manualindexi + 1)})
        check(names == want, f"the 's' save wrote {sorted(names ^ want)} beyond or short of "
              "what the JAX session names")
        with np.load(d / "BscanFFT.npz") as npz:
            keys = set(npz.files)
        check(keys == {"bscan001", "jscan001"} | {f"bscansub{m:03d}"
                                                  for m in range(1, s.manualindexi + 1)},
              f"BscanFFT.npz holds {sorted(keys)}")
        check(np.array_equal(read_png(d / "bscan001.png"), saved.bscandisp)
              and np.array_equal(read_png(d / f"bscansub{s.manualindexi:03d}.png"),
                                 saved.sub_disp), "saved PNGs differ from the displays")
        check(all(np.array_equal(read_png(d / f"rawframe001-{i:03d}.png"), held[i])
                  for i in range(avg)), "saved raw frames differ from the source's")
        one = fused_recon_raw_accumulate_reference(
            torch.as_tensor(held[:1]).to(dev), s.data_yp, (1.0 / s.data_yb).contiguous(),
            *bf16_ops)
        frame_disp = to_uint8(normalize_minmax(to_db(one.T + 1e-6, eps=0.0, compat=cfg.compat),
                                               0.0, 1.0)).cpu().numpy()
        u8_err = int(np.abs(read_png(d / "bscan001-000.png").astype(int)
                            - frame_disp.astype(int)).max())
        phase("session state", f"'s' save: {len(names)} files as the JAX session names them "
              f"(bscan001, JET, {avg} rawframe001-*, {avg} bscan001-*, {avg} rawframeb000-* "
              f"of the 'b' capture from the ring, {s.manualindexi} "
              f"bscansub* + JET, BscanFFT.npz); bscan001.png and the last bscansub PNG equal the "
              f"displays, rawframe001-* the source's frames; bscan001-000.png vs the plain "
              f"chain's per-frame display: max uint8 diff {u8_err} (limit 1)")
        check(u8_err <= 1, "the saved per-frame B-scan differs from its plain chain")
        timed("base 'default' + saveframes + saveinterferograms + J-lockin + RunWriter", s, bs)

    # 'spinj' with bscanbinx = 2: the per-frame path ---------------------------
    scfg = cfg.replace(matmul_precision="default", donotnormalize=True, bscanbinx=2)
    s = captured_session(Session, scfg, "spinj", src, frames, calib, dev)
    bs = batches(1)
    res = drive(s, "spinj 'default' bscanbinx=2 (per-frame: kernel 1 bf16, B = 1 per frame)",
                bs, {k1: 2 * avg}, "bf16")
    check(any("output B-scan rebinning" in m for m in s.status), "spinj rebinning batched")
    mag = fused_recon_raw_accumulate_reference(torch.as_tensor(bs[-1][-avg:]).to(dev), s.data_yp,
                                               (1.0 / s.data_yb).contiguous(), *bf16_ops)
    mult = scfg.bscanbinx * scfg.bscanbiny * scfg.binvaluex * scfg.binvaluey
    lin = bscan_rebin(mag.T / avg, scfg.bscanbinx, scfg.bscanbiny, mult)
    bf16_check("spinj bscanbinx=2", res[-1], form_bscan(lin.T * avg, scfg, avg,
                                                         bscanthreshold=s.bscanthreshold))
    timed("spinj 'default' bscanbinx=2", s, bs)
    return counts


def run_cli(argv: list[str], expect: dict, what: str) -> tuple[str, float]:
    """``fdoct_tpu_torch.cli.main(argv)`` with the launch counts set to 0
    just before and read just after: exit status 0 and exactly the launches
    ``expect``.  Returns its stdout and wall seconds."""
    import contextlib
    import io

    from fdoct_tpu_torch.cli import main as cli_main
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.ops.kernels import LAUNCHES

    out = io.StringIO()
    kernels.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ran = {k: v for k, v in LAUNCHES.items() if v}
    text = out.getvalue()
    phase("cli", f"{what}: exit {rc} in {secs:.2f} s (host clock), launches {ran}; stdout: "
          + " | ".join(ln for ln in text.splitlines() if ln.strip())[:600])
    check(rc == 0, f"{what} exited {rc}")
    check(ran == expect, f"{what}: launches {ran}, not {expect}")
    return text, secs


def cli_phase(cfg, calib, card_line: str, dev: torch.device) -> dict:
    """Phase 14: the command line on the card, then the C-scan's numbers.
    Returns the launches of each (kernel, operator) on its paths."""
    import shutil
    import tempfile

    from fdoct_tpu_torch.autofocus import sweep_volume, sweep_volume_2d
    from fdoct_tpu_torch.calibration import Calibration
    from fdoct_tpu_torch.int8direct import Int8DirectPlan
    from fdoct_tpu_torch.parallel import sharded_cscan_volume, sharded_cscan_volume_int8
    from fdoct_tpu_torch.pipeline import preprocess
    from fdoct_tpu_torch.sources.synthetic import SyntheticSource
    from fdoct_tpu_torch.utils.imageio import read_png

    k1, k2, k3 = "fused_recon_raw_accumulate", "fused_recon_accumulate", "int8_bscan_display_fused"
    counts: dict = {}

    def add(key, n):
        counts[key] = counts.get(key, 0) + n

    text, _ = run_cli(["selftest"], {}, "selftest")
    check("selftest PASSED" in text and "[--] single device" in text, "selftest did not pass")
    groups = 8
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg_path = tmp / "flagship.json"
        cfg_path.write_text(cfg.replace(dirdescr="chip_smoke").to_json())
        base = ["--config", str(cfg_path)]
        for precision, op in (("default", "bf16"), ("highest", "f32"), ("int8_direct", "bf16")):
            out = tmp / f"sim_{precision}"
            frames = groups * cfg.averages
            run_cli(["sim", *base, "--outdir", str(out), "--frames", str(groups), "--format",
                     "npz", "--precision", precision], {k2: frames},
                    f"sim --frames {groups} --precision {precision} (kernel 2 op={op}, per frame)")
            add((k2, op), frames)
            (run,) = out.iterdir()
            with np.load(run / "BscanFFT.npz") as npz:
                keys = set(npz.files)
                db = npz["bscan008"]
            check(keys == {f"bscan{i:03d}" for i in range(1, groups + 1)}
                  and db.shape == (calib.ndisp, cfg.oph) and bool(np.isfinite(db).all()),
                  f"sim {precision}: BscanFFT.npz holds {sorted(keys)}")
            png = read_png(run / "bscan008.png")
            check(png.shape == (calib.ndisp, cfg.oph) and png.max() > 128,
                  f"sim {precision}: bscan008.png {png.shape}, max {png.max()}")
        for precision, name, op in (("default", k1, "bf16"), ("highest", k1, "f32"),
                                    ("int8_direct", k3, "s8")):
            text, _ = run_cli(["live", *base, "--outdir", str(tmp / "live"), "--frames", "64",
                               "--batch", "8", "--precision", precision], {name: groups},
                              f"live --frames 64 --batch 8 --precision {precision} "
                              f"({name} op={op}, one launch per group)")
            check("processed 64 frames" in text, f"live {precision}: {text}")
            add((name, op), groups)
        ck = tmp / "sess.npz"
        run_cli(["live", *base, "--outdir", str(tmp / "live"), "--frames", "16", "--batch", "8",
                 "--checkpoint", str(ck)], {k1: 2}, "live --checkpoint (kernel 1 bf16)")
        check(ck.exists(), "live --checkpoint wrote no checkpoint")
        text, _ = run_cli(["live", *base, "--outdir", str(tmp / "live"), "--frames", "16",
                           "--batch", "8", "--resume", str(ck)], {k1: 2},
                          "live --resume (kernel 1 bf16)")
        add((k1, "bf16"), 4)
        check("processed 16 frames" in text, f"live --resume: {text}")
        walls = {}
        for precision in ("default", "int8_direct"):
            out = tmp / f"cscan_{precision}"
            torch.cuda.reset_peak_memory_stats()
            text, walls[precision] = run_cli(
                ["cscan", *base, "--outdir", str(out), "--frames", str(CSCAN_FRAMES),
                 "--dispersion-sweep", "--precision", precision], {},
                f"cscan --frames {CSCAN_FRAMES} --dispersion-sweep --precision {precision}")
            peak_cli = torch.cuda.max_memory_allocated()
            (run,) = out.iterdir()
            with np.load(run / "BscanFFT.npz") as npz:
                vol_shape, surf_shape = npz["cscan"].shape, npz["surface"].shape
                finite = bool(np.isfinite(npz["cscan"][::64]).all())
            check(vol_shape == (CSCAN_FRAMES, calib.ndisp, cfg.oph)
                  and surf_shape == (CSCAN_FRAMES, cfg.oph) and finite
                  and "dispersion sweep: a2 = " in text
                  and all((run / n).exists() for n in ("enface_mip.png", "surface_map.png",
                                                        "cscan_frame000.png")),
                  f"cscan {precision}: volume {vol_shape}, surface {surf_shape}")
            phase("cli", f"cscan {precision}: volume {vol_shape} float32 in cscan.npz, surface "
                  f"{surf_shape}; peak device memory of the whole command "
                  f"{peak_cli / 2**30:.3f} GiB | {card_line}")
            shutil.rmtree(run)                        # 512 MiB of volume on the disk
        text, _ = run_cli(["sweep", *base, "--joint", "--out", str(tmp / "focused.png")], {},
                          "sweep --joint")
        check("best a2 = " in text and (tmp / "focused.png").exists(), "sweep --joint")

    # the C-scan's numbers: the CLI's source alone, the volume on the card
    clean = SyntheticSource(height=cfg.height, width=cfg.width, lambda0=cfg.lambda0,
                            dlambda=cfg.lambdabw * 2.3548 / 4.0)
    it = clean.frames()
    t0 = time.perf_counter()
    volume_raw = np.stack([next(it) for _ in range(CSCAN_FRAMES)])
    source_s = time.perf_counter() - t0
    phase("cli", f"cscan wall seconds (frames from the synthetic source in host memory to "
          f"cscan.npz, host clock): default {walls['default']:.2f}, int8_direct "
          f"{walls['int8_direct']:.2f}; of which the synthetic source's {CSCAN_FRAMES} frames "
          f"alone take {source_s:.2f} s | {card_line}")
    fr = torch.as_tensor(volume_raw).to(dev)
    bg = torch.clamp_min(preprocess(torch.as_tensor(clean.background()).to(dev), cfg), 1.0)
    pi = torch.zeros_like(bg)
    c8 = cfg.replace(matmul_precision="int8_direct")
    plan = Int8DirectPlan.create(calib, c8, bg, pi, device=dev)
    macs = 2 * CSCAN_FRAMES * cfg.oph * cfg.opw * calib.ndisp
    nbytes = fr.numel() + 4 * CSCAN_FRAMES * calib.ndisp * cfg.oph     # u8 in, f32 volume out
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    routes = {"default": (lambda: sharded_cscan_volume(fr, bg, pi, calib, cfg), "bf16"),
              "int8_direct": (lambda: sharded_cscan_volume_int8(fr, plan, c8), "s8")}
    for precision, (fn, op) in routes.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        vol = fn()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        check(tuple(vol.shape) == (CSCAN_FRAMES, calib.ndisp, cfg.oph)
              and bool(torch.isfinite(vol).all()), f"volume {precision}")
        del vol
        med, lo, hi = cuda_ms(fn, runs=5, warmup=1)
        bound = {o: 2 * macs / peak_ops * 1e3
                 for o, peak_ops in (("bf16", PEAK["bf16"]), ("s8", PEAK["s8"]),
                                     ("f32", F32_SIMT_PEAK))}
        phase("cli", f"volume {precision} F={CSCAN_FRAMES} ({'torch.matmul f32 on bf16-rounded '
              'operands' if op == 'bf16' else 'two _int_mm s8 products'}): device median "
              f"{med:.3f} ms (min {lo:.3f}, max {hi:.3f}; 5 calls, CUDA events, frames on the "
              f"card), {CSCAN_FRAMES / med * 1e3:.1f} frames/s, peak device memory "
              f"{peak / 2**30:.3f} GiB above the frames; bound {macs / 1e12:.3f} T multiply-adds: "
              f"{bound['bf16']:.3f} ms at the bf16 peak, {bound['s8']:.3f} ms at the s8 peak, "
              f"{bound['f32']:.3f} ms as f32 outside the tensor cores ({F32_SIMT_PEAK / 1e12:.0f} "
              f"TFLOP/s); bytes {bytes_ms:.3f} ms | {card_line}")

    # the card's volume of 16 noisy frames against the port's float64 volume
    noisy = SyntheticSource(height=cfg.height, width=cfg.width, lambda0=cfg.lambda0,
                            dlambda=cfg.lambdabw * 2.3548 / 4.0, noise=0.02, seed=SEED + 7)
    it = noisy.frames()
    f16 = torch.as_tensor(np.stack([next(it) for _ in range(16)])).to(dev)
    bgn = torch.clamp_min(preprocess(torch.as_tensor(noisy.background()).to(dev), cfg), 1.0)
    cfg64 = cfg.replace(dtype="float64")
    want = sharded_cscan_volume(f16, bgn.double(), torch.zeros_like(bgn).double(),
                                Calibration.create(cfg64, dev), cfg64)
    atol = CSCAN_TOL * float(want.abs().max())
    got = {"default": sharded_cscan_volume(f16, bgn, torch.zeros_like(bgn), calib, cfg),
           "int8_direct": sharded_cscan_volume_int8(
               f16, Int8DirectPlan.create(calib, c8, bgn, torch.zeros_like(bgn), device=dev), c8)}
    for precision, vol in got.items():
        res = compare(vol, want, 0.0, atol)
        phase("cli", f"volume {precision} of 16 noisy frames vs the float64 volume on the card: "
              f"max_abs_err {res['max_abs_err']:.3e} = {res['max_abs_err'] / atol * CSCAN_TOL:.3e} "
              f"of the peak, worst {res['worst_share_of_tol']:.3e} of tol (atol {CSCAN_TOL} of "
              f"the peak)")
        check(res["finite"] and res["worst_share_of_tol"] <= 1.0,
              f"the {precision} volume disagrees with float64")

    # the dispersion sweeps
    grid = torch.linspace(-8.0, 8.0, 33, dtype=torch.float64)
    a3 = torch.linspace(-3.0, 3.0, 16, dtype=torch.float64)
    one = fr[:1]
    sweep = cuda_ms(lambda: sweep_volume(one, bg, pi, calib, cfg, grid), runs=10, warmup=2)
    joint = cuda_ms(lambda: sweep_volume_2d(one, bg, pi, calib, cfg, grid, a3), runs=10, warmup=2)
    phase("cli", f"dispersion sweep, 33 candidates on 32 rows (one batched IFFT, scores and "
          f"winner to the host): median {sweep[0]:.3f} ms (min {sweep[1]:.3f}); joint 33 x 16: "
          f"median {joint[0]:.3f} ms (min {joint[1]:.3f}); 10 calls, CUDA events | {card_line}")
    return counts


def http_request(port: int, path: str, body: bytes | None = None) -> tuple[int, bytes]:
    """(status, body) of GET ``path`` (or POST ``body``) on the local viewer."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="GET" if body is None else "POST")
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def mesh_phase(cfg, calib, src, frames, card_line: str, dev: torch.device) -> dict:
    """Phase 16, the device mesh on a world of one with nccl (a 1 x 1 mesh):
    the sharded step and an 8-group Session(mesh=) of each kernel path
    against the single-device session on the same captures, int8_direct, the
    F = 512 volume, `live`/`cscan --mesh 1x1` and the dry run.  Returns the
    launches of each (kernel, operator) on the mesh paths."""
    import tempfile

    import torch.distributed as dist

    from fdoct_tpu_torch.int8direct import Int8DirectPlan
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.ops.kernels import LAUNCHES
    from fdoct_tpu_torch.parallel import (
        WorldOfOne, gather_rows, make_mesh, shard_frames, sharded_bscan_step,
        sharded_cscan_volume, sharded_cscan_volume_int8,
    )
    from fdoct_tpu_torch.parallel.distributed import backend_for
    from fdoct_tpu_torch.parallel.dryrun import dryrun_multichip
    from fdoct_tpu_torch.parallel.mesh import COLLECTIVE_BYTES, reset_collective_bytes
    from fdoct_tpu_torch.pipeline import preprocess
    from fdoct_tpu_torch.session import Session
    from fdoct_tpu_torch.sources.synthetic import SyntheticSource

    k1, k2, k3 = "fused_recon_raw_accumulate", "fused_recon_accumulate", "int8_bscan_display_fused"
    counts: dict = {}
    batches = [np.stack([next(frames) for _ in range(16)]) for _ in range(4)]
    groups = 2 * len(batches)
    paths = [("base", "default", 0, k1, "bf16"), ("base", "highest", 0, k1, "f32"),
             ("sim", "default", 0, k2, "bf16"), ("base", "default", 3, k2, "bf16")]
    with WorldOfOne("cuda"):
        mesh = make_mesh(1, 1, device_type="cuda")
        check(dist.get_backend() == backend_for(dev.type),
              f"the mesh runs {dist.get_backend()}, not {backend_for(dev.type)}")
        phase("mesh", f"world of one: backend {dist.get_backend()}, mesh "
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} on {dev} | {card_line}")
        for variant, precision, mediann, name, op in paths:
            what = f"{variant} '{precision}'" + (f" mediann={mediann}" if mediann else "")
            scfg = cfg.replace(matmul_precision=precision, donotnormalize=variant == "base",
                               mediann=mediann)
            single = captured_session(Session, scfg, variant, src, frames, calib, dev)
            meshed = Session(scfg, device=dev, variant=variant, calib=calib,
                             source=src if variant == "sim" else None, mesh=mesh)
            meshed.data_yb, meshed.data_yp = single.data_yb, single.data_yp
            # the offline sharded step on one group, counts at 0 around it
            kernels.reset_launches()
            reset_collective_bytes()
            db, _ = sharded_bscan_step(shard_frames(batches[0][:cfg.averages], mesh),
                                       single.data_yb, single.data_yp, calib, scfg, mesh)
            torch.cuda.synchronize()
            ran_step = {k: v for k, v in LAUNCHES.items() if v}
            step_bytes = dict(COLLECTIVE_BYTES)
            check(ran_step == {name: 1}, f"mesh step {what}: launches {ran_step}")
            # the 8-group mesh session, counts at 0 just before, read just after
            kernels.reset_launches()
            got = [r for b in batches for r in meshed.process_group(b)]
            torch.cuda.synchronize()
            ran = {k: v for k, v in LAUNCHES.items() if v}
            check(ran == {name: groups}, f"mesh session {what}: launches {ran}, not "
                  f"{name}: {groups}")
            counts[(name, op)] = counts.get((name, op), 0) + ran[name] + ran_step[name]
            want = [r for b in batches for r in single.process_group(b)]
            check(len(got) == len(want) == groups, f"mesh session {what}: {len(got)} B-scans")
            u8 = np.stack([np.abs(a.bscandisp.astype(int) - b.bscandisp.astype(int))
                           for a, b in zip(got, want)])
            db_err = max(float((a.bscandb - b.bscandb).abs().max()) for a, b in zip(got, want))
            step_err = float((gather_rows(db, mesh) - want[0].bscandb).abs().max())
            phase("mesh", f"{what}: sharded_bscan_step launches {ran_step}, collective bytes "
                  f"{step_bytes}, dB vs the single-device group {step_err:.3e}; Session(mesh=) "
                  f"{groups} groups: launches {ran} ({name} op={op}); vs the single-device "
                  f"session: max uint8 diff {int(u8.max())} (limit 1), {int((u8 > 0).sum())} "
                  f"pixels differ (0 expected), max |dB diff| {db_err:.3e} (limit 1e-4)")
            check(not any(k.startswith(("mesh:", "slow:")) for k in meshed._said_once),
                  f"mesh session {what} fell back: {meshed.status}")
            check(int(u8.max()) <= 1 and db_err <= 1e-4 and step_err <= 1e-4,
                  f"mesh session {what} disagrees with the single-device session")
            if (variant, precision, mediann) == ("base", "default", 0):
                ms = {"single": [], "mesh": []}
                for who in ("single", "mesh", "mesh", "single"):
                    ms[who] += host_group_ms(single if who == "single" else meshed, batches)
                t = time_session(meshed, batches)
                phase("mesh", f"group time, {what}, turns P C C P (P single-device, C mesh; "
                      f"{2 * SESSION_CALLS} calls of 2 groups each, host clock): single median "
                      f"{statistics.median(ms['single']):.3f} ms (min {min(ms['single']):.3f}), "
                      f"mesh median {statistics.median(ms['mesh']):.3f} ms (min "
                      f"{min(ms['mesh']):.3f}); mesh profiled: {describe_breakdown(t)} | "
                      f"{card_line}")
            meshed.close()                   # its graphs go before the world's communicators

        # int8_direct on the mesh: JAX's two s8 products and the tail, no kernel 3
        i8cfg = cfg.replace(matmul_precision="int8_direct", donotnormalize=True)
        single = captured_session(Session, i8cfg, "base", src, frames, calib, dev)
        meshed = Session(i8cfg, device=dev, calib=calib, mesh=mesh)
        meshed.data_yb, meshed.data_yp = single.data_yb, single.data_yp
        kernels.reset_launches()
        got = [r for b in batches for r in meshed.process_group(b)]
        torch.cuda.synchronize()
        ran = {k: v for k, v in LAUNCHES.items() if v}
        want = [r for b in batches for r in single.process_group(b)]
        u8 = max(int(np.abs(a.bscandisp.astype(int) - b.bscandisp.astype(int)).max())
                 for a, b in zip(got, want))
        db_share = max(float(((a.bscandb - b.bscandb).abs()
                              / (1e-5 * b.bscandb.abs() + 1e-4)).max()) for a, b in zip(got, want))
        phase("mesh", f"base 'int8_direct' on the mesh: {len(got)} B-scans, launches {ran} "
              f"(kernel 3: {ran.get(k3, 0)}; the s8 products are torch._int_mm); vs the "
              f"single-device session (kernel 3): max uint8 diff {u8} (limit 1), dB worst "
              f"{db_share:.3e} of tol (rtol 1e-5, atol 1e-4)")
        check(ran == {} and u8 <= 1 and db_share <= 1.0, "mesh int8_direct session")
        meshed.close()
        for key, n in mesh_graph_phase(cfg, calib, mesh, card_line, dev).items():
            counts[key] = counts.get(key, 0) + n

        # the F = 512 volume on the mesh beside the single-device volume
        clean = SyntheticSource(height=cfg.height, width=cfg.width, lambda0=cfg.lambda0,
                                dlambda=cfg.lambdabw * 2.3548 / 4.0)
        it = clean.frames()
        volume_raw = np.stack([next(it) for _ in range(CSCAN_FRAMES)])
        fr = torch.as_tensor(volume_raw).to(dev)
        block = shard_frames(volume_raw, mesh)
        bg = torch.clamp_min(preprocess(torch.as_tensor(clean.background()).to(dev), cfg), 1.0)
        pi = torch.zeros_like(bg)
        c8 = cfg.replace(matmul_precision="int8_direct")
        plan = Int8DirectPlan.create(calib, c8, bg, pi, device=dev)
        routes = {"default": (lambda: sharded_cscan_volume(fr, bg, pi, calib, cfg),
                              lambda: sharded_cscan_volume(block, bg, pi, calib, cfg, mesh,
                                                           gather_full=True)),
                  "int8_direct": (lambda: sharded_cscan_volume_int8(fr, plan, c8),
                                  lambda: sharded_cscan_volume_int8(block, plan, c8, mesh,
                                                                    gather_full=True))}
        for precision, (one, meshed_vol) in routes.items():
            peaks, vols = {}, {}
            for who, fn in (("single", one), ("mesh", meshed_vol)):
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                before = torch.cuda.memory_allocated()
                vols[who] = fn()
                torch.cuda.synchronize()
                peaks[who] = (torch.cuda.max_memory_allocated() - before) / 2**30
            err = float((vols["mesh"] - vols["single"]).abs().max()
                        / vols["single"].abs().max())
            del vols
            kernels.reset_launches()
            t = {"single": [], "mesh": []}
            for who in ("single", "mesh", "mesh", "single"):
                t[who].append(cuda_ms(one if who == "single" else meshed_vol, runs=5,
                                      warmup=1)[0])
            check(not any(LAUNCHES.values()), f"volume {precision}: launches {dict(LAUNCHES)}")
            enqueue = {"single": host_enqueue_ms(one), "mesh": host_enqueue_ms(meshed_vol)}
            phase("mesh", f"volume {precision}: host ms to enqueue one volume's launches (the "
                  f"device idle before, median of 5) single {enqueue['single']:.3f}, mesh "
                  f"{enqueue['mesh']:.3f}: "
                  f"{enqueue['single'] / statistics.median(t['single']):.4f} and "
                  f"{enqueue['mesh'] / statistics.median(t['mesh']):.4f} of the device median "
                  f"| {card_line}")
            phase("mesh", f"volume {precision} F={CSCAN_FRAMES} on the mesh (gather_full) vs "
                  f"mesh=None, turns P C C P: device median single "
                  f"{' / '.join(f'{x:.3f}' for x in t['single'])} ms, mesh "
                  f"{' / '.join(f'{x:.3f}' for x in t['mesh'])} ms (5 calls a turn, CUDA events); "
                  f"peak device memory above the frames single {peaks['single']:.3f} GiB, mesh "
                  f"{peaks['mesh']:.3f} GiB; max |mesh - single| {err:.3e} of the peak (limit "
                  f"1e-6) | {card_line}")
            check(err <= 1e-6, f"the {precision} mesh volume differs from the single-device one")

    # the command line, each opening its own world of one, then the dry run
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg_path = tmp / "flagship.json"
        cfg_path.write_text(cfg.replace(dirdescr="chip_smoke").to_json())
        text, _ = run_cli(["live", "--config", str(cfg_path), "--outdir", str(tmp / "live"),
                           "--frames", "64", "--batch", "8", "--mesh", "1x1"], {k1: 8},
                          "live --frames 64 --batch 8 --mesh 1x1 (kernel 1 bf16, one launch "
                          "per group)")
        check("processed 64 frames" in text and not dist.is_initialized(), f"live --mesh: {text}")
        counts[(k1, "bf16")] += 8
        text, _ = run_cli(["cscan", "--config", str(cfg_path), "--outdir", str(tmp / "cscan"),
                           "--frames", "64", "--mesh", "1x1"], {}, "cscan --frames 64 --mesh 1x1")
        with np.load(next((tmp / "cscan").iterdir()) / "BscanFFT.npz") as npz:
            shape = npz["cscan"].shape
        check(shape == (64, calib.ndisp, cfg.oph) and not dist.is_initialized(),
              f"cscan --mesh: volume {shape}")
    t0 = time.perf_counter()
    report = dryrun_multichip(1, "cuda")
    phase("mesh", f"dryrun_multichip(1, 'cuda') in {time.perf_counter() - t0:.1f} s (a spawned "
          f"rank, nccl): {json.dumps(report)}")
    return counts


def host_enqueue_ms(fn, runs: int = 5) -> float:
    """Median host-clock ms of ``runs`` calls of ``fn`` up to its return,
    the device idle before each and synchronised after: the time the call's
    launches take to enqueue (what a captured graph would save)."""
    samples = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        samples.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return statistics.median(samples)


def counted(fn):
    """``fn()``, then the kernel launches and collective bytes it added
    (both counts set to 0 just before, read just after)."""
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.parallel.mesh import COLLECTIVE_BYTES, reset_collective_bytes

    kernels.reset_launches()
    reset_collective_bytes()
    out = fn()
    torch.cuda.synchronize()
    return (out, {k: v for k, v in kernels.LAUNCHES.items() if v},
            {k: v for k, v in COLLECTIVE_BYTES.items() if v})


def mesh_graph_phase(cfg, calib, mesh, card_line: str, dev: torch.device) -> dict:
    """Phase 16's CUDA graphs of the mesh session (``Session(mesh=)`` on a
    1 x 1 mesh, ``_mesh_step``): for each path of MESH_GRAPH_PATHS three
    process_group calls of 2 groups, the first capturing the batch's graph
    with its NCCL collectives (its step runs eagerly once on the capture's
    side stream), the next two replaying it; each call's displays, dB and
    linear B-scans equal to the eager step (``session_mesh_pipeline[_int8]``)
    on the same state bit for bit, and its launches and collective bytes
    (counts set to 0 just before, read just after) the eager step's.  Then
    a threshold key and a 'b' capture between batches at 'default' and
    'int8_direct' (both keep their graph at the key: the floor is a device
    scalar; both capture again after 'b'); then the host time of a 'base'
    'default' mesh group in parts (host_parts), eager and replayed, beside
    the H2D copy of a number the parent's mesh path made per batch; and the
    group ms, device busy and idle of the eager step and of the replay
    (time_session), turns E R R E.  Returns the launches of each (kernel,
    operator)."""
    from fdoct_tpu_torch.sources.synthetic import SyntheticSource

    src = SyntheticSource(height=cfg.height, width=cfg.width, lambda0=cfg.lambda0,
                          dlambda=cfg.lambdabw * 2.3548 / 4.0, noise=0.02, seed=SEED + 5)
    stream = src.frames()

    def batch():
        return np.stack([next(stream) for _ in range(2 * cfg.averages)])

    counts: dict = {}
    for label, variant, changes, name, op, per_group in MESH_GRAPH_PATHS:
        s = graph_session(cfg, calib, variant, changes, src, dev, mesh=mesh)
        a, b = batch(), batch()
        ran = []
        for i, frames_ in enumerate((a, b, a)):
            results, launched, moved = counted(lambda f=frames_: s.process_group(f))
            want, want_launched, want_moved = counted(lambda f=frames_: eager_outputs(s, f))
            check(same_outputs(results, want), f"mesh graphs {label}: call {i} differs from "
                  "the eager step")
            check((launched, moved) == (want_launched, want_moved),
                  f"mesh graphs {label}: call {i} launched {launched}, moved {moved}; the eager "
                  f"step {want_launched}, {want_moved}")
            check(launched == ({name: 2 * per_group} if name else {}),
                  f"mesh graphs {label}: launches {launched} for 2 groups")
            ran.append(launched)
        check(s.graphs.captures == 1 and len(s.graphs) == 1,
              f"mesh graphs {label}: {s.graphs.captures} captures")
        check(not any(k.startswith(("mesh:", "slow:", "eager:")) for k in s._said_once),
              f"mesh graphs {label} left the replayed mesh path: {s.status}")
        (key, captured), = s.graphs.items()
        if name:
            counts[(name, op)] = counts.get((name, op), 0) + sum(r[name] for r in ran)
        phase("mesh graphs", f"{label} ({key[0]}): 3 calls of 2 groups (a capture, 2 replays) "
              f"bit-equal to the eager step, each with the eager step's launches {ran[-1]} and "
              f"collective bytes {moved}; a replay's {captured.launches}, "
              f"{captured.collective_bytes}; pool {captured.pool_bytes / 2**20:.1f} MiB")
        s.close()

    for precision in ("default", "int8_direct"):
        s = graph_session(cfg, calib, "base", {"matmul_precision": precision}, src, dev,
                          mesh=mesh)
        a = batch()
        s.process_group(a)
        s.key("]")
        check(same_outputs(s.process_group(a), eager_outputs(s, a)) and s.graphs.captures == 1,
              f"mesh graphs {precision}: the batch after a threshold key")
        s.key("b")
        s.process_group(np.stack([src.background()] * cfg.averages))   # the per-frame path
        check(same_outputs(s.process_group(a), eager_outputs(s, a)) and s.graphs.captures == 2,
              f"mesh graphs {precision}: the batch after a 'b' capture")
        phase("mesh graphs", f"base '{precision}': a threshold key (1 capture) and a 'b' capture "
              f"(2) between batches; the next batch bit-equal to the eager step each time")
        s.close()

    s = graph_session(cfg, calib, "base", {}, src, dev, mesh=mesh)
    batches = [batch() for _ in range(4)]
    parts = {mode: host_parts(s, batches[0], mode == "replay") for mode in ("eager", "replay")}
    floor_copy = cuda_ms(lambda: torch.tensor(-30.0, dtype=torch.float32, device=dev))[0]
    for mode, p in parts.items():
        phase("mesh graphs", f"base 'default' mesh host ms per group, {mode}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in p.items()) + f"; sum {sum(p.values()):.4f} | {card_line}")
    phase("mesh graphs", f"the parent's mesh display floor: one H2D copy of a number per batch, "
          f"{floor_copy:.4f} ms (CUDA events; torch.tensor(-30.0, device=cuda)) | {card_line}")
    turns = {}
    for turn in ("E", "R", "R", "E"):
        turns.setdefault(turn, []).append(time_session(EagerStep(s) if turn == "E" else s,
                                                       batches))
    for turn, ts in turns.items():
        phase("mesh graphs", f"base 'default' mesh Session.process_group per group, "
              f"{'eager step' if turn == 'E' else 'replayed graph'} (turns E R R E): "
              + " | ".join(describe_session(t) for t in ts) + f" | {card_line}")
    s.close()
    return counts


def u16_problem(cfg, values: str, dev: torch.device, shape=None) -> dict:
    """16-bit frames with pi and inv_background on their scale: ``"camera"``,
    the synthetic source at 16 bits (bpp = 16: fringes over the whole
    range) with its background and pi frame; ``"mono16"``, the 12-bit
    source's frames, background and pi frame << 4 (Mono16); ``"noise"``,
    counts drawn uniformly over the 16-bit range with pi and the background
    drawn as random_problem draws them, 257 times larger (the ratio of
    random_problem's u8 frames).  At the flagship (``shape`` None; the
    caller adds the flagship operators) or at ``shape`` (B, rows, n_in,
    ndisp) with random operators."""
    from fdoct_tpu_torch.sources.synthetic import SyntheticSource
    B, rows, n_in, ndisp = shape or (cfg.averages, cfg.height, cfg.width, cfg.numdisplaypoints)
    rng = np.random.default_rng(SEED + 20)
    if values == "noise":
        raw = rng.integers(0, 65536, (B, rows, n_in))
        pi = rng.uniform(0, 50 * 257, (rows, n_in))
        bg = rng.uniform(50 * 257, 200 * 257, (rows, n_in))
    else:
        bpp, shift = (16, 0) if values == "camera" else (12, 4)
        src = SyntheticSource(height=rows, width=n_in, lambda0=cfg.lambda0,
                              dlambda=cfg.lambdabw * 2.3548 / 4.0, noise=0.02, seed=SEED,
                              bpp=bpp)
        it = src.frames()
        raw = np.stack([next(it) for _ in range(B)]).astype(np.int64) << shift
        pi = src.pi_frame().astype(np.float64) * (1 << shift)
        bg = np.maximum(src.background().astype(np.float64) * (1 << shift), 1 << shift)
    inp = {"raw": torch.as_tensor(raw.astype(np.uint16)).to(dev),
           "pi": torch.as_tensor(pi).to(dev, torch.float32),
           "inv": torch.as_tensor(1.0 / bg).to(dev, torch.float32)}
    if shape is not None:
        mr, mi = (torch.as_tensor(rng.normal(size=(n_in, ndisp))).to(dev, torch.float32)
                  for _ in range(2))
        inp["f32"], inp["bf16"] = (mr, mi), (mr.to(torch.bfloat16), mi.to(torch.bfloat16))
        inp["tf32"] = tf32_table(mr, mi)
    return inp


def u16_phases(cfg, calib, products: dict, card_line: str, dev: torch.device) -> list:
    """Phase 17: kernel 1 on 16-bit frames, as its TPU kernel takes them.
    Both u16 instances (bf16 and f32 operator) against their plain versions
    (bf16 at TC_TOL, f32 at TOL) and against the float64 product of their
    rounded operands (BF16_F64_TOL, F64_TOL): at the flagship (its M) on a
    16-bit camera's frames and on Mono16 frames, and at RAGGED (n_in % 8 !=
    0: the element loads; random operators) on white-noise and Mono16
    frames.  White-noise frames against the flagship M (u16_problem
    "noise"), whose ratio has a large mean that M cancels, are read beside
    the u8 instance on random_problem's frames (the same ratio, 257 times
    fewer counts) and cuBLAS f32: the u16 instance's float64 share must
    stay within 1.25 times the u8 instance's, and with the bf16 operator
    each within BF16_F64_TOL; then white_noise_phase holds the u16 bf16
    instance in both schedules to BF16_F64_TOL beside the model of its
    sums, the chain never rounded and the 23-bit control.  Times beside
    the plain version's, the cuBLAS product's and the bound.  Then a
    flagship 12-bit 'base' session (SyntheticSource bpp = 12) at 'default'
    and 'highest': counts set to 0 just before its 8 groups and read just
    after, exactly one kernel 1 launch a group and none of kernel 2; every
    display within 1 uint8 level of the kernel-2 route (preprocess,
    apodize_ratio, fused_recon_accumulate, form_bscan: the route 16-bit
    frames took before kernel 1 took them) on the same frames; the group
    time of both routes, host clock, turns P C C P (P: the kernel-2 route,
    raw_kernel_applies narrowed to uint8 as it was), and each route's
    profiled breakdown.  Returns the u16 instances' entries of the
    {"kernels": [...]} line."""
    from fdoct_tpu_torch import pipeline
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.ops.kernels import (
        LAUNCHES, fused_recon_accumulate, fused_recon_raw_accumulate,
        fused_recon_raw_accumulate_reference,
    )
    from fdoct_tpu_torch.pipeline import apodize_ratio, form_bscan, preprocess
    from fdoct_tpu_torch.session import Session
    from fdoct_tpu_torch.sources.synthetic import SyntheticSource

    name = "fused_recon_raw_accumulate"
    ops = {"f32": (calib.op_re, calib.op_im), "bf16": (calib.op_re_bf16, calib.op_im_bf16),
           "tf32": calib.op_tf32}
    problems = {"flagship camera": {**u16_problem(cfg, "camera", dev), **ops},
                "flagship mono16": {**u16_problem(cfg, "mono16", dev), **ops},
                "ragged noise": u16_problem(cfg, "noise", dev, RAGGED),
                "ragged mono16": u16_problem(cfg, "mono16", dev, RAGGED),
                "resident ragged mono16": u16_problem(cfg, "mono16", dev, RESIDENT_RAGGED)}
    errors, shares, f64, bit_equal = {}, {}, {}, {}
    for shape_name, inp in problems.items():
        x = (inp["raw"], inp["pi"], inp["inv"])
        x32 = (inp["raw"].float() - inp["pi"]) * inp["inv"]
        for op in ("bf16", "f32"):
            sched = schedule_of(inp["raw"], inp[op], inp["pi"], inp["inv"], table=inp["tf32"])
            phase("kernel1_u16", f"{name} u16 {shape_name} op={op} takes the {sched} schedule")
            check(sched == "wgmma"
                  or shape_name not in ("flagship camera", "resident ragged mono16"),
                  f"{name} u16 {shape_name} {op} takes the {sched} schedule, not wgmma")
            if shape_name in ("flagship camera", "resident ragged mono16"):
                eq, apart = bit_equal_schedules(
                    lambda r, inp=inp, op=op: fused_recon_raw_accumulate(
                        r, inp["pi"], inp["inv"], *inp[op], **table_kw(inp, op)),
                    inp["raw"], inp[op], inp["pi"], inp["inv"], table=inp["tf32"])
                bit_equal[(op, shape_name)] = eq
                phase("kernel1_u16", f"{name} u16 {shape_name} op={op}: the wgmma schedule "
                      f"against the mma.sync schedule on the same values (a misaligned view): "
                      f"torch.equal {eq}, worst {apart:.3e} of F64_TOL apart")
                check(eq, f"{name} u16 {shape_name}: the two {op} schedules differ")
        for op in ("bf16", "f32"):
            got = fused_recon_raw_accumulate(*x, *inp[op], **table_kw(inp, op))
            torch.cuda.synchronize()
            want = fused_recon_raw_accumulate_reference(*x, *inp[op])
            tol = TC_TOL.get((name, op), TOL[op])
            res = compare(got, want, tol, tol * float(want.abs().max()))
            if op == "bf16":
                want64, lim = bf16_f64_product(x32, *inp[op]), BF16_F64_TOL
            else:
                want64, lim = f64_product(x32, *inp[op]), F64_TOL
            res64 = compare(got, want64, lim, lim * float(want64.abs().max()))
            errors[(shape_name, op)] = res["max_abs_err"]
            shares.setdefault(op, {})[shape_name] = res["worst_share_of_tol"]
            f64.setdefault(op, {})[shape_name] = res64["worst_share_of_tol"]
            phase("kernel1_u16", f"{name} u16 {shape_name} {tuple(x[0].shape)} (max count "
                  f"{int(x[0].int().max())}) op={op}: vs plain max_abs_err "
                  f"{res['max_abs_err']:.3e}, worst {res['worst_share_of_tol']:.3e} of tol "
                  f"(rtol=atol/max={tol}); vs the float64 product of its rounded operands worst "
                  f"{res64['worst_share_of_tol']:.3e} of tol (rtol=atol/max={lim})")
            check(res["finite"] and res["worst_share_of_tol"] <= 1.0
                  and res64["worst_share_of_tol"] <= 1.0,
                  f"{name} u16 {shape_name} {op} disagrees with its plain version or float64")

    # white noise against the flagship M: u16 beside u8 on the same ratio
    noise = {"u16": u16_problem(cfg, "noise", dev),
             "u8": random_problem((cfg.averages, cfg.height, cfg.width, 1), SEED + 21, dev)}
    for op in ("bf16", "f32"):
        read = {}
        for frames_of, inp in noise.items():
            x = (inp["raw"], inp["pi"], inp["inv"])
            x32 = (inp["raw"].float() - inp["pi"]) * inp["inv"]
            want64 = (bf16_f64_product if op == "bf16" else f64_product)(x32, *ops[op])
            lim = BF16_F64_TOL if op == "bf16" else F64_TOL
            more = {f"{frames_of} kernel": fused_recon_raw_accumulate(*x, *ops[op],
                                                                     **table_kw(ops, op)),
                    f"{frames_of} cuBLAS f32": fused_recon_raw_accumulate_reference(*x, *ops[op])}
            atol = lim * float(want64.abs().max())
            read.update({k: compare(v, want64, lim, atol)["worst_share_of_tol"]
                         for k, v in more.items()})
        phase("kernel1_u16", f"{name} white-noise frames against the flagship M op={op}, against "
              f"the float64 product of the rounded operands (rtol=atol/max={lim}): " +
              ", ".join(f"{k} worst {v:.3e}" for k, v in read.items()) +
              " of tol (the u16 instance must stay within 1.25x the u8 instance)")
        check(read["u16 kernel"] <= 1.25 * read["u8 kernel"],
              f"{name} u16 {op} errs more than the u8 instance on the same ratio")
        check(op == "f32" or (read["u16 kernel"] <= 1.0 and read["u8 kernel"] <= 1.0),
              f"{name} bf16 on white noise drifts from the float64 product")
    n16 = noise["u16"]
    n16_terms = (n16["pi"], n16["inv"])
    white = white_noise_phase(
        f"{name} u16", lambda r: fused_recon_raw_accumulate(r, *n16_terms, *ops["bf16"]),
        lambda: fused_recon_raw_accumulate_reference(n16["raw"], *n16_terms, *ops["bf16"]),
        n16["raw"], (n16["raw"].float() - n16["pi"]) * n16["inv"], ops["bf16"], *n16_terms,
        chains=True)
    del noise, n16, n16_terms

    flag = problems["flagship camera"]
    x16 = (flag["raw"], flag["pi"], flag["inv"])
    times = {}
    for op in ("bf16", "f32"):
        times[op] = t = timed_pair(
            lambda: fused_recon_raw_accumulate(*x16, *ops[op], **table_kw(ops, op)),
            lambda: fused_recon_raw_accumulate_reference(*x16, *ops[op]))
        parent = f" | the parent's mma.sync b2b {PARENT_B2B_MS['u16 ' + op]} ms (PERF.md §6)"
        phase("kernel1_u16", f"{name} u16 flagship op={op}: {describe(t)}{parent} | {card_line}")

    # the 12-bit session at 'default' and 'highest', counts at 0 around each
    src16 = SyntheticSource(height=cfg.height, width=cfg.width, lambda0=cfg.lambda0,
                            dlambda=cfg.lambdabw * 2.3548 / 4.0, noise=0.02, seed=SEED + 1,
                            bpp=12)
    frames16 = src16.frames()
    batches = [np.stack([next(frames16) for _ in range(2 * cfg.averages)]) for _ in range(4)]
    check(batches[0].dtype == np.uint16 and int(batches[0].max()) > 255, "not 16-bit frames")
    widened = pipeline.raw_kernel_applies

    def kernel2_route(raw, c):           # how 16-bit frames ran before: preprocess + kernel 2
        return raw.dtype == torch.uint8 and widened(raw, c)

    launches = {}
    for precision, op in (("default", "bf16"), ("highest", "f32")):
        scfg = cfg.replace(bpp=12, matmul_precision=precision)
        s = captured_session(Session, scfg, "base", src16, frames16, calib, dev)
        kernels.reset_launches()
        results = [r for b in batches for r in s.process_group(b)]
        torch.cuda.synchronize()
        ran = {k: v for k, v in LAUNCHES.items() if v}
        groups = len(results)
        check(groups == 8 and ran == {name: groups},
              f"12-bit '{precision}': launches {ran} for {groups} groups, not {name}: 8")
        launches[op] = ran[name]
        diff = 0
        for i, r in enumerate(results):
            raw = torch.as_tensor(batches[i // 2][(i % 2) * cfg.averages:][:cfg.averages]).to(dev)
            yr = apodize_ratio(preprocess(raw, scfg), s.data_yb, s.data_yp, scfg).contiguous()
            want = form_bscan(fused_recon_accumulate(yr, *ops[op], **table_kw(ops, op)),
                              scfg, cfg.averages,
                              bscanthreshold=s.bscanthreshold).bscandisp.cpu().numpy()
            diff = max(diff, int(np.abs(r.bscandisp.astype(int) - want.astype(int)).max()))
        phase("kernel1_u16", f"12-bit base '{precision}': {groups} B-scans through {name} op="
              f"{op}, launches this path {ran}; displays against the kernel-2 route on the same "
              f"frames: max uint8 diff {diff} (limit 1)")
        check(diff <= 1, f"12-bit '{precision}' display differs from the kernel-2 route")
        # the route is read when a step is captured: each turn captures anew
        # (in host_group_ms's warm-up pass)
        turns = {}
        for turn in ("P", "C", "C", "P"):
            pipeline.raw_kernel_applies = kernel2_route if turn == "P" else widened
            s.graphs.clear()
            try:
                turns.setdefault(turn, []).append(statistics.median(host_group_ms(s, batches)))
            finally:
                pipeline.raw_kernel_applies = widened
        pipeline.raw_kernel_applies = kernel2_route
        s.graphs.clear()
        try:
            s.process_group(batches[0])
            prof_p = device_breakdown(lambda: [s.process_group(b) for b in batches], 8)
        finally:
            pipeline.raw_kernel_applies = widened
        s.graphs.clear()
        s.process_group(batches[0])
        prof_c = device_breakdown(lambda: [s.process_group(b) for b in batches], 8)
        phase("kernel1_u16", f"12-bit base '{precision}' Session.process_group per group (8 frames "
              f"512x2048 u16 from host memory to uint8 display on host), host-clock medians of "
              f"{SESSION_CALLS} calls, turns P C C P: kernel-2 route (P) "
              f"{turns['P'][0]:.3f} / {turns['P'][1]:.3f} ms, kernel 1 (C) {turns['C'][0]:.3f} / "
              f"{turns['C'][1]:.3f} ms | P: {describe_breakdown(prof_p)} | C: "
              f"{describe_breakdown(prof_c)} | {card_line}")

    entries = []
    for op in ("bf16", "f32"):
        entries.append({
            "name": name, "input": "u16", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[op], "operator": op,
            "mma": MMA[(name, op)],
            "schedule": schedule_of(x16[0], ops[op], *x16[1:], table=ops["tf32"]),
            "bit_equal_to_mma_sync": all(v for (o, _), v in bit_equal.items() if o == op),
            "max_abs_err": errors[("flagship camera", op)],
            "worst_share_of_tol": max(shares[op].values()),
            **({"bf16_f64_tol": BF16_F64_TOL,
                "worst_share_of_bf16_f64_tol": max(f64[op].values()),
                **white_noise_keys(white)} if op == "bf16" else
               {"f64_tol": F64_TOL, "worst_share_of_f64_tol": max(f64[op].values())}),
            **time_keys(times[op]),
            **bound_keys(op, 2 * x16[0].numel() * calib.op_re.shape[1], [*x16, *ops[op]],
                         fused_recon_raw_accumulate(*x16, *ops[op], **table_kw(ops, op))),
            "library_ms": None, "product_ms": products[op][0],
            "product_ms_b2b": products[op][1]})
    return entries


#: the octa500-angio800 cell's configuration, whose full shape phase 20 runs
ANGIO_CONFIG = "oct_bench/configs/octa500-6mm-ssada.json"
ANGIO_FRAMES = 800
ANGIO_SOURCE = "fdoct_tpu_torch/csrc/angio_product.cu"
MMA_ANGIO = ("wgmma.mma_async.m64n128k8.f32.tf32.tf32 (3xTF32: lo.hi + hi.lo + hi.hi, each "
             "stage's sums added in round-to-nearest f32; persistent warp-specialised blocks "
             "over tiles of 128 rows x 64 columns: a TMA producer warpgroup, two consumer "
             "warpgroups, A from registers, the K-major TF32 table from shared memory)")


def angio_product_phase(card_line: str, dev: torch.device) -> dict:
    """Phase 20: ops.kernels.split_spectrum_mags at the octa500-angio800
    cell's full shape: the cell's volume entry (sharded_angio_volume on one
    card, 'highest', float32) on ANGIO_FRAMES seeded frames, the launch
    counts set to 0 just before it, launching it once and no other kernel;
    then on seeded ratio rows of ANGIO_FRAMES frames against the cell's
    split-spectrum operator and its TF32 table, its schedule, its
    plain version (TOL["f32"]), the float64 product on every 97th row
    (F64_TOL, which the TF32 control must fail), kernel 2's f32 instance at
    B = 1 and the mma.sync form on a misaligned view of 16 frames (both
    torch.equal), ptxas's lines of its kernel, and its times beside the
    plain version's, the bound and cuBLAS's f32 product of the stack with
    [op_re | op_im].  Returns its entry of the {"kernels": [...]} line."""
    from fdoct_tpu_torch import angio
    from fdoct_tpu_torch.config import PipelineConfig
    from fdoct_tpu_torch.ops import _build, kernels
    from fdoct_tpu_torch.ops.kernels import (
        LAUNCHES, f32_schedule, fused_recon_accumulate, split_spectrum_mags,
        split_spectrum_mags_reference,
    )
    from fdoct_tpu_torch.parallel import sharded_angio_volume
    from fdoct_tpu_torch.pipeline import preprocess
    from oct_bench import frames as bench_frames
    log = _build.library_path().with_suffix(".log").read_text().splitlines()
    for i, ln in enumerate(log):
        if "Compiling entry function" in ln and "split_spectrum_mags_kernel" in ln:
            for more in log[i + 2:i + 4]:
                phase("angio", f"split_spectrum_mags_kernel: {more.strip()}")
    cfg = PipelineConfig(**json.loads((Path(__file__).resolve().parent / ANGIO_CONFIG)
                                      .read_text())["pipeline"])
    t0 = time.perf_counter()
    op = angio.SplitSpectrumOperator.create(cfg, angio.AngioConfig(), dev)
    phase("angio", f"the split-spectrum operator {tuple(op.op_re.shape)} and its TF32 table "
          f"{tuple(op.op_tf32.shape)} built in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=dev).manual_seed(SEED + 26)
    yr = torch.randn((ANGIO_FRAMES * cfg.height, cfg.width), generator=g, device=dev)
    rows, n_in = yr.shape
    def run(x: torch.Tensor = yr) -> torch.Tensor:
        return split_spectrum_mags(x, op.op_re, op.op_im, op.op_tf32)

    # the volume's route: the cell's entry on one card at its precision and
    # type, on seeded frames, the counts set to 0 just before
    gv = bench_frames.generator(SEED + 26, dev)
    raw = bench_frames.sample_frames(cfg, ANGIO_FRAMES, gv, dev)
    bg = torch.clamp_min(preprocess(bench_frames.background_frames(cfg, 1, gv, dev)[0], cfg),
                         1.0)
    check(cfg.matmul_precision == "highest" and cfg.dtype == "float32",
          f"the cell's volume runs at {cfg.matmul_precision!r} in {cfg.dtype}")
    kernels.reset_launches()
    vol = sharded_angio_volume(raw, bg, torch.zeros_like(bg), op, cfg)
    torch.cuda.synchronize()
    moved = {k: v for k, v in LAUNCHES.items() if v}
    launches = LAUNCHES["split_spectrum_mags"]
    phase("angio", f"sharded_angio_volume {tuple(raw.shape)} -> {tuple(vol.shape)}: launches "
          f"{moved}")
    check(moved == {"split_spectrum_mags": 1} and bool(vol.isfinite().all()),
          f"the angiography volume launched {moved}, not split_spectrum_mags once")
    del raw, vol
    got = run()
    sched = f32_schedule(torch.float32, n_in, op.op_re.shape[1],
                         [yr.data_ptr(), op.op_tf32.data_ptr()])
    check(sched == "wgmma", f"split_spectrum_mags on the {sched} schedule")
    want = split_spectrum_mags_reference(yr, op.op_re, op.op_im)
    res = compare(got, want, TOL["f32"], TOL["f32"] * float(want.abs().max()))
    del want
    sub = slice(0, rows, 97)
    want64 = torch.hypot(yr[sub].double() @ op.op_re.double(), yr[sub].double() @ op.op_im.double())
    atol = F64_TOL * float(want64.abs().max())
    f64 = {k: compare(v, want64, F64_TOL, atol)["worst_share_of_tol"]
           for k, v in {"kernel": got[sub],
                        "cuBLAS f32": split_spectrum_mags_reference(yr[sub], op.op_re, op.op_im),
                        "TF32 control": tf32_control(yr[sub][None], op.op_re, op.op_im)
                        }.items()}
    del want64
    k2_equal = bool(torch.equal(got, fused_recon_accumulate(yr[None], op.op_re, op.op_im,
                                                            op_tf32=op.op_tf32)))
    few = yr[:16 * cfg.height]
    mma_equal = bool(torch.equal(got[:few.shape[0]], run(misaligned(few))))
    phase("angio", f"split_spectrum_mags {tuple(yr.shape)} @ {tuple(op.op_re.shape)} -> "
          f"{tuple(got.shape)} schedule {sched}: vs plain max_abs_err {res['max_abs_err']:.3e}, "
          f"worst {res['worst_share_of_tol']:.3e} of tol (rtol=atol/max={TOL['f32']}); vs the "
          "float64 product (every 97th row): " + ", ".join(f"{k} worst {v:.3e}"
                                                             for k, v in f64.items())
          + f" of tol (rtol=atol/max={F64_TOL}); torch.equal kernel 2 f32 at B = 1 {k2_equal}, "
          f"the mma.sync form (16 frames, a misaligned view) {mma_equal}")
    check(res["finite"] and res["worst_share_of_tol"] <= 1.0 and f64["kernel"] <= 1.0
          and f64["TF32 control"] > 1.0 and k2_equal and mma_equal,
          "split_spectrum_mags disagrees with its plain version, float64 or kernel 2")
    del got
    timed = {"kernel": cuda_ms(run, runs=10), "plain": cuda_ms(
        lambda: split_spectrum_mags_reference(yr, op.op_re, op.op_im), runs=5),
        "kernel_b2b": cuda_ms(run, runs=3, per=3),
        "plain_b2b": cuda_ms(lambda: split_spectrum_mags_reference(yr, op.op_re, op.op_im),
                             runs=3, per=3)}
    cat = torch.cat((op.op_re, op.op_im), dim=1).contiguous()
    product = cuda_ms(lambda: torch.matmul(yr, cat), runs=5)
    mags = torch.empty((rows, op.op_re.shape[1]), device=dev)
    bound = bound_keys("f32", 2 * rows * n_in * op.op_re.shape[1], [yr, op.op_re, op.op_im],
                       mags)
    times = "; ".join(f"{what} median {m:.4f} ms (min {lo:.4f}, max {hi:.4f})"
                      for what, (m, lo, hi) in timed.items())
    phase("angio", f"split_spectrum_mags at the cell's shape: {times}; CUDA events, kernel 10 "
          f"samples, plain 5, *_b2b 3 samples of 3 back-to-back calls | bound "
          f"{bound['bound_ms']:.2f} ms ({bound['bound_by']}) | cuBLAS f32 product "
          f"{tuple(yr.shape)} @ {tuple(cat.shape)} median {product[0]:.2f} ms | {card_line}")
    return {"name": "split_spectrum_mags", "route": "cuda", "source": ANGIO_SOURCE,
            "replaces": None, "launches": launches, "operator": "f32", "mma": MMA_ANGIO,
            "schedule": sched, "bit_equal_to_mma_sync": mma_equal,
            "bit_equal_to_kernel_2_at_b1": k2_equal, "max_abs_err": res["max_abs_err"],
            "worst_share_of_tol": res["worst_share_of_tol"], "f64_tol": F64_TOL,
            "worst_share_of_f64_tol": f64["kernel"],
            "cublas_f32_share_of_f64_tol": f64["cuBLAS f32"],
            "tf32_control_share_of_f64_tol": f64["TF32 control"], **time_keys(timed), **bound,
            "library_ms": None, "product_ms": product[0]}


def bench_phase(card_line: str, dev: torch.device) -> None:
    """Phase 18: `fdoct-torch bench` (fdoct_tpu_torch.cli.main(["bench"]),
    in process, on the default device cuda), its JSON line captured: every
    key of bench.py's line present or its row named in "dropped", value > 0,
    the card's name and power limit, the CUDA-event timer; launch counts set
    to 0 just before and read just after: kernel 1 once for every group of
    the headline's runs and twice for each of the host-inclusive row's (the
    run that captures its graph and the timed one; bf16: the config's
    'default' on the card), no other kernel (the int8 rows run two _int_mm
    products, the batched rows torch.matmul); and one headline group's
    display byte-equal to Session.process_group's on the same frames with
    the same background and pi.  Prints the line."""
    import contextlib
    import io

    from fdoct_tpu_torch import bench, cli
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.ops.kernels import LAUNCHES
    from fdoct_tpu_torch.pipeline import use_bf16
    from fdoct_tpu_torch.session import Session

    name = "fused_recon_raw_accumulate"
    shape = bench.FLAGSHIP
    check(use_bf16(bench.config(shape).matmul_precision, torch.float32, dev),
          "bench's headline does not take the bf16 operator on the card")
    kernels.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["bench"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    ran = {k: v for k, v in LAUNCHES.items() if v}
    line = out.getvalue().strip().splitlines()[-1]
    res = json.loads(line)
    phase("bench", f"fdoct-torch bench: exit {rc} in {secs:.1f} s (host clock); launches "
          f"{ran} | {card_line}")
    print(line, flush=True)
    check(rc == 0, f"bench exited {rc}")
    missing = [k for k in bench.BENCH_PY_KEYS if k not in res and not any(
        k in bench.ROW_KEYS[row] for row in res["dropped"])]
    check(not missing, f"bench's line lacks {missing} and names no dropped row for them")
    check(res["value"] > 0 and res["timer"] == "cuda_events", f"bench value {res['value']}, "
          f"timer {res['timer']}")
    check(res["device"]["name"] == torch.cuda.get_device_name(0)
          and res["device"]["power_limit_w"] > 0, f"bench device {res['device']}")
    groups = res["headline_groups"]
    check(res["headline_launches"] == groups
          and groups == (1 + shape.repeats) * (shape.g1 + shape.g2),
          f"headline: {res['headline_launches']} launches for {groups} groups")
    # the host-inclusive row runs its groups twice: the run that captures its
    # graph, then the timed replay
    check(ran == {name: groups + 2 * bench.HOST_GROUPS},
          f"bench launched {ran}, not {name}: {groups + 2 * bench.HOST_GROUPS}")

    harness = bench.Harness.create(shape, dev)
    frames = bench.gen_frames(shape, 1, dev)[0]
    disp = harness.group_step(frames).cpu().numpy()
    s = Session(harness.cfg, device=dev, calib=harness.calib)
    s.data_yb, s.data_yp = harness.background, harness.pi_frame
    (r,) = s.process_group(frames)
    check(np.array_equal(disp, r.bscandisp), "a headline display differs from process_group's")
    phase("bench", f"one headline group's display {disp.shape} byte-equal to "
          f"Session.process_group's on the same frames; dropped rows {res['dropped']}; "
          f"baseline {res['vs_baseline']} ({res.get('baseline_error', 'built and run')})")


#: the session paths of PERF.md §5 that the graphs phase replays: (label,
#: variant, config changes, frame bits, kernel, operator, launches a group)
GRAPH_PATHS = [
    ("base 'default'", "base", {}, 8, "fused_recon_raw_accumulate", "bf16", 1),
    ("base 'highest'", "base", {"matmul_precision": "highest"}, 8,
     "fused_recon_raw_accumulate", "f32", 1),
    ("sim 'default'", "sim", {"donotnormalize": False}, 8, "fused_recon_accumulate", "bf16", 1),
    ("sim 'highest'", "sim", {"donotnormalize": False, "matmul_precision": "highest"}, 8,
     "fused_recon_accumulate", "f32", 1),
    ("base 'int8_direct'", "base", {"matmul_precision": "int8_direct"}, 8,
     "int8_bscan_display_fused", "s8", 1),
    ("dark 'default'", "dark", {}, 8, "fused_recon_raw_accumulate", "bf16", 1),
    ("dark 'int8_direct'", "dark", {"matmul_precision": "int8_direct"}, 8,
     "int8_bscan_display_fused", "s8", 1),
    ("peak 'highest'", "peak", {"matmul_precision": "highest"}, 8,
     "fused_recon_raw_accumulate", "f32", 1),
    ("base + rings 'default'", "base", {"saveframes": True, "saveinterferograms": True}, 8,
     "fused_recon_raw_accumulate", "bf16", 8),
    ("12-bit base 'default'", "base", {"bpp": 12}, 12, "fused_recon_raw_accumulate", "u16", 1),
    ("12-bit base 'highest'", "base", {"bpp": 12, "matmul_precision": "highest"}, 12,
     "fused_recon_raw_accumulate", "u16", 1),
    ("mesh 1x1 base 'default'", "base", {"mesh": True}, 8, "fused_recon_raw_accumulate", "bf16",
     1),
]
#: phase 16's replayed mesh paths: (label, variant, config changes, kernel,
#: operator, launches a group; no kernel: int8 on the mesh is two _int_mm)
MESH_GRAPH_PATHS = [
    ("base 'default'", "base", {}, "fused_recon_raw_accumulate", "bf16", 1),
    ("base 'highest'", "base", {"matmul_precision": "highest"}, "fused_recon_raw_accumulate",
     "f32", 1),
    ("sim 'default'", "sim", {"donotnormalize": False}, "fused_recon_accumulate", "bf16", 1),
    ("dark 'default'", "dark", {}, "fused_recon_raw_accumulate", "bf16", 1),
    ("base 'int8_direct'", "base", {"matmul_precision": "int8_direct"}, None, "s8", 0),
    ("base saveframes 'default'", "base", {"saveframes": True}, "fused_recon_raw_accumulate",
     "bf16", 8),
]
#: samples of each part of the host-time breakdown
BREAKDOWN_RUNS = 20


def graph_session(cfg, calib, variant: str, changes: dict, src, dev: torch.device, mesh=None):
    """A flagship session (on ``mesh`` if given) whose calibration frames
    are set as its captures set them: the source's background (at least 1)
    and pi frame, and a dark frame of 2 counts for the dark variant."""
    from fdoct_tpu_torch.session import Session

    s = Session(cfg.replace(**changes), device=dev, variant=variant, calib=calib, mesh=mesh)
    s.data_yb = torch.as_tensor(np.maximum(src.background(), 1)).to(dev, torch.float32)
    s.data_yp = torch.as_tensor(src.pi_frame()).to(dev, torch.float32)
    s.data_yd = torch.full_like(s.data_yp, 2.0)
    return s


def eager_step(s, batch: np.ndarray):
    """(stacked outputs, frame magnitudes or None) of the session's batch
    step for ``batch``, called eagerly, not replayed: on one device
    ``session_group_pipeline[_int8]`` on the frames, on a mesh
    ``session_mesh_pipeline[_int8]`` on the rank's blocks, each copied to
    the card through the session's pinned staging."""
    from fdoct_tpu_torch.parallel.sharded import batch_block

    dtype = torch.from_numpy(batch[:0]).dtype
    groups, avg = len(batch) // s.averagestoggle, s.averagestoggle
    if s.mesh is None:
        _, _, step = s._group_step(batch.shape, dtype, groups, avg)
        return step(s._to_device(batch))
    _, _, step = s._mesh_step(batch.shape, dtype, groups, avg)
    return step(s._to_device(batch_block(batch, s.mesh, groups)))


def eager_outputs(s, batch: np.ndarray):
    """The stacked outputs of :func:`eager_step`."""
    return eager_step(s, batch)[0]


class EagerStep:
    """A session's process_group with its batch step called eagerly, not
    replayed: what the route ran before its graph."""

    def __init__(self, s):
        self.s = s

    def process_group(self, batch):
        outs, mags = eager_step(self.s, batch)
        return self.s._emit_group_results(outs, outs.bscandisp.cpu().numpy(),
                                          self.s.averagestoggle, None, mags)


def same_outputs(results: list, want) -> bool:
    return (np.array_equal(np.stack([r.bscandisp for r in results]), want.bscandisp.cpu().numpy())
            and torch.equal(torch.stack([r.bscandb for r in results]), want.bscandb)
            and torch.equal(torch.stack([r.bscan for r in results]), want.bscan))


def host_parts(s, batch: np.ndarray, replay: bool) -> dict:
    """Median host ms per group of each part of one ``process_group`` of
    ``batch`` on the CUDA fast path, the parts timed one after the other
    as process_group runs them: the route and key (``_group_step``, on a
    mesh ``_mesh_step``), the copy into the pinned staging buffer
    (``np.copyto``; on a mesh of the rank's blocks, a strided view), the H2D
    copy's enqueue, the step (eager: its launches; replay: the graph's launch and
    the outputs' clones), the D2H of the uint8 displays (which waits for
    the device) and the per-group bookkeeping (``_emit_group_results``)."""
    from fdoct_tpu_torch.parallel.sharded import batch_block

    dtype = torch.from_numpy(batch[:0]).dtype
    groups, avg = len(batch) // s.averagestoggle, s.averagestoggle
    route = s._group_step if s.mesh is None else s._mesh_step
    s.process_group(batch)                           # the staging buffer and the graph

    def host():                                      # what process_group stages
        return batch if s.mesh is None else batch_block(batch, s.mesh, groups)
    pinned, _ = s._staging[(host().shape, batch.dtype)]
    samples: dict = {}
    for _ in range(BREAKDOWN_RUNS):
        torch.cuda.synchronize()
        t = [time.perf_counter()]
        key, state, step = route(batch.shape, dtype, groups, avg)
        t.append(time.perf_counter())
        np.copyto(pinned.numpy(), host())
        t.append(time.perf_counter())
        captured = s.graphs.lookup(key, state)
        static = captured.inputs[0].copy_(pinned, non_blocking=True)
        t.append(time.perf_counter())
        outs, mags = captured.replay() if replay else step(static)
        t.append(time.perf_counter())
        disp = outs.bscandisp.cpu().numpy()
        t.append(time.perf_counter())
        s._emit_group_results(outs, disp, avg, None, mags)
        t.append(time.perf_counter())
        for name, a, b in zip(("route", "staging", "h2d_enqueue", "step", "d2h", "bookkeeping"),
                              t, t[1:]):
            samples.setdefault(name, []).append((b - a) * 1e3 / groups)
    return {k: statistics.median(v) for k, v in samples.items()}


def graphs_phase(cfg, calib, card_line: str, dev: torch.device) -> dict:
    """Phase 19: the captured group steps (fdoct_tpu_torch.graphs).  For
    each path of GRAPH_PATHS (the last a session on a 1 x 1 mesh in a world
    of one with nccl) a session makes three process_group calls of 16
    frames (2 groups): the first captures its graph (running the step
    eagerly once), the next two replay it; each call's displays, dB and
    linear B-scans equal the eager step on the same state bit for bit, and
    the launch counts (set to 0 just before, read just after) are the
    kernel's, launches-a-group for each of the 6 groups, and no other.
    Prints each graph's pool.  Then, on 'base' 'default' and 'base'
    'int8_direct': a threshold key and a 'b' capture between batches give the
    eager step's outputs on the next group (the f32 graph kept, the int8
    graph captured again for its threshold; both again after the capture).
    Then the host-time breakdown of a 'base' 'default' group (host_parts),
    eager and replayed, beside the one H2D copy of a number the parent's
    display floor made per group; and group ms, device busy and idle of the
    eager step and of the replay (time_session), in turns E R R E.
    Returns the launches of the 8-bit paths by (kernel, operator)."""
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.ops.kernels import LAUNCHES
    from fdoct_tpu_torch.parallel import WorldOfOne, make_mesh
    from fdoct_tpu_torch.sources.synthetic import SyntheticSource

    sources = {bits: SyntheticSource(height=cfg.height, width=cfg.width, lambda0=cfg.lambda0,
                                     dlambda=cfg.lambdabw * 2.3548 / 4.0, noise=0.02,
                                     seed=SEED + 3, bpp=bits) for bits in (8, 12)}
    streams = {bits: src_.frames() for bits, src_ in sources.items()}
    counts: dict = {}
    for label, variant, changes, bits, name, op, per_group in GRAPH_PATHS:
        changes = dict(changes)
        world = WorldOfOne("cuda") if changes.pop("mesh", False) else None
        mesh = None if world is None else make_mesh(1, 1, device_type="cuda")
        s = graph_session(cfg, calib, variant, changes, sources[bits], dev, mesh=mesh)
        a, b = (np.stack([next(streams[bits]) for _ in range(2 * cfg.averages)])
                for _ in range(2))
        kernels.reset_launches()
        calls = [(a, s.process_group(a)), (b, s.process_group(b)), (a, s.process_group(a))]
        torch.cuda.synchronize()
        ran = {k: v for k, v in LAUNCHES.items() if v}
        check(ran == {name: 6 * per_group}, f"graphs {label}: launches {ran} for 6 groups, "
              f"not {name}: {6 * per_group}")
        check(s.graphs.captures == 1 and len(s.graphs) == 1,
              f"graphs {label}: {s.graphs.captures} captures")
        for i, (frames_, results) in enumerate(calls):
            check(same_outputs(results, eager_outputs(s, frames_)),
                  f"graphs {label}: call {i} differs from the eager step")
        (_, captured), = s.graphs.items()
        if bits == 8:
            counts[(name, op)] = counts.get((name, op), 0) + ran[name]
        phase("graphs", f"{label}: 3 calls of 2 groups (a capture, 2 replays) bit-equal to the "
              f"eager step; launches {ran}, a replay's {captured.launches}; pool "
              f"{captured.pool_bytes / 2**20:.1f} MiB")
        s.close()                            # its graphs go before the world's communicators
        if world is not None:
            world.close()

    # recapture: a threshold key and a 'b' capture between batches
    src8 = sources[8]
    for precision in ("default", "int8_direct"):
        s = graph_session(cfg, calib, "base", {"matmul_precision": precision}, src8, dev)
        a = np.stack([next(streams[8]) for _ in range(2 * cfg.averages)])
        s.process_group(a)
        s.key("]")
        check(same_outputs(s.process_group(a), eager_outputs(s, a)),
              f"graphs {precision}: the group after a threshold key differs from eager")
        after_key = s.graphs.captures
        check(after_key == (1 if precision == "default" else 2),
              f"graphs {precision}: {after_key} captures after a threshold key")
        s.key("b")
        s.process_group(np.stack([src8.background()] * cfg.averages))   # the per-frame path
        check(same_outputs(s.process_group(a), eager_outputs(s, a)),
              f"graphs {precision}: the group after a 'b' capture differs from eager")
        check(s.graphs.captures == after_key + 1,
              f"graphs {precision}: no new capture after 'b'")
        phase("graphs", f"base '{precision}': a threshold key ({after_key} captures) and a 'b' "
              f"capture ({s.graphs.captures}) between batches; the next group bit-equal to "
              f"the eager step each time")
        s.close()

    # where a 'base' 'default' group's host time goes, eager and replayed
    s = graph_session(cfg, calib, "base", {}, src8, dev)
    batches = [np.stack([next(streams[8]) for _ in range(2 * cfg.averages)]) for _ in range(4)]
    parts = {mode: host_parts(s, batches[0], mode == "replay") for mode in ("eager", "replay")}
    floor_copy = cuda_ms(lambda: torch.as_tensor(-30.0, dtype=torch.float32, device=dev))[0]
    for mode, p in parts.items():
        phase("graphs", f"base 'default' host ms per group, {mode}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in p.items()) + f"; sum {sum(p.values()):.4f} | {card_line}")
    phase("graphs", f"the parent's display floor: one H2D copy of a number per group, "
          f"{floor_copy:.4f} ms (CUDA events; torch.as_tensor(-30.0, device=cuda)) | {card_line}")

    turns = {}
    for turn in ("E", "R", "R", "E"):
        t = time_session(EagerStep(s) if turn == "E" else s, batches)
        turns.setdefault(turn, []).append(t)
    for turn, ts in turns.items():
        phase("graphs", f"base 'default' Session.process_group per group, "
              f"{'eager step' if turn == 'E' else 'replayed graph'} (turns E R R E): "
              + " | ".join(describe_session(t) for t in ts) + f" | {card_line}")
    s.close()
    return counts


def host_ms(fn, runs: int = 20) -> tuple[float, float]:
    """Median and min host-clock ms of ``runs`` calls of ``fn``, after one."""
    fn()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), min(times)


def viewer_phase(cfg, calib, src, frames, card_line: str, dev: torch.device) -> dict:
    """Phase 15, the live viewer: an http Viewer driven by a 'base' 'default'
    session as the live loop drives it, then `live --viewer` on the command
    line, then the group time with and without a viewer and the PNG encode
    of each window.  Returns the launches of each (kernel, operator)."""
    import contextlib
    import io
    import tempfile

    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.ops.kernels import LAUNCHES
    from fdoct_tpu_torch.session import Session
    from fdoct_tpu_torch.utils.imageio import decode_png, encode_png, read_png
    from fdoct_tpu_torch.viewer import Viewer, render_bscan, render_status

    k1, k3 = "fused_recon_raw_accumulate", "int8_bscan_display_fused"
    scfg = cfg.replace(matmul_precision="default", donotnormalize=True)
    s = captured_session(Session, scfg, "base", src, frames, calib, dev)
    groups = [np.stack([next(frames) for _ in range(cfg.averages)]) for _ in range(VIEWER_GROUPS)]
    v = Viewer(mode="http", port=0)
    try:
        v.set_config_provider(s.config_snapshot)
        port = v.server.port
        # remote input posted before these groups, drained where the live
        # loop drains it (cli.cmd_live), and what each must have changed
        threshold = s.bscanthreshold
        posts = {2: ("/key", b"]", lambda: s.bscanthreshold == threshold + 1.0),
                 4: ("/config", json.dumps({"bscanthreshold": "-42.5"}).encode(),
                     lambda: s.bscanthreshold == -42.5),
                 6: ("/roi", json.dumps({"window": "bscan", "x": 10, "y": 20, "w": 30,
                                         "h": 8}).encode(),
                     lambda: (s.ascanat, s.vertposROI, s.widthROI) == (10, 20, 30))}
        kernels.reset_launches()
        for g, raws in enumerate(groups):
            if g in posts:
                code, body = http_request(port, *posts[g][:2])
                check(code == 200, f"POST {posts[g][0]}: {code} {body!r}")
            for ch in v.pop_keys():
                s.key(ch)
            for roi in v.pop_rois():
                s.set_roi(roi["x"], roi["y"], roi["w"], roi["h"])
            for upd in v.pop_config():
                s.apply_config(upd)
            if g in posts:
                check(posts[g][2](), f"POST {posts[g][0]} did not reach the session")
            r = s.process_group(raws)[-1]
            v.show_session_frame(s, raws[-1], r)
        torch.cuda.synchronize()
        ran = {k: n for k, n in LAUNCHES.items() if n}
        check(ran == {k1: VIEWER_GROUPS}, f"viewer loop: launches {ran}")
        # the server publishes a window at most every 1/max_fps s and drops
        # the rest: publish the last group once more after that period
        time.sleep(0.05)
        v.show_session_frame(s, groups[-1][-1], r)
        code, png = http_request(port, "/frame/bscan.png")
        served = decode_png(png)
        check(code == 200 and np.array_equal(served, render_bscan(r.bscandisp, s.ascanat)),
              "GET /frame/bscan.png is not the session's B-scan")
        windows = json.loads(http_request(port, "/status.json")[1])["windows"]
        check({"show", "status", "bscan"} <= set(windows), f"/status.json windows {windows}")
        live = json.loads(http_request(port, "/config")[1])["live"]
        check(live["bscanthreshold"] == -42.5, f"GET /config {live}")
    finally:
        v.close()
    phase("viewer", f"http Viewer behind a base 'default' session, {VIEWER_GROUPS} groups: "
          f"launches {ran}; GET /frame/bscan.png {served.shape} equals render_bscan of the last "
          f"group byte for byte; windows {windows}; POST /key ']' moved bscanthreshold "
          f"{threshold} -> {threshold + 1.0}, POST /config set -42.5, POST /roi set ascanat 10")
    counts = {(k1, "bf16"): VIEWER_GROUPS}

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        cfg_path = tmp / "flagship.json"
        cfg_path.write_text(cfg.replace(dirdescr="chip_smoke").to_json())
        base = ["live", "--config", str(cfg_path), "--outdir", str(tmp / "live"), "--frames",
                "64", "--batch", "8"]
        for what, extra, name, op in (
                ("files", ["--viewer", str(tmp / "view_default")], k1, "bf16"),
                ("http", ["--viewer-mode", "http", "--viewer-port", "0"], k1, "bf16"),
                ("files int8_direct", ["--viewer", str(tmp / "view_int8"), "--precision",
                                       "int8_direct"], k3, "s8")):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                text, _ = run_cli(base + extra, {name: 8},
                                  f"live --frames 64 --batch 8 {' '.join(extra[:2])} "
                                  f"({what}: {name}, one launch per group)")
            check("processed 64 frames" in text, f"live {what}: {text}")
            counts[(name, op)] = counts.get((name, op), 0) + 8
            if what == "http":
                check("live viewer at http://127.0.0.1:" in err.getvalue(),
                      f"live --viewer-mode http printed no URL: {err.getvalue()[-300:]}")
                continue
            shapes = {n: read_png(Path(extra[1]) / f"{n}.png").shape
                      for n in ("show", "status", "bscan")}
            check(shapes == {"show": (cfg.oph, cfg.opw), "status": (300, 600),
                             "bscan": (calib.ndisp, cfg.oph, 3)}, f"live {what}: {shapes}")
            phase("viewer", f"live {what}: windows decode as {shapes}")

        # the group time with each viewer: process_group + show_session_frame
        # in one call, one group a call, turns N F H H F N
        ms = {"none": [], "files": [], "http": []}
        for mode in ("none", "files", "http", "http", "files", "none"):
            view = (None if mode == "none" else
                    Viewer(mode=mode, outdir=tmp / "timed", port=0))
            try:
                def step(i):
                    r = s.process_group(groups[i % len(groups)])[-1]
                    if view is not None:
                        view.show_session_frame(s, groups[i % len(groups)][-1], r)
                step(0)
                for i in range(VIEWER_TIMED_GROUPS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(i)
                    ms[mode].append((time.perf_counter() - t0) * 1e3)
            finally:
                if view is not None:
                    view.close()
        phase("viewer", "Session.process_group + show_session_frame per group (base 'default', "
              f"8 frames 512x2048 u8; host clock, {VIEWER_TIMED_GROUPS} groups a turn, turns N F H "
              "H F N): " + "; ".join(
                  f"{mode} median {statistics.median(t):.3f} ms (min {min(t):.3f}, max "
                  f"{max(t):.3f})" for mode, t in ms.items()) + f" | {card_line}")

    images = {"show": groups[-1][-1], "bscan": render_bscan(r.bscandisp, s.ascanat),
              "status": render_status(s.status[-6:])}
    enc = {n: host_ms(lambda img=img: encode_png(img)) for n, img in images.items()}
    rend = {"bscan": host_ms(lambda: render_bscan(r.bscandisp, s.ascanat)),
            "status": host_ms(lambda: render_status(s.status[-6:]))}
    phase("viewer", "encode_png per window (zlib level 1; host clock, median of 20): " + "; ".join(
        f"{n} {images[n].shape} {t[0]:.3f} ms (min {t[1]:.3f}), {len(encode_png(images[n]))} "
        f"bytes" for n, t in enc.items()) + "; render_bscan " + f"{rend['bscan'][0]:.3f} ms, "
        f"render_status {rend['status'][0]:.3f} ms | {card_line}")
    return counts


def synthetic_frames(cfg, depths_of_frame, reflectivities) -> tuple[np.ndarray, np.ndarray]:
    """One flagship frame per entry of ``depths_of_frame`` (µm), built as
    tests/test_doppler.py builds them, and the background S(k) floored at 1."""
    from fdoct_tpu_torch.sources.synthetic import SyntheticSource

    frames, bg = [], None
    for depths in depths_of_frame:
        src = SyntheticSource(height=cfg.height, width=cfg.width, lambda0=cfg.lambda0,
                    dlambda=cfg.lambdabw * 2.3548 / 4.0, depths_um=depths,
                    reflectivities=reflectivities)
        frames.append(next(iter(src.frames())))
        bg = np.maximum(src.background(), 1)
    return np.stack(frames), bg


def no_launch(fn, what: str):
    """``fn()`` with the launch counts set to 0 just before and read just
    after: it must launch no kernel."""
    from fdoct_tpu_torch.ops import kernels
    from fdoct_tpu_torch.ops.kernels import LAUNCHES

    kernels.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    ran = {k: n for k, n in LAUNCHES.items() if n}
    check(ran == {}, f"{what} launched {ran}")
    return out


def analysis_phase(cfg, calib, calib64, card_line: str, dev: torch.device) -> None:
    """Phase 15, the analysis modules on the card, each launching no kernel:
    Doppler and OCT-A on flagship frames at 'default' and 'highest' against
    the float64 Doppler on the card, the spectrometer and the Wang
    estimators in float32 against float64 numpy."""
    from fdoct_tpu_torch.doppler import doppler_bscan, octa_bscan
    from fdoct_tpu_torch.ops.fft import ifft_mag_rows
    from fdoct_tpu_torch.ops.resample import resample_klinear
    from fdoct_tpu_torch.ops.wang import (
        deconvolved_ift, differential_deconvolved_ift, ift_reflectivity, wang_interferogram_pair,
    )
    from fdoct_tpu_torch.sources.spectrometer import (
        calibration_from_lambdas, reconstruct_spectrometer_ascans,
    )

    cfg = cfg.replace(donotnormalize=True)
    cfg64 = cfg.replace(dtype="float64")
    step = DOPPLER_STEP_NM
    raw, bg = synthetic_frames(cfg, [(50.0 + t * step * 1e-3,) for t in range(DOPPLER_FRAMES)],
                               (0.5,))
    rng = np.random.default_rng(11)
    jraw, jbg = synthetic_frames(cfg, [(50.0 + rng.uniform(-2, 2), 90.0)
                                       for _ in range(DOPPLER_FRAMES)], (0.5, 0.5))
    runs = {}
    for name, frames_np, bg_np in (("doppler", raw, bg), ("octa", jraw, jbg)):
        fr = torch.as_tensor(frames_np).to(dev)
        b32 = torch.as_tensor(bg_np).to(dev, torch.float32)
        fn = doppler_bscan if name == "doppler" else octa_bscan
        runs[name] = {p: (lambda fn=fn, fr=fr, b=b32, p=p:
                          fn(fr, b, torch.zeros_like(b), calib, cfg, precision=p))
                      for p in ("default", "highest")}
        runs[name]["float64"] = (lambda fn=fn, fr=fr, b=b32.double():
                                 fn(fr, b, torch.zeros_like(b), calib64, cfg64))
    out = {(name, p): tuple(t.cpu().numpy() for t in no_launch(fn, f"{name} {p}"))
           for name, rs in runs.items() for p, fn in rs.items()}
    mag64, vel64 = out[("doppler", "float64")]
    strong = mag64 > 0.2 * mag64.max()
    peak = int(np.argmax(mag64[5:].mean(axis=1))) + 5
    macs = 2 * DOPPLER_FRAMES * cfg.oph * cfg.opw * calib.ndisp
    bound = {"bf16": 2 * macs / PEAK["bf16"] * 1e3, "f32": 2 * macs / F32_SIMT_PEAK * 1e3}
    for p in ("default", "highest", "float64"):
        mag, vel = out[("doppler", p)]
        at_peak = float(np.median(vel[peak])) * 1e9
        err_nm = float(np.abs(vel[strong] - vel64[strong]).max()) * 1e9
        med, lo, _ = cuda_ms(runs["doppler"][p], runs=10, warmup=2)
        limit = f"limit {DOPPLER_TOL_NM[p]}" if p in DOPPLER_TOL_NM else "the reference itself"
        phase("analysis", f"doppler_bscan {p}: {mag.shape} {vel.dtype}, no launch; velocity "
              f"at the scatterer (depth bin {peak}, median of {vel.shape[1]} A-scans) "
              f"{at_peak:.4f} nm/frame for a {step} nm step (limit {DOPPLER_STEP_TOL:.0%}); "
              f"worst velocity error vs float64 on {int(strong.sum())} voxels above twice the "
              f"floor {err_nm:.3e} nm ({limit}); device median "
              f"{med:.3f} ms (min {lo:.3f}; 10 calls, CUDA events) against a bound of "
              f"{macs / 1e9:.2f} G multiply-adds: {bound['bf16']:.4f} ms at the bf16 peak, "
              f"{bound['f32']:.3f} ms as f32 outside the tensor cores | {card_line}")
        check(abs(at_peak - step) <= DOPPLER_STEP_TOL * step,
              f"doppler {p}: {at_peak} nm/frame for a {step} nm step")
        check(err_nm <= DOPPLER_TOL_NM.get(p, 0.0), f"doppler {p}: {err_nm} nm")
    mag64, sv64 = out[("octa", "float64")]
    strong = mag64 > 0.2 * mag64.max()
    flow = float(sv64[peak - 2:peak + 3].max())
    static = float(sv64[round(peak * 90 / 50) - 2:round(peak * 90 / 50) + 3].max())
    check(flow > 10 * static, f"octa float64: flow {flow} vs static {static}")
    for p in ("default", "highest"):
        _, sv = out[("octa", p)]
        err = float(np.abs(sv[strong] - sv64[strong]).max() / np.abs(sv64[strong]).max())
        med, lo, _ = cuda_ms(runs["octa"][p], runs=10, warmup=2)
        phase("analysis", f"octa_bscan {p}: no launch; speckle variance at the jittering "
              f"scatterer {float(sv[peak - 2:peak + 3].max()):.4f} vs the static one "
              f"{float(sv[round(peak * 90 / 50) - 2:round(peak * 90 / 50) + 3].max()):.4f} "
              f"(float64: {flow:.4f} vs {static:.4f}); worst error vs float64 above twice the "
              f"floor {err:.3e} of its peak (limit {OCTA_TOL[p]}); device median {med:.3f} ms "
              f"(min {lo:.3f}) | {card_line}")
        check(err <= OCTA_TOL[p], f"octa {p}: {err} of the peak against float64")

    # the spectrometer: measured-λ A-scans of the reference's width, nfft 3x
    rng = np.random.default_rng(SEED + 15)
    n = SPEC_PIXELS
    lam = np.linspace(816e-9, 884e-9, n) + 1e-11 * np.sin(np.linspace(0, 6, n))
    k = 2 * np.pi / lam
    S = np.exp(-0.5 * ((lam - 850e-9) / 17e-9) ** 2)
    z = rng.uniform(30e-6, 300e-6, (SPEC_ASCANS, 1))
    dark = 5.0 + rng.uniform(0, 0.5, n)
    data = dict(ascans=1000 * S * (1.25 + np.cos(2 * k * z)) + dark
                + rng.normal(0, 0.5, (SPEC_ASCANS, n)),
                lambdas_m=lam, dark=dark, ref_arm=500 * S + dark, sample_arm=250 * S + dark,
                pi_frames=1000 * S * (1.25 - np.cos(2 * k * z)) + dark)
    nfft, ndisp = 3 * n, n
    got = no_launch(lambda: reconstruct_spectrometer_ascans(**data, nfft=nfft, ndisp=ndisp,
                                                            device=dev), "spectrometer")
    tab = calibration_from_lambdas(lam, nfft, ndisp)
    d = data["dark"]
    a = ((data["ascans"] - d) - (data["pi_frames"] - d)) / (
        (data["ref_arm"] - d) + (data["sample_arm"] - d))
    a = (a - a.mean(axis=-1, keepdims=True)) * tab["window"]
    slope = np.diff(a, axis=-1)
    slope = np.concatenate([slope[:, :1], slope], axis=-1)
    i = tab["nearest_idx"]
    want = (np.abs(np.fft.ifft(a[:, i] - tab["frac"] * slope[:, i], axis=-1)) * nfft)[:, :ndisp]
    res = compare(torch.as_tensor(got), torch.as_tensor(want), ANALYSIS_RTOL,
                  ANALYSIS_RTOL * float(np.abs(want).max()))
    call_ms = host_ms(lambda: reconstruct_spectrometer_ascans(**data, nfft=nfft, ndisp=ndisp,
                                                              device=dev), runs=5)
    ad = torch.as_tensor(a, dtype=torch.float32).to(dev)
    idx = torch.as_tensor(i, dtype=torch.long).to(dev)
    frac = torch.as_tensor(tab["frac"], dtype=torch.float32).to(dev)
    dev_ms = cuda_ms(lambda: ifft_mag_rows(resample_klinear(ad, idx, frac, compat=False)),
                     runs=10, warmup=2)
    phase("analysis", f"reconstruct_spectrometer_ascans {SPEC_ASCANS} x {n} px, measured "
          f"lambda, nfft {nfft}: {got.shape} {got.dtype}, no launch; vs float64 numpy max_abs_err "
          f"{res['max_abs_err']:.3e}, worst {res['worst_share_of_tol']:.3e} of tol "
          f"(rtol=atol/max={ANALYSIS_RTOL}); whole call (host stage, H2D, D2H) median "
          f"{call_ms[0]:.3f} ms host clock, resample + |IFFT| on the card {dev_ms[0]:.3f} ms "
          f"(CUDA events) | {card_line}")
    check(res["finite"] and res["worst_share_of_tol"] <= 1.0,
          "the spectrometer disagrees with float64 numpy")

    # the Wang estimators: rows of the n = 1024 pair, the first depth varied
    rows = [wang_interferogram_pair(depths_m=(90e-6 + r * 0.1e-6, 150e-6),
                                    reflectivities=(0.5, 0.25), n=WANG_N)
            for r in range(WANG_ROWS)]
    I1, I2 = (np.stack([row[j] for row in rows]) for j in (0, 1))
    S = rows[0][2]
    t1, t2, ts = (torch.as_tensor(x, dtype=torch.float32).to(dev) for x in (I1, I2, S))
    ests = {"ift_reflectivity": (lambda: ift_reflectivity(t1), I1),
            "deconvolved_ift": (lambda: deconvolved_ift(t1, ts), I1 / S),
            "differential_deconvolved_ift": (lambda: differential_deconvolved_ift(t1, t2, ts),
                                             (I1 - I2) / S)}
    for name, (fn, x) in ests.items():
        got = no_launch(fn, name)
        want = np.abs(np.fft.fftshift(np.fft.ifft(x, axis=-1), axes=-1)) / np.sqrt(WANG_N)
        res = compare(got, torch.as_tensor(want).to(dev), ANALYSIS_RTOL,
                      ANALYSIS_RTOL * float(np.abs(want).max()))
        med, lo, _ = cuda_ms(fn, runs=10, warmup=2)
        phase("analysis", f"{name} float32 {tuple(got.shape)}: no launch; vs float64 numpy "
              f"max_abs_err {res['max_abs_err']:.3e}, worst {res['worst_share_of_tol']:.3e} of "
              f"tol (rtol=atol/max={ANALYSIS_RTOL}); device median {med:.4f} ms (min {lo:.4f}) "
              f"| {card_line}")
        check(res["finite"] and res["worst_share_of_tol"] <= 1.0,
              f"{name} disagrees with float64 numpy")


def eager_all_reduce_ms(mesh) -> float:
    """Median host ms of an eager all-reduce of 4 bytes over 'data', to its
    end on the device: what each of the command line's per-batch broadcasts
    pays, beside a communicator that a graph also holds or not."""
    import torch.distributed as dist

    from fdoct_tpu_torch.parallel import mesh_device

    x = torch.zeros(1, device=mesh_device(mesh))
    return host_ms(lambda: (dist.all_reduce(x, group=mesh.get_group("data")),
                            torch.cuda.synchronize()))[0]


def mesh_turns(tree: Path) -> int:
    """``python3 chip_smoke.py --mesh-turns [--tree DIR]``: phase 16's mesh
    group times of the checkout DIR (default: this file's), measured by this
    file's code, so that one call can time two commits in turns (parent,
    change, change, parent; unpack the parent with ``git archive <commit> |
    tar -x -C build/parent``).  It uses only what every commit of the port
    since the mesh has: ``Session(mesh=)``, ``WorldOfOne``, ``make_mesh``,
    ``Calibration.create``, ``SyntheticSource``, the launch and
    collective-byte counters.  For 'base' at 'default' and 'highest' on a
    world of one with nccl: a single-device session and a 1 x 1 mesh session
    on the same calibration frames, 4 batches of 2 flagship groups; the
    single-device group ms before the mesh session's first batch and an
    eager 4-byte all-reduce's ms before it and after the turns; one
    batch's launches and collective bytes (counts set to 0 just before,
    read just after); the SHA-256 of both sessions' outputs (uint8
    displays, dB and linear B-scans) over the 4 batches, equal across the
    trees where their outputs are bit-equal; the host-clock ms per group of
    each, turns single, mesh, mesh, single; the mesh session's profiled
    breakdown; its graphs' pools (none where the mesh runs eagerly).  One
    JSON line per precision, the card's name and power limit in each."""
    import hashlib

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(tree.resolve()))
    import fdoct_tpu_torch
    from fdoct_tpu_torch.bench_resident import card_line as card
    from fdoct_tpu_torch.calibration import Calibration
    from fdoct_tpu_torch.config import PipelineConfig
    from fdoct_tpu_torch.ops import _build
    from fdoct_tpu_torch.parallel import WorldOfOne, make_mesh
    from fdoct_tpu_torch.session import Session
    from fdoct_tpu_torch.sources.synthetic import SyntheticSource
    check(Path(fdoct_tpu_torch.__file__).resolve().is_relative_to(tree.resolve()),
          f"imported {fdoct_tpu_torch.__file__}, not the tree {tree}")
    check("jax" not in sys.modules, "the port imported jax")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, card_line = torch.device("cuda"), card()
    _build.load()
    cfg = PipelineConfig(**FLAGSHIP)
    calib = Calibration.create(cfg, dev)
    src = SyntheticSource(height=cfg.height, width=cfg.width, lambda0=cfg.lambda0,
                          dlambda=cfg.lambdabw * 2.3548 / 4.0, noise=0.02, seed=SEED)
    frames = src.frames()
    batches = [np.stack([next(frames) for _ in range(2 * cfg.averages)]) for _ in range(4)]
    yb = torch.as_tensor(np.maximum(src.background(), 1)).to(dev, torch.float32)
    yp = torch.as_tensor(src.pi_frame()).to(dev, torch.float32)
    with WorldOfOne("cuda"):
        mesh = make_mesh(1, 1, device_type="cuda")
        for precision in ("default", "highest"):
            sessions = {}
            for who, m in (("single", None), ("mesh", mesh)):
                sessions[who] = s = Session(cfg.replace(matmul_precision=precision), device=dev,
                                            calib=calib, mesh=m)
                s.data_yb, s.data_yp = yb, yp
            line = {"tree": str(tree), "precision": precision, "card": card_line,
                    "eager_all_reduce_ms": [eager_all_reduce_ms(mesh)],
                    "single_group_ms_before_the_mesh": statistics.median(
                        host_group_ms(sessions["single"], batches))}
            for who, s in sessions.items():
                digest = hashlib.sha256()
                for b in batches:
                    for r in s.process_group(b):
                        for x in (r.bscandisp, r.bscandb.cpu().numpy(), r.bscan.cpu().numpy()):
                            digest.update(np.ascontiguousarray(x).tobytes())
                _, launched, moved = counted(lambda s=s: s.process_group(batches[0]))
                line[who] = {"outputs_sha256": digest.hexdigest(), "launches_a_batch": launched,
                             "collective_bytes_a_batch": moved}
            for who in ("single", "mesh", "mesh", "single"):
                line[who].setdefault("group_ms_turns", []).append(
                    statistics.median(host_group_ms(sessions[who], batches)))
            line["mesh"]["profiled"] = device_breakdown(
                lambda: [sessions["mesh"].process_group(b) for b in batches], 2 * len(batches))
            line["mesh"]["graph_pools_mib"] = [c.pool_bytes / 2**20
                                               for _, c in sessions["mesh"].graphs.items()]
            line["eager_all_reduce_ms"].append(eager_all_reduce_ms(mesh))
            for s in sessions.values():
                s.close()                    # its graphs go before the world's communicators
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    if "--mesh-turns" in sys.argv[1:]:
        args = sys.argv[1:]
        sys.exit(mesh_turns(Path(args[args.index("--tree") + 1]) if "--tree" in args
                            else Path(__file__).resolve().parent))
    sys.exit(main())
