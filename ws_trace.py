#!/usr/bin/env python3
"""A clock64 trace of the stage loops of the warp-specialised schedules
(fused_recon_ws_kernel of the bf16 instances and fused_recon_ws32_kernel of
the f32-operator ones, in fdoct_tpu_torch/csrc/fused_recon.cu, and
int8_bscan_ws_kernel of kernel 3, in csrc/int8_bscan.cu), on one NVIDIA
GPU.

    python3 ws_trace.py --make DIR    # DIR/fdoct_tpu_torch: this checkout's package, traced
    python3 ws_trace.py --read DIR    # its seven instances at the flagship, once each
    python3 ws_trace.py --make DIR --loads-only

``--make`` copies this checkout's package and inserts the trace into the
kernels' sources (TRACE_EDITS and INT8_TRACE_EDITS, each anchor found
exactly once, else it raises).  With ``--loads-only`` it inserts no trace
and strips the bf16 schedule's work instead (LOADS_ONLY_EDITS): the
forming warpgroup waits for each stage and a free A tile, then announces
the tile and releases the stage without forming or storing it; the
consumers wait for the stage and its A tile and release both as before,
without issuing a wgmma; the producer is unchanged.  Its results are wrong
by design: time it (``bench_sessions.py --kernels-only --tree DIR``) for
the floor that the loads and the ring's handoffs alone set.  The edits
are anchored to this checkout's source: for another checkout's floor, run
that checkout's own ws_trace.py.

The trace.  ws32: lane 0 of every consumer warp adds its cycles [0]
waiting for a stage to land, [1] forming its A values (loads, arithmetic
and the TF32 split, into registers), [4] issuing the wgmmas, [5] waiting
for them, releasing the slot and adding the stage's fragment to the sums,
[6] in the chunk epilogue ([2] and [3] stay 0).  ws: lane 0 of every
consumer warp adds [0] waiting for the stage, [9] then for its A tile, [4]
issuing the wgmmas, [5] adding a round's fragment, waiting for the stage
before's wgmmas and releasing its slot and A tile, [6] the chunk's end;
lane 0 of every warp of the forming warpgroup adds [2] waiting for the
stage, [1] forming A, [10] waiting for a free A tile, [3] storing A with
its fence and announcing it.  The consumer warps add [7] their stages; [8]
sums the producer's cycles waiting for a free slot.  ``fdoct_ws_trace_read``
returns the eleven sums and clears them.  In kernel 3 (INT8_PARTS; no A to
form, no barrier) a consumer warp's stage has [0] the wait for the stage,
[4] the issue, [5] the wait for the stage before's wgmmas and the slot's
release, [6] the chunk's end (the wait for its last wgmmas and, past 8
frames, the dequantisation), and once a warp, after the loop, [2] the
dequantisation of a group of at most 8 frames, [3] the frame-slot sum and
[1] the display epilogue with its stores and atomics;
``fdoct_int8_trace_read`` returns its sums.  ``--read``
(on the card) calls kernel 1 on u8 and on u16 frames and kernel 2 on the
f32 ratio at the flagship inputs of bench_sessions.py, each with the bf16
operator and with the f32 one (given the Calibration's TF32 table, packed
once outside the calls), and kernel 3 on bench_sessions.py's int8 inputs,
once each after a warm-up, and prints the cycles a consumer warp (and for
the bf16 instances a forming warp) spends a stage in each part (kernel 3's
part [1] a warp) and the producer's wait a stage.
The trace adds a few per cent of device time; time a traced tree with
``bench_sessions.py --kernels-only --tree DIR``.  Every line printed is one
JSON object with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
#: the parts of a consumer warp's stage, in the order of the counters
PARTS = ("wait full", "form A", "first barrier", "store A + fence + barrier", "issue wgmma",
         "wait wgmma + release", "chunk epilogue")
#: the bf16 schedule's parts (the counter of each): a consumer warp's stage, and
#: a forming warp's
WS_CONSUMER_PARTS = {"wait for the stage": 0, "wait for its A tile": 9, "issue wgmma": 4,
                     "wait wgmma + release + add a round's fragment": 5, "chunk epilogue": 6}
WS_FORMER_PARTS = {"wait for the stage": 2, "form A": 1, "wait for a free A tile": 10,
                   "store A + fence + announce": 3}
#: kernel 3's parts: the counter of each; the last three once a warp, after the loop
INT8_PARTS = {"wait full": 0, "issue wgmma": 4, "wait wgmma + release": 5,
              "chunk end": 6, "dequantise (a warp)": 2, "slot sum (a warp)": 3,
              "display epilogue (a warp)": 1}

_COUNTERS = """// The stage trace (ws_trace.py): cycles a part of the loop, summed over
// the consumer warps' lane 0, and the producer's waits for a free slot.
__device__ unsigned long long ws_trace_cycles[11];
#define WS_TRACE_START unsigned ws_tr[9] = {}; long long ws_mark = clock64()
#define WS_MARK(i) do { const long long now = clock64(); ws_tr[i] += static_cast<unsigned>(now - ws_mark); ws_mark = now; } while (0)
#define WS_TRACE_END(stages) do { if ((threadIdx.x & 31) == 0) { _Pragma("unroll") for (int i = 0; i < 7; ++i) atomicAdd(&ws_trace_cycles[i], static_cast<unsigned long long>(ws_tr[i])); atomicAdd(&ws_trace_cycles[7], static_cast<unsigned long long>(stages)); atomicAdd(&ws_trace_cycles[9], static_cast<unsigned long long>(ws_tr[7])); atomicAdd(&ws_trace_cycles[10], static_cast<unsigned long long>(ws_tr[8])); } } while (0)

"""
_READ = """int fdoct_ws_trace_read(unsigned long long* host) {
  cudaError_t rc = cudaMemcpyFromSymbol(host, ws_trace_cycles, sizeof(ws_trace_cycles));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned long long zero[11] = {};
  return static_cast<int>(cudaMemcpyToSymbol(ws_trace_cycles, zero, sizeof(zero)));
}

"""


def _after(anchor: str, text: str) -> tuple[str, str]:
    return anchor, anchor + text


#: edits of fused_recon.cu: (text found exactly once, text put in its place)
TRACE_EDITS = [
    ("// Eight samples 8c..8c+7 of pair m", _COUNTERS + "// Eight samples 8c..8c+7 of pair m"),
    *(("        if (it >= nst) mbar_wait(&empty[s], ph ^ 1);\n"
       f"        mbar_expect_tx(&full[s], sbytes);\n        const int k0 = kt * {ns}::KT;\n",
       "        if (it >= nst) {\n          const long long t0 = clock64();\n"
       "          mbar_wait(&empty[s], ph ^ 1);\n"
       "          atomicAdd(&ws_trace_cycles[8], static_cast<unsigned long long>(clock64() - t0));\n"
       f"        }}\n        mbar_expect_tx(&full[s], sbytes);\n        const int k0 = kt * {ns}::KT;\n")
      for ns in ("ws", "ws32")),
    # ws: the forming warpgroup's parts [1]-[3], its consumers' [0], [4]-[6]
    _after("    const int t = tid & 127;\n", "    WS_TRACE_START;\n"),
    _after("      mbar_wait(&full[s], ph);\n      uint32_t a[4][4];\n", "      WS_MARK(2);\n"),
    _after("        ws_form_a<In, false>(a, st, t, B - b0);\n", "      WS_MARK(1);\n"),
    _after("      if (it >= ws::A_TILES) mbar_wait(&a_empty[ai], aph ^ 1);\n", "      WS_MARK(8);\n"),
    _after("        mbar_arrive(&a_full[ai]);\n        mbar_arrive(&empty[s]);\n      }\n",
           "      WS_MARK(3);\n"),
    ("      if (++ai == ws::A_TILES) ai = 0, aph ^= 1;\n    }\n    return;\n",
     "      if (++ai == ws::A_TILES) ai = 0, aph ^= 1;\n    }\n    WS_TRACE_END(0);\n"
     "    return;\n"),
    _after("  const uint32_t b_mine = 2 * wg * ws::OP_BOX;             // its B: boxes re, im of "
           "its depths\n", "  WS_TRACE_START;\n"),
    _after("    mbar_wait(&full[s], ph);           // B has landed\n", "    WS_MARK(0);\n"),
    _after("    mbar_wait(&a_full[ai], aph);       // A is formed\n", "    WS_MARK(7);\n"),
    ("    const uint32_t a_addr = smem_addr(a_tiles + ai * ws::A_BYTES);\n",
     "    WS_MARK(5);\n    const uint32_t a_addr = smem_addr(a_tiles + ai * ws::A_BYTES);\n"),
    _after("                          !fresh || kk > 0);\n    wgmma_commit();\n",
           "    WS_MARK(4);\n"),
    _after("        mbar_arrive(&a_empty[ai == 0 ? ws::A_TILES - 1 : ai - 1]);\n      }\n    }\n",
           "    WS_MARK(5);\n"),
    _after("      if constexpr (MULTI) {\n        ws_add_magnitudes(mag, acc);\n#pragma unroll\n"
           "        for (int i = 0; i < 64; ++i) acc[i] = 0.f;\n      }\n    }\n",
           "    WS_MARK(6);\n"),
    ("    if (++ai == ws::A_TILES) ai = 0, aph ^= 1;\n  }\n  if constexpr (MULTI) {\n",
     "    if (++ai == ws::A_TILES) ai = 0, aph ^= 1;\n  }\n  WS_TRACE_END(total);\n"
     "  if constexpr (MULTI) {\n"),
    ("    if (++kt == nk) kt = 0, b0 += 1 << fs;\n  }\n  if constexpr (MULTI) {\n"
     "    ws_store_sums<8>(mag, out, m0, frame, fs, row0, col0,",
     "    if (++kt == nk) kt = 0, b0 += 1 << fs;\n  }\n  WS_TRACE_END(total);\n"
     "  if constexpr (MULTI) {\n    ws_store_sums<8>(mag, out, m0, frame, fs, row0, col0,"),
    # ws32: A formed in registers, no A tile (parts 2 and 3 stay 0)
    ("  for (int i = 0; i < (MULTI ? 32 : 1); ++i) mag[i] = 0.f;\n  for (int it = 0",
     "  for (int i = 0; i < (MULTI ? 32 : 1); ++i) mag[i] = 0.f;\n  WS_TRACE_START;\n"
     "  for (int it = 0"),
    _after("    mbar_wait(&full[s], ph);\n    uint32_t hi[4][4], lo[4][4];\n", "    WS_MARK(0);\n"),
    _after("      ws32_form_a<In, false>(hi, lo, st, m0, tq, B - b0);\n", "    WS_MARK(1);\n"),
    _after("      wgmma_m64n128k8_tf32_rs(part, hi[kk], wgmma_desc_k_sw128(b_hi + 32 * kk), 1);\n"
           "    }\n    wgmma_commit();\n", "    WS_MARK(4);\n"),
    _after("    if (lane == 0) mbar_arrive(&empty[s]);   // stage it's slot: its A formed, its table read\n"
           "    ws_add_fragment(acc, part);\n",
           "    WS_MARK(5);\n"),
    _after("// the last stage of a chunk of frames\n        ws_add_magnitudes(mag, acc);\n"
           "#pragma unroll\n        for (int i = 0; i < 64; ++i) acc[i] = 0.f;\n      }\n    }\n",
           "    WS_MARK(6);\n"),
    ('}  // extern "C"', _READ + '}  // extern "C"'),
]


#: edits of int8_bscan.cu (its counters live in its anonymous namespace)
INT8_TRACE_EDITS = [
    ("// This thread's magnitudes += |x| of one chunk's s32 sums",
     _COUNTERS + "// This thread's magnitudes += |x| of one chunk's s32 sums"),
    ("        if (it >= nst) mbar_wait(&empty[s], ph ^ 1);\n",
     "        if (it >= nst) {\n          const long long t0 = clock64();\n"
     "          mbar_wait(&empty[s], ph ^ 1);\n"
     "          atomicAdd(&ws_trace_cycles[8], static_cast<unsigned long long>(clock64() - t0));\n"
     "        }\n"),
    _after("  for (int i = 0; i < 64; ++i) mag[i] = 0.f;\n", "  WS_TRACE_START;\n"),
    _after("    mbar_wait(&full[s], ph);\n", "    WS_MARK(0);\n"),
    _after("    wgmma_commit();\n", "    WS_MARK(4);\n"),
    _after("      if (lane == 0) mbar_arrive(&empty[s == 0 ? nst - 1 : s - 1]);\n    }\n",
           "    WS_MARK(5);\n"),
    _after("i8ws_add_magnitudes(mag, acc, tables, rr, tq);\n      }\n    }\n",
           "    WS_MARK(6);\n"),
    _after("    if (frame < B) i8ws_add_magnitudes(mag, acc, tables, rr, tq);\n  }\n",
           "  WS_MARK(2);\n"),
    _after("  i8ws_halve<16>(z, u, frame & 4, 16);\n", "  WS_MARK(3);\n"),
    ("    atomic_max_f32(mx + tile, hi);\n  }\n}\n\n// Whether TMA",
     "    atomic_max_f32(mx + tile, hi);\n  }\n  WS_MARK(1);\n  WS_TRACE_END(total);\n}\n\n"
     "// Whether TMA"),
    ("// Plain C entry point for ctypes.",
     'extern "C" ' + _READ.replace("fdoct_ws_trace_read", "fdoct_int8_trace_read")
     + "// Plain C entry point for ctypes."),
]


#: edits of fused_recon.cu for --loads-only: the bf16 schedule's forming
#: warpgroup forms and stores no A tile, its consumers issue no wgmma
LOADS_ONLY_EDITS = [
    ("      if (B - b0 < (1 << fs))          // the group's last chunk, short of eight frames\n"
     "        ws_form_a<In, true>(a, st, t, B - b0);\n      else\n"
     "        ws_form_a<In, false>(a, st, t, B - b0);\n", ""),
    ("      ws_store_a(a_tiles + ai * ws::A_BYTES, a, t);\n", ""),
    ("#pragma unroll\n    for (int kk = 0; kk < 4; ++kk)     // a round's first k16 step starts its "
     "fragment at zero\n      wgmma_m64n128k16_ss(part, wgmma_desc_k_sw128(a_addr + kk * 32),\n"
     "                          wgmma_desc_mn_sw128(b_addr + kk * 16 * 128, ws::OP_BOX, 1024),\n"
     "                          !fresh || kk > 0);\n", ""),
]


def make(dest: Path, loads_only: bool = False) -> Path:
    """DEST/fdoct_tpu_torch: this checkout's package with the trace in
    fused_recon.cu and int8_bscan.cu, or with ``loads_only`` the bf16
    schedule without its forming and its wgmmas."""
    shutil.rmtree(dest / "fdoct_tpu_torch", ignore_errors=True)
    shutil.copytree(ROOT / "fdoct_tpu_torch", dest / "fdoct_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    plan = ((("fused_recon.cu", LOADS_ONLY_EDITS),) if loads_only else
            (("fused_recon.cu", TRACE_EDITS), ("int8_bscan.cu", INT8_TRACE_EDITS)))
    for name, edits in plan:
        path = dest / "fdoct_tpu_torch" / "csrc" / name
        text = path.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"ws_trace: {old.strip()[:60]!r} occurs {text.count(old)} "
                                   f"times in {name}; bring its edits up to date")
            text = text.replace(old, new)
        path.write_text(text)
    return dest


def read(tree: Path) -> int:
    sys.path.insert(0, str(tree))             # before the package is first imported
    from bench_sessions import int8_inputs, kernel_inputs
    from chip_smoke import FLAGSHIP, SEED
    from fdoct_tpu_torch.bench_resident import card_line
    from fdoct_tpu_torch.calibration import Calibration
    from fdoct_tpu_torch.config import PipelineConfig
    from fdoct_tpu_torch.ops import _build, kernels
    from fdoct_tpu_torch.sources.synthetic import SyntheticSource
    if not Path(kernels.__file__).resolve().is_relative_to(tree):
        raise RuntimeError(f"imported {kernels.__file__}, not the one under {tree}")
    lib = _build.load()
    trace, int8_trace = (getattr(lib, f, None) for f in ("fdoct_ws_trace_read",
                                                         "fdoct_int8_trace_read"))
    if trace is None or int8_trace is None:
        raise RuntimeError(f"{tree} has no trace: make it with --make")
    trace.argtypes = int8_trace.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    cfg = PipelineConfig(**FLAGSHIP)
    src = SyntheticSource(height=cfg.height, width=cfg.width, lambda0=cfg.lambda0,
                          dlambda=cfg.lambdabw * 2.3548 / 4.0, noise=0.02, seed=SEED)
    x = kernel_inputs(cfg, Calibration.create(cfg, dev), src, src.frames(), dev)
    calls = {}
    for op in ("bf16", "f32"):
        kw = {"op_tf32": x["tf32"]} if op == "f32" else {}
        calls.update({
            f"raw u8 {op}": lambda op=op, kw=kw: kernels.fused_recon_raw_accumulate(
                x["raw"], x["pi"], x["inv"], *x[op], **kw),
            f"raw u16 {op}": lambda op=op, kw=kw: kernels.fused_recon_raw_accumulate(
                x["raw16"], x["pi"], x["inv"], *x[op], **kw),
            f"yr f32 {op}": lambda op=op, kw=kw: kernels.fused_recon_accumulate(
                x["yr"], *x[op], **kw)})
    card = card_line()
    sums = (ctypes.c_ulonglong * 11)()
    for name, fn in calls.items():
        for _ in range(2):            # a warm-up call, its counts cleared; then the one read
            fn()
            torch.cuda.synchronize()
            if trace(ctypes.addressof(sums)) != 0:
                raise RuntimeError("fdoct_ws_trace_read failed")
        stages = sums[7]
        if name.endswith("bf16"):          # four forming warps beside eight consumer warps
            parts = {"consumer": {p: sums[i] / stages for p, i in WS_CONSUMER_PARTS.items()},
                     "former": {p: sums[i] / (stages / 2) for p, i in WS_FORMER_PARTS.items()}}
        else:
            parts = {p: sums[i] / stages for i, p in enumerate(PARTS)}
        print(json.dumps({"tree": str(tree), "kernel": name, "warp_stages": stages,
                          "cycles_per_warp_stage": parts,
                          "producer_wait_cycles_per_stage": sums[8] / (stages / 8),
                          "card": card}), flush=True)
    i8 = int8_inputs(cfg, Calibration.create(cfg, dev), src, src.frames(), dev)
    s8 = i8["args"][0]
    for _ in range(2):
        kernels.int8_bscan_display_fused(*i8["args"], i8["thresh"], s8.shape[0],
                                         oq_packed=i8["packed"])
        torch.cuda.synchronize()
        if int8_trace(ctypes.addressof(sums)) != 0:
            raise RuntimeError("fdoct_int8_trace_read failed")
    stages = sums[7]
    per_warp = -(-s8.shape[-1] // 128) * -(-s8.shape[0] // 8)      # stages a warp: nk x chunks
    warps = stages / per_warp
    print(json.dumps({"tree": str(tree), "kernel": "int8 s8", "warp_stages": stages,
                      "cycles_per_warp_stage": {p: sums[i] / (warps if i in (1, 2, 3)
                                                              else stages)
                                                for p, i in INT8_PARTS.items()},
                      "producer_wait_cycles_per_stage": sums[8] / (stages / 8),
                      "card": card}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--make", metavar="DIR", help="write DIR/fdoct_tpu_torch, traced")
    group.add_argument("--read", metavar="DIR", help="read the trace of DIR's seven instances")
    ap.add_argument("--loads-only", action="store_true",
                    help="with --make: no trace; the bf16 schedule without forming or wgmma")
    args = ap.parse_args(argv)
    if args.make:
        print(make(Path(args.make).resolve(), args.loads_only))
        return 0
    if not torch.cuda.is_available():
        print("ws_trace: torch.cuda.is_available() is false; this needs a GPU", file=sys.stderr)
        return 1
    return read(Path(args.read).resolve())


if __name__ == "__main__":
    sys.exit(main())
