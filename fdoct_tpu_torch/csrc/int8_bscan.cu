// int8-direct group step with the display epilogue fused, for NVIDIA Hopper
// (sm_90a), on the s8 tensor cores.
//
// Replaces the Pallas TPU kernel int8_bscan_display_fused (_int8_bscan_kernel)
// of fdoct_tpu/ops/pallas_kernels.py.  For one averaging group of B
// bias-shifted s8 frames (B, rows, n_in) and the folded, quantized operator
// of fdoct_tpu_torch/int8direct.py, packed K-major (opk: (2, ndisp, n_in_pad)
// s8, re then im, each depth's samples contiguous, zero past n_in):
//
//   acc_b   = frames[b] @ oq            (s8 x s8 -> s32, exact)
//   x_b     = (float(acc_b) * s_col) * row_gain + const      (re and im)
//   sum     = sum_b |x_b|
//   lin     = sum / averages + eps
//   db      = 20 * ln(lin) / denom,  depth columns 0-1 <- column 4 of the row
//   mn, mx  = min / max of max(db, thresh) over each 32 x 32 tile of db
//
// db is stored untransposed (rows, ndisp); lin is stored only when its
// pointer is not null (the session's linear B-scan), so with a null pointer
// the outputs are exactly the TPU kernel's.  The dequantisation keeps the
// TPU kernel's order with no contraction into FMAs (__fmul_rn/__fadd_rn),
// as torch's plain version computes it op by op.
//
// What bounds it.  At the flagship shape (8 frames of 512 x 2048 s8, 512
// depths) a group is 2 x 2 x 4096 x 2048 x 512 = 17.2 G integer operations
// against ~12 MiB of compulsory traffic: compute-bound on any SIMT pipe (the
// __dp4a form of this kernel ran at under 10 % of the dp4a rate), and at the
// int8 tensor cores' 1,979 dense TOPS it needs ~9 us.  What is left then is
// the traffic from L2 into the SMs, which the block's tile sets.
//
// Two schedules, chosen by fdoct_int8_bscan from the shapes and pointers
// before the launch (ops.kernels.int8_schedule mirrors the rule): where TMA
// can address the frames and the operator (n_in % 16 == 0, 16-byte aligned
// bases: i8ws_applies) the warp-specialised TMA + wgmma schedule
// int8_bscan_ws_kernel below, elsewhere the mma.sync schedule int8_bscan_kernel.
// Both compute every output bit for bit alike: exact s32 sums, the same
// float operations in the same order after them, and min / max folded in
// by atomics on the float's ordered bits, exact in any order.
//
// The mma.sync schedule.  The products run on mma.sync m16n8k32.s32.s8.s8
// (exact s32 sums).  M is (row, frame) pairs, ordered row * F + frame with F
// = min(8, B rounded up to a power of two) frames in flight, so one 64-pair
// block holds all F frames of 64 / F rows and each operator tile it stages
// serves every frame.  N is 64 depths, re and im side by side, so the re
// and im sums of one (row, depth) land in the same thread.  The operator is
// staged in shared memory by 16-byte cp.async and the frames, whose rows
// are not 16-byte aligned wherever this schedule runs, by plain byte loads,
// in a 3-stage ring (the next two 64-sample chunks in flight while the
// tensor cores work on the current one), and read into fragments with
// ldmatrix; rows are padded to 80 bytes, so both are free of bank
// conflicts.  Four warps (2 along pairs x 2 along depths) each hold a
// 32-pair x 32-depth tile: 64 s32 accumulators and 32 f32 magnitude sums
// per thread.  Per chunk of F frames the accumulators are dequantised in
// registers (the constants come from L2, once per chunk) and |x| is added
// to the thread's frame slot; after the last chunk the F slots of a row,
// which sit in lanes whose groupID differs in its low log2(F) bits, are
// summed with __shfl_xor_sync.  The display epilogue runs on the
// registers; depth column 4 reaches columns 0-1 by one shuffle within the
// row's quad.  A warp's tile lies in one 32 x 32 tile of the min/max grid;
// it reduces its partials with shuffles and folds them in with one atomic
// min and max.  512 blocks of 4 warps at the flagship, four per SM (ptxas
// then holds a thread to 128 registers).  Ragged rows, frames, samples and
// depths stage as zero and are neither stored nor counted.  The tiles, the
// ring, the fragment mapping and the frame sum are namespace tc of
// hopper_mma.cuh, shared with the mma.sync instances of fused_recon.cu.
//
// The warp-specialised schedule (namespace i8ws), the shape of the bf16
// instances' fused_recon_ws_kernel (fused_recon.cu).  What the mma.sync
// schedule spends beyond the tensor work, and what this one does about it:
//   * staging by every thread (an address and a register per 16 bytes) and
//     ldmatrix fragment loads: the frames as they lie in memory are K-major
//     s8 and the packed operator is K-major s8, exactly the layouts s8
//     wgmma reads from shared memory, so TMA brings both into the ring with
//     the 128-byte swizzle and the consumers only issue and wait.  One
//     thread of a producer warpgroup (setmaxnreg 40) waits on the ring's
//     "empty" mbarriers and issues the loads on the "full" ones;
//   * the L2 -> SM traffic (192 MiB a flagship group at 64 x 64 tiles): a
//     block is 128 (row, frame) pairs x 128 depths, so a flagship group
//     moves 64 MiB of operator (32 pair tiles x 2 MiB) and 32 MiB of frames
//     (4 depth tiles x 8 MiB);
//   * mma.sync's small tiles and two block-wide barriers a stage: two
//     consumer warpgroups (setmaxnreg 232) each issue four
//     wgmma.mma_async.m64n256k32.s32.s8.s8 a 128-sample stage (64 pairs x
//     re and im of 128 depths, 128 s32 sums a thread), commit once, keep
//     one stage in flight (wgmma_wait<1>) and release the slot before it.
//     Integer sums are exact in any order, so a chunk's products go into one
//     accumulator with no per-stage fragment.
// The block and its pairs.  Pair m = row * 8 + frame with F = 8 frames in
// flight at every B (i8ws::FS), 16 rows a block: 4 depth tiles x 32 row
// tiles = 128 blocks at the flagship, one wave on 132 SMs.  TMA fills
// frames past B, rows past ``rows``, samples past n_in and depths past
// ndisp with zeros without reading memory; they are neither stored nor
// counted (b0 + slot < B, as in the mma.sync schedule).  Groups of more
// than 8 frames run in chunks of 8 (MULTI: |x| is added to the thread's
// frame slot per chunk; a group of at most 8 frames adds it once, after
// the last stage).
// The ring.  A stage holds KT = 128 samples, one 128-byte swizzle row of
// s8: the operator as a (sample, depth, part) box 128 x 128 x 2 (re rows
// 0-127, im rows 128-255, 32 KiB) and the frames as a (sample, frame, row)
// box 128 x 8 x 16 (pair-major, 16 KiB); four 48 KiB stages fit in 227 KB
// beside the block's dequantisation tables (17 KiB), which the consumers
// copy from L2 into shared memory while the ring fills.
// The epilogue.  The wgmma accumulator has the mma.sync (g, t) layout: lane
// (g, t) of consumer warp w holds pairs 16 (w & 3) + g and + 8 of its
// warpgroup (frame g of two rows), depths 8j + 2t + (e & 1), re in
// acc[0..63], im in acc[64..127].  Per chunk the sums are dequantised from
// the tables in shared memory and |x| added as above, the squared
// magnitudes of 16 elements formed before their square roots (each root
// branches to a slow path; one element at a time ran latency-bound).  The
// 8 frame slots of a row (lanes 4 * slot apart)
// are summed by tc::sum_frame_slots' butterfly, each step of which keeps
// half of a lane's values (a reduce-scatter: the same sums in the same
// tree, so slot s ends with depth groups j = 8 s0 + 4 s1 + 2 s2 + {0, 1} of
// both rows, s = s0 + 2 s1 + 4 s2), so every lane runs the display chain
// on 8 values and stores them, where the butterfly would leave each lane 64
// to compute and the slot-0 lanes to store.  A lane's 8 values lie in one
// 32-depth tile; the lanes of a tile reduce min / max by shuffles and one
// of them folds them in with the atomics, one pair per warp and tile.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md; bench_sessions.py,
// ws_trace.py): ~18 us of device time a flagship group (the mma.sync
// schedule 68-69 us), 2.0x the bound, and the same for a group of one frame.
// A consumer warp spends ~1,070 cycles a stage, ~790 of them waiting for the
// stage to land, beside 1,024 cycles of tensor work for the two warpgroups:
// the loop runs near the tensor rate.  After it a warp spends ~6,400 cycles
// dequantising (conversions at a quarter of the FP32 rate), ~550 summing the
// slots and ~2,600 on the display chain: the epilogue, which no other block
// overlaps in one wave, is a third of the time.
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace {

using tc::BM;
using tc::BN;
using tc::KT;
using tc::STAGES;
using tc::THREADS;
using tc::WM;
using tc::WN;
constexpr int LDS = KT + 16;     // bytes per staged row: 80, ldmatrix without conflicts
constexpr int A_BYTES = BM * LDS;
constexpr int B_BYTES = 2 * BN * LDS;
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;   // 46,080: fits the static 48 KB
static_assert(KT % 32 == 0 && LDS % 16 == 0, "k32 steps on 16-byte rows");

// min / max of floats through their ordered bit patterns (no NaN here):
// with the sign bit clear (+0 included) the bits order as a signed int, with
// it set (-0 included) in reverse as an unsigned int
__device__ __forceinline__ void atomic_min_f32(float* p, float v) {
  if (__float_as_int(v) >= 0) atomicMin(reinterpret_cast<int*>(p), __float_as_int(v));
  else atomicMax(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
}
__device__ __forceinline__ void atomic_max_f32(float* p, float v) {
  if (__float_as_int(v) >= 0) atomicMax(reinterpret_cast<int*>(p), __float_as_int(v));
  else atomicMin(reinterpret_cast<unsigned*>(p), __float_as_uint(v));
}

// Stage chunk kt of frames b0.. (pairs) and of the operator (depths).  The
// frames stage byte by byte: every shape whose frame rows TMA can address
// (16-byte aligned) runs the warp-specialised schedule instead.
__device__ __forceinline__ void load_stage(int8_t* stage, const int8_t* frames, const int8_t* opk,
                                           int kt, int b0, int fs, int row0, int col0, int B,
                                           int rows, int n_in, int ndisp, int n_in_pad, int tid) {
  int8_t* a_s = stage;
  int8_t* b_s = stage + A_BYTES;
  const int k0 = kt * KT;
  for (int i = tid; i < BM * (KT / 16); i += THREADS) {
    const int m = i / (KT / 16), k = k0 + (i % (KT / 16)) * 16;
    const int b = b0 + tc::pair_frame(m, fs), r = row0 + tc::pair_row(m, fs);
    const bool ok = b < B && r < rows;
    const int8_t* src = frames + (static_cast<size_t>(b) * rows + r) * n_in + k;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t v = ok && k + j < n_in ? static_cast<uint8_t>(src[j]) : 0u;
      w[j >> 2] |= v << ((j & 3) * 8);
    }
    *reinterpret_cast<uint4*>(a_s + m * LDS + (i % (KT / 16)) * 16) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  for (int i = tid; i < 2 * BN * (KT / 16); i += THREADS) {
    const int n = i / (KT / 16), c = i % (KT / 16);
    const int d = col0 + n % BN;
    const bool ok = d < ndisp;
    const int8_t* src = opk + (static_cast<size_t>(n / BN) * ndisp + d) * n_in_pad + k0 + c * 16;
    cp_async16(b_s + n * LDS + c * 16, ok ? src : opk, ok ? 16 : 0);
  }
}

// One staged chunk through the tensor cores: acc[mt][j] re (j < 4), im (j >= 4)
__device__ __forceinline__ void mma_stage(const int8_t* stage, int (&acc)[2][8][4],
                                          const tc::Frag& f) {
  const uint32_t a_base = smem_addr(stage);
  const uint32_t b_base = a_base + A_BYTES;
  const int lane = f.lane;
#pragma unroll
  for (int kk = 0; kk < KT; kk += 32) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(a[mt], a_base + (f.wm * WM + mt * 16 + (lane & 15)) * LDS + kk + (lane >> 4) * 16);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // matrices: re k0-15, re k16-31, im k0-15, im k16-31 of depths j*8..+7
      uint32_t b[4];
      const int n = (lane >> 4) * BN + f.wn * WN + j * 8 + (lane & 7);
      ldmatrix_x4(b, b_base + n * LDS + kk + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_s8(acc[mt][j], a[mt], b[0], b[1]);
        mma_s8(acc[mt][4 + j], a[mt], b[2], b[3]);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 4)   // 4 blocks per SM: 512 blocks in one wave
int8_bscan_kernel(const int8_t* __restrict__ frames, const int8_t* __restrict__ opk,
                  const float* __restrict__ s_re, const float* __restrict__ s_im,
                  const float* __restrict__ row_gain, const float* __restrict__ const_re,
                  const float* __restrict__ const_im, float thresh, float averages, float eps,
                  float denom, float* __restrict__ db, float* __restrict__ lin,
                  float* __restrict__ mn, float* __restrict__ mx, int B, int rows, int n_in,
                  int ndisp, int n_in_pad, int fs) {
  __shared__ __align__(128) int8_t smem[SMEM_BYTES];

  const int tid = threadIdx.x;
  const tc::Frag f(tid, fs);
  const int lane = f.lane, t = f.t;
  const int row0 = blockIdx.y * (BM >> fs);
  const int col0 = blockIdx.x * BN;
  const int nk = n_in_pad / KT;
  const int slot = f.slot();           // this thread's frame within a chunk

  float mag[2][2][4][2] = {};          // [mt][h][j][e]
  for (int b0 = 0; b0 < B; b0 += 1 << fs) {
    int acc[2][8][4] = {};
    tc::stage_ring(
        smem, STAGE_BYTES, nk,
        [&](int8_t* stage, int kt) {
          load_stage(stage, frames, opk, kt, b0, fs, row0, col0, B, rows, n_in, ndisp, n_in_pad,
                     tid);
        },
        [&](const int8_t* stage) { mma_stage(stage, acc, f); });

    // dequantise in the TPU kernel's order, then the magnitude of this frame
    if (b0 + slot < B) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = f.row(row0, mt, h);
          if (r >= rows) continue;
          const float gain = __ldg(row_gain + r);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int d = f.depth(col0, j, e);
              if (d >= ndisp) continue;
              const size_t idx = static_cast<size_t>(r) * ndisp + d;
              const float xr = __fadd_rn(
                  __fmul_rn(__fmul_rn(static_cast<float>(acc[mt][j][h * 2 + e]), __ldg(s_re + d)),
                            gain),
                  __ldg(const_re + idx));
              const float xi = __fadd_rn(
                  __fmul_rn(__fmul_rn(static_cast<float>(acc[mt][4 + j][h * 2 + e]),
                                      __ldg(s_im + d)),
                            gain),
                  __ldg(const_im + idx));
              tc::add_magnitude(mag[mt][h][j][e], xr, xi);
            }
          }
        }
      }
    }
  }
  tc::sum_frame_slots(mag, fs);

  // display epilogue on the registers; slot 0 of each row stores
  const bool writer = slot == 0;
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = f.row(row0, mt, h);
      float dbv[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float l = __fadd_rn(__fdiv_rn(mag[mt][h][j][e], averages), eps);
          const int d = f.depth(col0, j, e);
          if (lin != nullptr && writer && r < rows && d < ndisp)
            lin[static_cast<size_t>(r) * ndisp + d] = l;
          dbv[j][e] = __fdiv_rn(__fmul_rn(20.f, logf(l)), denom);
        }
      }
      // depth columns 0-1 <- column 4 of the same row (t == 2 of the quad)
      if (col0 == 0 && f.wn == 0) {
        const float c4 = __shfl_sync(0xffffffffu, dbv[0][0], (lane & ~3) | 2);
        if (t == 0) dbv[0][0] = dbv[0][1] = c4;
      }
      if (!writer || r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = f.depth(col0, j, e);
          if (d >= ndisp) continue;
          db[static_cast<size_t>(r) * ndisp + d] = dbv[j][e];
          const float v = fmaxf(dbv[j][e], thresh);
          lo = fminf(lo, v);
          hi = fmaxf(hi, v);
        }
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  // the warp's 32 / F rows and 32 depths lie in one 32 x 32 partial tile
  const int wrow = row0 + tc::pair_row(f.wm * WM, fs), wcol = col0 + f.wn * WN;
  if (lane == 0 && wrow < rows && wcol < ndisp) {
    const size_t tile = static_cast<size_t>(wrow / 32) * ((ndisp + 31) / 32) + wcol / 32;
    atomic_min_f32(mn + tile, lo);
    atomic_max_f32(mx + tile, hi);
  }
}


// ---------------------------------------------------------------------------
// int8_bscan_ws_kernel<MULTI>: the warp-specialised TMA + wgmma schedule (see the
// notes at the top of this file).

namespace i8ws {
constexpr int BM = 128;             // (row, frame) pairs per block: two consumer warpgroups of 64
constexpr int BN = 128;             // depths per block; N = 256 with re and im
constexpr int KT = 128;             // samples per stage: one 128-byte swizzle row, four k32 steps
constexpr int FS = 3;               // log2 of the frames in flight, at every number of frames
constexpr int R = BM >> FS;         // rows per block
constexpr int THREADS = 384;        // warpgroups 0-1 consume (wgmma), warpgroup 2 produces (TMA)
constexpr int PRODUCER_REGS = 40;   // setmaxnreg of the producer warpgroup
constexpr int CONSUMER_REGS = 232;  // and of the consumers: 128 x 40 + 256 x 232 <= 65,536
constexpr int OP_BYTES = 2 * BN * KT;         // the operator box: re rows | im rows, K-major
constexpr int IN_BYTES = BM * KT;             // the frames box: [row][frame][KT], pair-major
constexpr int STAGE_BYTES = OP_BYTES + IN_BYTES;
// the block's dequantisation tables: const_re, const_im [R][BN], s_re,
// s_im [BN], row_gain [R], f32
constexpr int TABLE_BYTES = (2 * R * BN + 2 * BN + R) * 4;
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;            // shared memory a block may take
constexpr int SMEM_EXTRA = 1024 + 2 * MAX_STAGES * 8;   // 1,024-byte alignment + barriers
constexpr int STAGES =
    std::min(MAX_STAGES, (SMEM_LIMIT - SMEM_EXTRA - TABLE_BYTES) / STAGE_BYTES);
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + TABLE_BYTES + SMEM_EXTRA;
static_assert(STAGES >= 2, "a ring of at least two stages");
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 256 <= 65536, "the register file");
static_assert(OP_BYTES % 1024 == 0 && IN_BYTES % 1024 == 0 && (BM / 2) * KT % 1024 == 0,
              "1,024-byte aligned regions");
static_assert(KT == 128 && BN * 2 == 256, "128-byte swizzle rows; wgmma's N = 256");
static_assert(R * BN % 256 == 0 && BN + R <= 256, "the consumers copy the tables evenly");
}  // namespace i8ws

// The block's dequantisation tables, copied into shared memory by the
// consumers while the ring fills (zero past ``rows`` and ndisp): read from
// L2 in the epilogue, one dependent load after another, they took a
// flagship warp ~26,000 cycles (ws_trace.py), longer than its 16 stages.
struct I8Tables {
  float* c_re;   // [R][BN]
  float* c_im;   // [R][BN]
  float* s_re;   // [BN]
  float* s_im;   // [BN]
  float* gain;   // [R]
  __device__ explicit I8Tables(uint8_t* base)
      : c_re(reinterpret_cast<float*>(base)), c_im(c_re + i8ws::R * i8ws::BN),
        s_re(c_im + i8ws::R * i8ws::BN), s_im(s_re + i8ws::BN), gain(s_im + i8ws::BN) {}
};

// Thread t (of the 256 consumers) copies its part of the tables.
__device__ __forceinline__ void i8ws_copy_tables(
    const I8Tables& tb, const float* __restrict__ s_re, const float* __restrict__ s_im,
    const float* __restrict__ row_gain, const float* __restrict__ const_re,
    const float* __restrict__ const_im, int row0, int col0, int rows, int ndisp, int t) {
  constexpr int N = i8ws::R * i8ws::BN / 256;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int i = t + 256 * k, r = row0 + i / i8ws::BN, d = col0 + i % i8ws::BN;
    const bool ok = r < rows && d < ndisp;
    const size_t idx = static_cast<size_t>(r) * ndisp + d;
    tb.c_re[i] = ok ? __ldg(const_re + idx) : 0.f;
    tb.c_im[i] = ok ? __ldg(const_im + idx) : 0.f;
  }
  if (t < i8ws::BN) {
    const bool ok = col0 + t < ndisp;
    tb.s_re[t] = ok ? __ldg(s_re + col0 + t) : 0.f;
    tb.s_im[t] = ok ? __ldg(s_im + col0 + t) : 0.f;
  } else if (t < i8ws::BN + i8ws::R) {
    const int rr = t - i8ws::BN;
    tb.gain[rr] = row0 + rr < rows ? __ldg(row_gain + row0 + rr) : 0.f;
  }
}

// This thread's magnitudes += |x| of one chunk's s32 sums, dequantised in
// the TPU kernel's order: element i = 4j + 2h + e of the wgmma layout is
// pair m0 + 8h (block row rr[h]), depth 8j + 2tq + e of the block, re in
// acc[i], im in acc[64 + i]; tc::add_magnitude's rounding.  Elements past
// ``rows`` or ndisp have zero sums and zero tables, so they come out 0 and
// need no test (they are neither stored nor counted).  The squared
// magnitudes of 16 elements are formed before their square roots: each
// IEEE square root carries a branch to its slow path, and computed one
// element at a time the chain (conversion, products, sum, root) ran
// latency-bound; 16 at a time keep a group of more than 8 frames (64
// magnitudes live beside the sums) within the consumers' registers.
__device__ __forceinline__ void i8ws_add_magnitudes(float (&mag)[64], const int (&acc)[128],
                                                    const I8Tables& tb, const int (&rr)[2],
                                                    int tq) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {        // elements 16q .. 16q + 15: j = 4q .. 4q + 3
    float sq[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int i = 16 * q + k, h = (i >> 1) & 1, dd = 8 * (i >> 2) + 2 * tq + (i & 1);
      const float gain = tb.gain[rr[h]];
      const float xr = __fadd_rn(
          __fmul_rn(__fmul_rn(static_cast<float>(acc[i]), tb.s_re[dd]), gain),
          tb.c_re[rr[h] * i8ws::BN + dd]);
      const float xi = __fadd_rn(
          __fmul_rn(__fmul_rn(static_cast<float>(acc[64 + i]), tb.s_im[dd]), gain),
          tb.c_im[rr[h] * i8ws::BN + dd]);
      sq[k] = __fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi));
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) mag[16 * q + k] = __fadd_rn(mag[16 * q + k], __fsqrt_rn(sq[k]));
  }
}

// One step of the frame-slot butterfly that keeps half of the N values:
// lane pairs ``off`` apart (slot bit ``up``) each add the other's half to
// their own, so the sums are tc::sum_frame_slots'.  out[k] is in[k] +
// partner's in[k] for up == 0, in[N/2 + k] + partner's in[N/2 + k] for up.
template <int N>
__device__ __forceinline__ void i8ws_halve(float (&out)[N / 2], const float (&in)[N], bool up,
                                           int off) {
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const float keep = up ? in[N / 2 + k] : in[k], send = up ? in[k] : in[N / 2 + k];
    out[k] = keep + __shfl_xor_sync(0xffffffffu, send, off);
  }
}

template <bool MULTI>
__global__ void __launch_bounds__(i8ws::THREADS, 1)
int8_bscan_ws_kernel(const __grid_constant__ CUtensorMap in_map,
               const __grid_constant__ CUtensorMap op_map, const float* __restrict__ s_re,
               const float* __restrict__ s_im, const float* __restrict__ row_gain,
               const float* __restrict__ const_re, const float* __restrict__ const_im,
               float thresh, float averages, float eps, float denom, float* __restrict__ db,
               float* __restrict__ lin, float* __restrict__ mn, float* __restrict__ mx, int B,
               int rows, int n_in, int ndisp) {
  extern __shared__ uint8_t i8ws_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(i8ws_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  constexpr int fs = i8ws::FS, nst = i8ws::STAGES, sbytes = i8ws::STAGE_BYTES;
  const I8Tables tables(smem + nst * sbytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + nst * sbytes + i8ws::TABLE_BYTES);
  uint64_t* empty = full + i8ws::MAX_STAGES;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int row0 = blockIdx.y * i8ws::R, col0 = blockIdx.x * i8ws::BN;
  const int nk = (n_in + i8ws::KT - 1) / i8ws::KT;
  const int total = nk * ((B + (1 << fs) - 1) >> fs);    // stages of all chunks of frames

  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);       // the eight consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: one thread issues both copies of stage it into slot it %
    // nst once the slot's previous stage has been released
    setmaxnreg_dec<i8ws::PRODUCER_REGS>();
    if (tid == 256) {
      for (int it = 0, s = 0, ph = 0, kt = 0, b0 = 0; it < total; ++it) {
        uint8_t* st = smem + s * sbytes;
        if (it >= nst) mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], sbytes);
        const int k0 = kt * i8ws::KT;
        tma_load_3d(st, &op_map, &full[s], k0, col0, 0);                  // re | im
        tma_load_3d(st + i8ws::OP_BYTES, &in_map, &full[s], k0, b0, row0);
        if (++s == nst) s = 0, ph ^= 1;
        if (++kt == nk) kt = 0, b0 += 1 << fs;
      }
    }
    return;
  }

  // the consumers: warpgroup wg multiplies pairs 64 wg .. 64 wg + 63
  setmaxnreg_inc<i8ws::CONSUMER_REGS>();
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = wg * 64 + (warp & 3) * 16 + g;            // this lane's pairs: m0, m0 + 8
  const int frame = tc::pair_frame(m0, fs);                // the same for m0 + 8
  const int rr[2] = {tc::pair_row(m0, fs), tc::pair_row(m0 + 8, fs)};   // rows in the block
  const int r[2] = {row0 + rr[0], row0 + rr[1]};
  i8ws_copy_tables(tables, s_re, s_im, row_gain, const_re, const_im, row0, col0, rows, ndisp, tid);
  named_barrier_sync(1, 256);          // the tables are whole
  int acc[128];
  float mag[64];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0;
#pragma unroll
  for (int i = 0; i < 64; ++i) mag[i] = 0.f;
  for (int it = 0, s = 0, ph = 0, kt = 0, b0 = 0; it < total; ++it) {
    const uint32_t b_addr = smem_addr(smem + s * sbytes);
    const uint32_t a_addr = b_addr + i8ws::OP_BYTES + wg * (i8ws::BM / 2) * i8ws::KT;
    mbar_wait(&full[s], ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n256k32_s8_ss(acc, wgmma_desc_k_sw128(a_addr + 32 * kk),
                             wgmma_desc_k_sw128(b_addr + 32 * kk), kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();                   // the stage before is done: release its slot
    if (it > 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s == 0 ? nst - 1 : s - 1]);
    }
    if (kt == nk - 1) {                // the last stage of a chunk of frames
      wgmma_wait<0>();
      wgmma_hold(acc);
      if constexpr (MULTI) {
        if (b0 + frame < B) i8ws_add_magnitudes(mag, acc, tables, rr, tq);
      }
    }
    if (++s == nst) s = 0, ph ^= 1;
    if (++kt == nk) kt = 0, b0 += 1 << fs;
  }
  if constexpr (!MULTI) {
    if (frame < B) i8ws_add_magnitudes(mag, acc, tables, rr, tq);
  }

  // the frame-slot sum, halving a lane's values at each step: slot bit 0
  // picks depth groups j >= 8, bit 1 the upper half of those, bit 2 the
  // upper pair; z[4l + 2h + e] is depth group jb + l of row r[h]
  float w[32], u[16], z[8];
  i8ws_halve<64>(w, mag, frame & 1, 4);
  i8ws_halve<32>(u, w, frame & 2, 8);
  i8ws_halve<16>(z, u, frame & 4, 16);
  const int jb = 8 * (frame & 1) + 4 * ((frame >> 1) & 1) + 2 * ((frame >> 2) & 1);

  // the display epilogue on the registers, each step for all 8 values
  // before the next (the divisions and logarithms branch to slow paths)
  float lv[8], dbv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) lv[i] = __fadd_rn(__fdiv_rn(z[i], averages), eps);
#pragma unroll
  for (int i = 0; i < 8; ++i) dbv[i] = logf(lv[i]);
#pragma unroll
  for (int i = 0; i < 8; ++i) dbv[i] = __fdiv_rn(__fmul_rn(20.f, dbv[i]), denom);
  if (lin != nullptr) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int h = (i >> 1) & 1, d = col0 + 8 * (jb + (i >> 2)) + 2 * tq + (i & 1);
      if (r[h] < rows && d < ndisp) lin[static_cast<size_t>(r[h]) * ndisp + d] = lv[i];
    }
  }
  // depth columns 0-1 <- column 4 of the same row: lanes (0, 0) and (0, 2)
  if (col0 == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float c4 = __shfl_sync(0xffffffffu, dbv[2 * h], (lane & ~3) | 2);
      if (frame == 0 && tq == 0) dbv[2 * h] = dbv[2 * h + 1] = c4;
    }
  }
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int h = (i >> 1) & 1, d = col0 + 8 * (jb + (i >> 2)) + 2 * tq + (i & 1);
    if (r[h] >= rows || d >= ndisp) continue;
    db[static_cast<size_t>(r[h]) * ndisp + d] = dbv[i];
    const float v = fmaxf(dbv[i], thresh);
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
  // a lane's values lie in depth tile q = 2 s0 + s1 of the warp's two rows
  // (one 32-row tile); the 8 lanes of a tile differ in tq and s2
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int off = k < 2 ? 1 << k : 16;
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  const int wcol = col0 + 32 * (jb >> 2);
  if (tq == 0 && frame < 4 && r[0] < rows && wcol < ndisp) {
    const size_t tile = static_cast<size_t>(r[0] / 32) * ((ndisp + 31) / 32) + wcol / 32;
    atomic_min_f32(mn + tile, lo);
    atomic_max_f32(mx + tile, hi);
  }
}

// Whether TMA can address the frames and the packed operator (else the
// mma.sync schedule runs): 16-byte row strides of the frames (n_in % 16;
// the operator's rows are n_in_pad long, a multiple of 64) and 16-byte
// aligned bases of both.
bool i8ws_applies(const void* frames, const void* opk, int n_in) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return n_in % 16 == 0 && aligned(frames) && aligned(opk);
}

int launch_i8ws(const void* frames, const void* opk, const void* s_re, const void* s_im,
                const void* row_gain, const void* const_re, const void* const_im, float thresh,
                float averages, float eps, float denom, void* db, void* lin, void* mn, void* mx,
                int B, int rows, int n_in, int ndisp, int n_in_pad, void* stream) {
  const int gy = (rows + i8ws::R - 1) / i8ws::R;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[2] = {};
  const cuuint64_t n = static_cast<cuuint64_t>(n_in), nr = static_cast<cuuint64_t>(rows),
                   nd = static_cast<cuuint64_t>(ndisp), np = static_cast<cuuint64_t>(n_in_pad);
  // the frames pair-major: dims (sample, frame, row), box KT x 8 x R
  const cuuint64_t in_dims[3] = {n, static_cast<cuuint64_t>(B), nr};
  const cuuint64_t in_strides[2] = {nr * n, n};
  const cuuint32_t in_box[3] = {i8ws::KT, 1u << i8ws::FS, i8ws::R};
  // the operator: dims (sample, depth, part), box KT x BN x 2 (re and im)
  const cuuint64_t op_dims[3] = {n, nd, 2}, op_strides[2] = {np, nd * np};
  const cuuint32_t op_box[3] = {i8ws::KT, i8ws::BN, 2};
  const bool ok = tensor_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, frames, in_dims,
                             in_strides, in_box, CU_TENSOR_MAP_SWIZZLE_128B) &&
                  tensor_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, opk, op_dims,
                             op_strides, op_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel =
      B > (1 << i8ws::FS) ? int8_bscan_ws_kernel<true> : int8_bscan_ws_kernel<false>;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, i8ws::SMEM_BYTES);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<dim3((ndisp + i8ws::BN - 1) / i8ws::BN, gy), i8ws::THREADS, i8ws::SMEM_BYTES,
           static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], static_cast<const float*>(s_re), static_cast<const float*>(s_im),
      static_cast<const float*>(row_gain), static_cast<const float*>(const_re),
      static_cast<const float*>(const_im), thresh, averages, eps, denom, static_cast<float*>(db),
      static_cast<float*>(lin), static_cast<float*>(mn), static_cast<float*>(mx), B, rows, n_in,
      ndisp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  Every pointer is a contiguous device
// buffer: frames (B, rows, n_in) s8; opk (2, ndisp, n_in_pad) s8, 16-byte
// aligned, n_in_pad a multiple of 64 and >= n_in, zero past n_in; s_re, s_im
// (ndisp,) f32; row_gain (rows,) f32; const_re, const_im (rows, ndisp) f32;
// db (rows, ndisp) f32; lin (rows, ndisp) f32 or null; mn, mx
// (ceil(rows/32), ceil(ndisp/32)) f32, filled with +inf and -inf by the
// caller.  Runs the warp-specialised schedule where TMA can address the
// frames and the operator (i8ws_applies), else the mma.sync one; the choice
// is made from the shapes and pointers, before the launch.  Launches on
// ``stream`` and returns cudaGetLastError() (0 when the launch was
// accepted).
extern "C" int fdoct_int8_bscan(const void* frames, const void* opk, const void* s_re,
                                const void* s_im, const void* row_gain, const void* const_re,
                                const void* const_im, float thresh, float averages, float eps,
                                float denom, void* db, void* lin, void* mn, void* mx, int B,
                                int rows, int n_in, int ndisp, int n_in_pad, void* stream) {
  if (B < 1 || rows < 1 || n_in < 1 || ndisp < 5 || n_in_pad < n_in || n_in_pad % KT != 0 ||
      reinterpret_cast<uintptr_t>(opk) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (i8ws_applies(frames, opk, n_in))
    return launch_i8ws(frames, opk, s_re, s_im, row_gain, const_re, const_im, thresh, averages,
                       eps, denom, db, lin, mn, mx, B, rows, n_in, ndisp, n_in_pad, stream);
  const int fs = tc::frames_shift(B);  // log2 of the frames in flight
  const int rows_per_block = BM >> fs;
  if ((rows + rows_per_block - 1) / rows_per_block > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((ndisp + BN - 1) / BN, (rows + rows_per_block - 1) / rows_per_block);
  int8_bscan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(frames), static_cast<const int8_t*>(opk),
      static_cast<const float*>(s_re), static_cast<const float*>(s_im),
      static_cast<const float*>(row_gain), static_cast<const float*>(const_re),
      static_cast<const float*>(const_im), thresh, averages, eps, denom, static_cast<float*>(db),
      static_cast<float*>(lin), static_cast<float*>(mn), static_cast<float*>(mx), B, rows, n_in,
      ndisp, n_in_pad, fs);
  return static_cast<int>(cudaGetLastError());
}
