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
// the traffic from L2 into the SMs: each block reads its frame rows once per
// 64-depth tile and its operator tile once per 64-pair tile, 64 + 128 MiB a
// group at the flagship, some 35 us of L2 bandwidth.
//
// What the design does about it.  The products run on mma.sync
// m16n8k32.s32.s8.s8 (exact s32 sums).  M is (row, frame) pairs, ordered
// row * F + frame with F = min(8, B rounded up to a power of two) frames in
// flight, so one 64-pair block holds all F frames of 64 / F rows and each
// operator tile it stages serves every frame.  N is 64 depths, re and im
// side by side, so the re and im sums of one (row, depth) land in the same
// thread.  Frames and operator are staged in shared memory by 16-byte
// cp.async in a 3-stage ring (the next two 64-sample chunks in flight while
// the tensor cores work on the current one) and read into fragments with
// ldmatrix; rows are padded to 80 bytes, so both are free of bank
// conflicts.  The operator is K-major as the s8 MMA requires, packed once
// per capture by the caller, so no block transposes it.  Frames whose rows
// are not 16-byte aligned (n_in % 16 != 0) stage through plain byte loads.
// Four warps (2 along pairs x 2 along depths) each hold a 32-pair x 32-depth
// tile: 64 s32 accumulators and 32 f32 magnitude sums per thread.  Per chunk
// of F frames the accumulators are dequantised in registers (the constants
// come from L2, once per chunk) and |x| is added to the thread's frame slot;
// after the last chunk the F slots of a row, which sit in lanes whose
// groupID differs in its low log2(F) bits, are summed with __shfl_xor_sync.
// The display epilogue runs on the registers; depth column 4 reaches
// columns 0-1 by one shuffle within the row's quad.  A warp's tile lies in
// one 32 x 32 tile of the min/max grid; it reduces its partials with
// shuffles and folds them in with one atomic min and max on the float's
// ordered bit pattern, exact and independent of the order of the blocks.
// At the flagship: 512 blocks of 4 warps, four per SM so that all of them
// run in one wave (ptxas then holds a thread to 128 registers and spills
// under 200 bytes, which costs less than a second wave).  Ragged rows,
// frames, samples and depths stage as zero and are neither stored nor
// counted.  The tiles, the ring, the fragment mapping and the frame sum are
// namespace tc of hopper_mma.cuh, shared with the bf16 kernel of
// fused_recon.cu; this file keeps the s8 staging and MMA step, the
// dequantisation and the display epilogue.

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

// Stage chunk kt of frames b0.. (pairs) and of the operator (depths).  VEC:
// frame rows are 16-byte aligned (n_in % 16 == 0 and an aligned base).
template <bool VEC>
__device__ __forceinline__ void load_stage(int8_t* stage, const int8_t* frames,
                                           const int8_t* opk, int kt, int b0, int fs, int row0,
                                           int col0, int B, int rows, int n_in, int ndisp,
                                           int n_in_pad, int tid) {
  int8_t* a_s = stage;
  int8_t* b_s = stage + A_BYTES;
  const int k0 = kt * KT;
  for (int i = tid; i < BM * (KT / 16); i += THREADS) {
    const int m = i / (KT / 16), k = k0 + (i % (KT / 16)) * 16;
    const int b = b0 + tc::pair_frame(m, fs), r = row0 + tc::pair_row(m, fs);
    const bool ok = b < B && r < rows;
    const int8_t* src = frames + (static_cast<size_t>(b) * rows + r) * n_in + k;
    int8_t* dst = a_s + m * LDS + (i % (KT / 16)) * 16;
    if (VEC) {
      const bool in = ok && k < n_in;
      cp_async16(dst, in ? src : frames, in ? 16 : 0);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const uint32_t v = ok && k + j < n_in ? static_cast<uint8_t>(src[j]) : 0u;
        w[j >> 2] |= v << ((j & 3) * 8);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
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

template <bool VEC>
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
          load_stage<VEC>(stage, frames, opk, kt, b0, fs, row0, col0, B, rows, n_in, ndisp,
                          n_in_pad, tid);
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

}  // namespace

// Plain C entry point for ctypes.  Every pointer is a contiguous device
// buffer: frames (B, rows, n_in) s8; opk (2, ndisp, n_in_pad) s8, 16-byte
// aligned, n_in_pad a multiple of 64 and >= n_in, zero past n_in; s_re, s_im
// (ndisp,) f32; row_gain (rows,) f32; const_re, const_im (rows, ndisp) f32;
// db (rows, ndisp) f32; lin (rows, ndisp) f32 or null; mn, mx
// (ceil(rows/32), ceil(ndisp/32)) f32, filled with +inf and -inf by the
// caller.  Launches on ``stream`` and returns cudaGetLastError() (0 when the
// launch was accepted).
extern "C" int fdoct_int8_bscan(const void* frames, const void* opk, const void* s_re,
                                const void* s_im, const void* row_gain, const void* const_re,
                                const void* const_im, float thresh, float averages, float eps,
                                float denom, void* db, void* lin, void* mn, void* mx, int B,
                                int rows, int n_in, int ndisp, int n_in_pad, void* stream) {
  if (B < 1 || rows < 1 || n_in < 1 || ndisp < 5 || n_in_pad < n_in || n_in_pad % KT != 0 ||
      reinterpret_cast<uintptr_t>(opk) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int fs = tc::frames_shift(B);  // log2 of the frames in flight
  const int rows_per_block = BM >> fs;
  if ((rows + rows_per_block - 1) / rows_per_block > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((ndisp + BN - 1) / BN, (rows + rows_per_block - 1) / rows_per_block);
  const bool vec = n_in % 16 == 0 && reinterpret_cast<uintptr_t>(frames) % 16 == 0;
  const auto kernel = vec ? int8_bscan_kernel<true> : int8_bscan_kernel<false>;
  kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(frames), static_cast<const int8_t*>(opk),
      static_cast<const float*>(s_re), static_cast<const float*>(s_im),
      static_cast<const float*>(row_gain), static_cast<const float*>(const_re),
      static_cast<const float*>(const_im), thresh, averages, eps, denom, static_cast<float*>(db),
      static_cast<float*>(lin), static_cast<float*>(mn), static_cast<float*>(mx), B, rows, n_in,
      ndisp, n_in_pad, fs);
  return static_cast<int>(cudaGetLastError());
}
