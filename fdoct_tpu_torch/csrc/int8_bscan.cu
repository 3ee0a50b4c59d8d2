// int8-direct group step with the display epilogue fused, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel int8_bscan_display_fused (_int8_bscan_kernel)
// of fdoct_tpu/ops/pallas_kernels.py.  For one averaging group of B
// bias-shifted s8 frames (B, rows, n_in) and the folded, quantized operator
// of fdoct_tpu_torch/int8direct.py (oq_re, oq_im: (n_in, ndisp) s8):
//
//   acc_b   = frames[b] @ oq            (s8 x s8 -> s32, exact)
//   x_b     = (float(acc_b) * s_col) * row_gain + const      (re and im)
//   sum     = sum_b |x_b|
//   lin     = sum / averages + eps
//   db      = 20 * ln(lin) / denom,  depth columns 0-1 <- column 4 of the row
//   mn, mx  = min / max over the block's valid elements of max(db, thresh)
//
// db is stored untransposed (rows, ndisp); lin is stored only when its
// pointer is not null (the session's linear B-scan), so with a null pointer
// the outputs are exactly the TPU kernel's.  The dequantisation keeps the
// TPU kernel's order with no contraction into FMAs (__fmul_rn/__fadd_rn),
// as torch's plain version computes it op by op.
//
// What bounds it.  At the flagship shape (8 frames of 512 x 2048 s8, 512
// depths) a group is 2 x 2 x 4096 x 2048 x 512 = 17.2 G integer operations
// against ~10 MiB of compulsory traffic (8 MiB frames, 2 MiB operator, 2 MiB
// const tables, 1 MiB out): compute-bound.  This first form runs on the
// SIMT integer pipes with __dp4a (4 s8 products and the s32 sum in one
// instruction), so its floor is the dp4a issue rate; the int8 tensor cores
// (mma.sync / wgmma s8) are the later step.
//
// What the design does about it.  Each 128-thread block owns one 32-row x
// 32-depth output tile (the flagship's 512 x 512 output gives 256 blocks for
// the 132 SMs).  The TPU grid's sequential batch axis becomes a loop over b
// inside the block, with no atomics: per b, K is walked in 64-sample chunks;
// the frame tile and both operator tiles are staged in shared memory
// k-contiguous (the operator transposed while staging), so four consecutive
// k of a row or of a depth column are one 32-bit word for __dp4a.  Each
// thread keeps a 2-row x 4-depth micro-tile of s32 (re, im) accumulators,
// dequantises after each b and adds the magnitude to an f32 sum.  After the
// last b the epilogue runs on the registers; the tile that holds depth
// columns 0-1 passes column 4 through shared memory, and the min/max
// partials are reduced over the block with warp shuffles, one pair per
// block.  Ragged edges stage as zero, and out-of-range outputs are neither
// stored nor counted in the partials.

#include <cmath>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;        // output rows per block
constexpr int TN = 32;        // output depths per block
constexpr int TK = 64;        // spectral samples per shared-memory chunk
constexpr int LDS = TK + 4;   // bytes per staged row: 17 words, spreads banks
constexpr int THREADS = 128;
constexpr int RPT = 2;        // rows per thread
constexpr int CPT = 4;        // depths per thread
constexpr int WARPS = THREADS / 32;
static_assert((TM / RPT) * (TN / CPT) == THREADS, "thread tiling");
static_assert(TK % 4 == 0 && LDS % 4 == 0, "dp4a words");
static_assert(CPT == 4, "depth column 4 is the first column of thread column 1");

__global__ void __launch_bounds__(THREADS)
int8_bscan_kernel(const int8_t* __restrict__ frames, const int8_t* __restrict__ oq_re,
                  const int8_t* __restrict__ oq_im, const float* __restrict__ s_re,
                  const float* __restrict__ s_im, const float* __restrict__ row_gain,
                  const float* __restrict__ const_re, const float* __restrict__ const_im,
                  float thresh, float averages, float eps, float denom,
                  float* __restrict__ db, float* __restrict__ lin, float* __restrict__ mn,
                  float* __restrict__ mx, int B, int rows, int n_in, int ndisp) {
  __shared__ __align__(16) int8_t a_s[TM * LDS];    // frame tile, [row][k]
  __shared__ __align__(16) int8_t re_s[TN * LDS];   // operator tiles, [depth][k]
  __shared__ __align__(16) int8_t im_s[TN * LDS];
  __shared__ float col4_s[TM];
  __shared__ float red_s[2][WARPS];

  const int tid = threadIdx.x;
  const int tr = tid / (TN / CPT);
  const int tc = tid % (TN / CPT);
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;

  // this thread's outputs and their dequantisation constants (0 outside)
  bool valid[RPT][CPT];
  float sr[CPT], si[CPT], g[RPT], cr[RPT][CPT], ci[RPT][CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const int c = col0 + tc * CPT + j;
    sr[j] = c < ndisp ? s_re[c] : 0.f;
    si[j] = c < ndisp ? s_im[c] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = row0 + tr * RPT + i;
    g[i] = r < rows ? row_gain[r] : 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = col0 + tc * CPT + j;
      valid[i][j] = r < rows && c < ndisp;
      const size_t idx = static_cast<size_t>(r) * ndisp + c;
      cr[i][j] = valid[i][j] ? const_re[idx] : 0.f;
      ci[i][j] = valid[i][j] ? const_im[idx] : 0.f;
    }
  }

  float mag[RPT][CPT] = {};
  for (int b = 0; b < B; ++b) {
    const int8_t* fr = frames + static_cast<size_t>(b) * rows * n_in;
    int re[RPT][CPT] = {};
    int im[RPT][CPT] = {};
    for (int k0 = 0; k0 < n_in; k0 += TK) {
      // frame tile: lanes walk k, so each row's reads coalesce
      for (int i = tid; i < TM * TK; i += THREADS) {
        const int r = i / TK, k = i % TK;
        const int gr = row0 + r, gk = k0 + k;
        a_s[r * LDS + k] = (gr < rows && gk < n_in) ? fr[static_cast<size_t>(gr) * n_in + gk] : 0;
      }
      // operator tiles: lanes walk depth (contiguous in memory), stored
      // transposed so that k is contiguous for dp4a
      for (int i = tid; i < TK * TN; i += THREADS) {
        const int k = i / TN, c = i % TN;
        const int gk = k0 + k, gc = col0 + c;
        const bool ok = gk < n_in && gc < ndisp;
        const size_t idx = static_cast<size_t>(gk) * ndisp + gc;
        re_s[c * LDS + k] = ok ? oq_re[idx] : 0;
        im_s[c * LDS + k] = ok ? oq_im[idx] : 0;
      }
      __syncthreads();
#pragma unroll 4
      for (int k4 = 0; k4 < TK / 4; ++k4) {
        int a[RPT], br[CPT], bi[CPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i)
          a[i] = reinterpret_cast<const int*>(a_s + (tr * RPT + i) * LDS)[k4];
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          br[j] = reinterpret_cast<const int*>(re_s + (tc * CPT + j) * LDS)[k4];
          bi[j] = reinterpret_cast<const int*>(im_s + (tc * CPT + j) * LDS)[k4];
        }
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            re[i][j] = __dp4a(a[i], br[j], re[i][j]);
            im[i][j] = __dp4a(a[i], bi[j], im[i][j]);
          }
        }
      }
      __syncthreads();
    }
    // dequantise in the TPU kernel's order, then the magnitude
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const float xr = __fadd_rn(
            __fmul_rn(__fmul_rn(static_cast<float>(re[i][j]), sr[j]), g[i]), cr[i][j]);
        const float xi = __fadd_rn(
            __fmul_rn(__fmul_rn(static_cast<float>(im[i][j]), si[j]), g[i]), ci[i][j]);
        mag[i][j] = __fadd_rn(mag[i][j],
                              __fsqrt_rn(__fadd_rn(__fmul_rn(xr, xr), __fmul_rn(xi, xi))));
      }
    }
  }

  // display epilogue on the registers: /N, +eps, dB
  float dbv[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float l = __fadd_rn(__fdiv_rn(mag[i][j], averages), eps);
      if (lin != nullptr && valid[i][j])
        lin[static_cast<size_t>(row0 + tr * RPT + i) * ndisp + col0 + tc * CPT + j] = l;
      dbv[i][j] = __fdiv_rn(__fmul_rn(20.f, logf(l)), denom);
    }
  }
  // depth columns 0-1 <- column 4 of the same row (block-uniform branch)
  if (col0 == 0) {
    if (tc == 1) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) col4_s[tr * RPT + i] = dbv[i][0];
    }
    __syncthreads();
    if (tc == 0) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) dbv[i][0] = dbv[i][1] = col4_s[tr * RPT + i];
    }
  }
  // store db; the floor max(db, thresh) enters the partials, valid only
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      if (!valid[i][j]) continue;
      db[static_cast<size_t>(row0 + tr * RPT + i) * ndisp + col0 + tc * CPT + j] = dbv[i][j];
      const float d = fmaxf(dbv[i][j], thresh);
      lo = fminf(lo, d);
      hi = fmaxf(hi, d);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
  if (tid % 32 == 0) {
    red_s[0][tid / 32] = lo;
    red_s[1][tid / 32] = hi;
  }
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int w = 1; w < WARPS; ++w) {
      lo = fminf(lo, red_s[0][w]);
      hi = fmaxf(hi, red_s[1][w]);
    }
    const size_t tile = static_cast<size_t>(blockIdx.y) * gridDim.x + blockIdx.x;
    mn[tile] = lo;
    mx[tile] = hi;
  }
}

}  // namespace

// Plain C entry point for ctypes.  Every pointer is a contiguous device
// buffer: frames (B, rows, n_in) s8; oq_re, oq_im (n_in, ndisp) s8; s_re,
// s_im (ndisp,) f32; row_gain (rows,) f32; const_re, const_im (rows, ndisp)
// f32; db (rows, ndisp) f32; lin (rows, ndisp) f32 or null; mn, mx
// (ceil(rows/32), ceil(ndisp/32)) f32.  Launches on ``stream`` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" int fdoct_int8_bscan(const void* frames, const void* oq_re, const void* oq_im,
                                const void* s_re, const void* s_im, const void* row_gain,
                                const void* const_re, const void* const_im, float thresh,
                                float averages, float eps, float denom, void* db, void* lin,
                                void* mn, void* mx, int B, int rows, int n_in, int ndisp,
                                void* stream) {
  if (B < 1 || rows < 1 || n_in < 1 || ndisp < 5 || (rows + TM - 1) / TM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((ndisp + TN - 1) / TN, (rows + TM - 1) / TM);
  int8_bscan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(frames), static_cast<const int8_t*>(oq_re),
      static_cast<const int8_t*>(oq_im), static_cast<const float*>(s_re),
      static_cast<const float*>(s_im), static_cast<const float*>(row_gain),
      static_cast<const float*>(const_re), static_cast<const float*>(const_im), thresh, averages,
      eps, denom, static_cast<float*>(db), static_cast<float*>(lin), static_cast<float*>(mn),
      static_cast<float*>(mx), B, rows, n_in, ndisp);
  return static_cast<int>(cudaGetLastError());
}
