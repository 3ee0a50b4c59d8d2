// Fused FD-OCT group reconstruction for NVIDIA Hopper (sm_90a).
//
//   out[r, d] = sum_b | x_b[r, :] @ (op_re + i*op_im)[:, d] |
//
// Replaces two Pallas TPU kernels of fdoct_tpu/ops/pallas_kernels.py:
//   * fdoct_recon_raw_u8_*  <- fused_recon_raw_accumulate (_recon_raw_kernel):
//     x_b = (raw[b] - pi_frame) * inv_background, computed per element as the
//     tile is staged, so the f32 apodization ratio never reaches device memory;
//   * fdoct_recon_yr_f32_*  <- fused_recon_accumulate (_recon_kernel):
//     x_b = yr[b], an f32 ratio that preprocess/normalization already made.
// The suffix names the operator type: f32, or bf16.  With a bf16 operator the
// ratio is rounded to bf16 in registers before the product (round to nearest
// even, as torch's .to(torch.bfloat16)), matching the bf16 branch of
// fdoct_tpu/pipeline.py:_op_matmul_pair; a bf16 x bf16 product is exact in
// f32, so f32 FMAs reproduce bf16-operand / f32-accumulate numerics.
//
// What bounds it.  At the flagship shape (B=8 frames of 512 rows x 2048
// spectral samples, 512 display depths) one group is 2 matmuls x 2 x 4096 x
// 2048 x 512 = 17.2 GFLOP against 21-25 MiB of compulsory traffic (8 MiB u8
// frames, 8 MiB pi/inv_background, 4-8 MiB operator, 1 MiB out): about 700
// FLOP/byte, above the H100's ~295 FLOP/byte bf16 ridge, so the work is
// compute-bound.  This first form runs on the SIMT FP32 pipes, so its floor
// is the FP32 FMA rate (~67 TFLOP/s at 700 W: ~0.26 ms per group); the
// tensor cores (wgmma on bf16 tiles staged by TMA) are the later step.
//
// What the design does about it.  Each 128-thread block owns one 32-row x
// 32-depth output tile; the flagship's 512 x 512 output gives 256 blocks for
// the 132 SMs.  The TPU grid's sequential batch axis (init at b == 0, += after)
// becomes a loop over b inside the block: per b, K is walked in 32-sample
// shared-memory chunks of the ratio tile and of op_re/op_im, two f32
// accumulators (re, im) per output run over K, and at the end of K
// sqrt(re^2 + im^2) is added to a third.  The output is stored once: no
// atomics, no cross-block dependency, deterministic.  Each thread computes a
// 2-row x 4-depth micro-tile, so one k step costs two broadcast loads of the
// ratio and two float4 loads of the operator for 16 FMAs.  Ragged edges
// (rows, n_in, ndisp not multiples of 32) are masked: out-of-range operands
// stage as zero and out-of-range outputs are not stored.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 32;        // output rows per block
constexpr int TN = 32;        // output depths per block
constexpr int TK = 32;        // spectral samples per shared-memory chunk
constexpr int THREADS = 128;
constexpr int RPT = 2;        // rows per thread
constexpr int CPT = 4;        // depths per thread
static_assert((TM / RPT) * (TN / CPT) == THREADS, "thread tiling");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The ratio as the operator type sees it.
template <typename Op> __device__ __forceinline__ float as_operand(float v);
template <> __device__ __forceinline__ float as_operand<float>(float v) { return v; }
template <> __device__ __forceinline__ float as_operand<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Element (b, r, k) of the ratio stack; ``rk`` is r * n_in + k.
__device__ __forceinline__ float ratio_at(const uint8_t* x, const float* pi, const float* inv_bg,
                                          size_t frame, size_t rk) {
  return (static_cast<float>(x[frame + rk]) - pi[rk]) * inv_bg[rk];
}
__device__ __forceinline__ float ratio_at(const float* x, const float*, const float*,
                                          size_t frame, size_t rk) {
  return x[frame + rk];
}

template <typename In, typename Op>
__global__ void __launch_bounds__(THREADS)
fused_recon_kernel(const In* __restrict__ x, const float* __restrict__ pi,
                   const float* __restrict__ inv_bg, const Op* __restrict__ op_re,
                   const Op* __restrict__ op_im, float* __restrict__ out,
                   int B, int rows, int n_in, int ndisp) {
  __shared__ float a_s[TK][TM + 1];                // ratio, k-major; +1 spreads banks
  __shared__ __align__(16) float re_s[TK][TN];
  __shared__ __align__(16) float im_s[TK][TN];

  const int tid = threadIdx.x;
  const int tr = tid / (TN / CPT);
  const int tc = tid % (TN / CPT);
  const int row0 = blockIdx.y * TM;
  const int col0 = blockIdx.x * TN;

  float mag[RPT][CPT] = {};
  for (int b = 0; b < B; ++b) {
    const size_t frame = static_cast<size_t>(b) * rows * n_in;
    float re[RPT][CPT] = {};
    float im[RPT][CPT] = {};
    for (int k0 = 0; k0 < n_in; k0 += TK) {
      // stage the ratio tile: lanes walk k, so each row's reads coalesce
      for (int i = tid; i < TM * TK; i += THREADS) {
        const int r = i / TK, k = i % TK;
        const int gr = row0 + r, gk = k0 + k;
        float v = 0.f;
        if (gr < rows && gk < n_in)
          v = as_operand<Op>(ratio_at(x, pi, inv_bg, frame, static_cast<size_t>(gr) * n_in + gk));
        a_s[k][r] = v;
      }
      // stage the operator tiles: lanes walk depth, contiguous in memory
      for (int i = tid; i < TK * TN; i += THREADS) {
        const int k = i / TN, c = i % TN;
        const int gk = k0 + k, gc = col0 + c;
        const bool ok = gk < n_in && gc < ndisp;
        const size_t idx = static_cast<size_t>(gk) * ndisp + gc;
        re_s[k][c] = ok ? to_f32(op_re[idx]) : 0.f;
        im_s[k][c] = ok ? to_f32(op_im[idx]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < TK; ++k) {
        float a[RPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) a[i] = a_s[k][tr * RPT + i];
        const float4 br4 = *reinterpret_cast<const float4*>(&re_s[k][tc * CPT]);
        const float4 bi4 = *reinterpret_cast<const float4*>(&im_s[k][tc * CPT]);
        const float br[CPT] = {br4.x, br4.y, br4.z, br4.w};
        const float bi[CPT] = {bi4.x, bi4.y, bi4.z, bi4.w};
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            re[i][j] = fmaf(a[i], br[j], re[i][j]);
            im[i][j] = fmaf(a[i], bi[j], im[i][j]);
          }
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) mag[i][j] += sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = row0 + tr * RPT + i;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = col0 + tc * CPT + j;
      if (r < rows && c < ndisp) out[static_cast<size_t>(r) * ndisp + c] = mag[i][j];
    }
  }
}

template <typename In, typename Op>
int launch(const void* x, const void* pi, const void* inv_bg, const void* op_re,
           const void* op_im, void* out, int B, int rows, int n_in, int ndisp, void* stream) {
  if (B < 1 || rows < 1 || n_in < 1 || ndisp < 1 || (rows + TM - 1) / TM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((ndisp + TN - 1) / TN, (rows + TM - 1) / TM);
  fused_recon_kernel<In, Op><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const In*>(x), static_cast<const float*>(pi), static_cast<const float*>(inv_bg),
      static_cast<const Op*>(op_re), static_cast<const Op*>(op_im), static_cast<float*>(out),
      B, rows, n_in, ndisp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  Every pointer is a contiguous device
// buffer: x (B, rows, n_in); pi, inv_bg (rows, n_in) f32; op_re, op_im
// (n_in, ndisp); out (rows, ndisp) f32.  Launches on ``stream`` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" {

int fdoct_recon_raw_u8_f32(const void* raw, const void* pi, const void* inv_bg,
                           const void* op_re, const void* op_im, void* out,
                           int B, int rows, int n_in, int ndisp, void* stream) {
  return launch<uint8_t, float>(raw, pi, inv_bg, op_re, op_im, out, B, rows, n_in, ndisp, stream);
}

int fdoct_recon_raw_u8_bf16(const void* raw, const void* pi, const void* inv_bg,
                            const void* op_re, const void* op_im, void* out,
                            int B, int rows, int n_in, int ndisp, void* stream) {
  return launch<uint8_t, __nv_bfloat16>(raw, pi, inv_bg, op_re, op_im, out, B, rows, n_in, ndisp,
                                        stream);
}

int fdoct_recon_yr_f32_f32(const void* yr, const void* op_re, const void* op_im, void* out,
                           int B, int rows, int n_in, int ndisp, void* stream) {
  return launch<float, float>(yr, nullptr, nullptr, op_re, op_im, out, B, rows, n_in, ndisp,
                              stream);
}

int fdoct_recon_yr_f32_bf16(const void* yr, const void* op_re, const void* op_im, void* out,
                            int B, int rows, int n_in, int ndisp, void* stream) {
  return launch<float, __nv_bfloat16>(yr, nullptr, nullptr, op_re, op_im, out, B, rows, n_in,
                                      ndisp, stream);
}

}  // extern "C"
