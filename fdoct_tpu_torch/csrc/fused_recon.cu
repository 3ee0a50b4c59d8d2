// Fused FD-OCT group reconstruction for NVIDIA Hopper (sm_90a).
//
//   out[r, d] = sum_b | x_b[r, :] @ (op_re + i*op_im)[:, d] |
//
// Replaces three Pallas TPU kernels of fdoct_tpu/ops/pallas_kernels.py:
//   * fdoct_recon_raw_u8_*  <- fused_recon_raw_accumulate (_recon_raw_kernel):
//     x_b = (raw[b] - pi_frame) * inv_background, computed on chip as the
//     tile is staged, so the f32 apodization ratio never reaches device memory;
//   * fdoct_recon_yr_f32_*  <- fused_recon_accumulate (_recon_kernel):
//     x_b = yr[b], an f32 ratio that preprocess/normalization already made;
//   * fdoct_recon_resident_u8_bf16 <- fused_recon_resident, the schedule at
//     the end of the file.
// The suffix names the operator type: f32, or bf16.  With a bf16 operator the
// ratio is rounded to bf16 before the product (round to nearest even, as
// torch's .to(torch.bfloat16)), matching the bf16 branch of
// fdoct_tpu/pipeline.py:_op_matmul_pair; a bf16 x bf16 product is exact in
// f32, so every form below computes bf16-operand / f32-accumulate numerics.
//
// What bounds them.  At the flagship shape (B=8 frames of 512 rows x 2048
// spectral samples, 512 display depths) one group is 2 matmuls x 2 x 4096 x
// 2048 x 512 = 17.2 GFLOP against 21-25 MiB of compulsory traffic (8 MiB u8
// frames, 8 MiB pi/inv_background, 4-8 MiB operator, 1 MiB out): about 700
// FLOP/byte, above the H100's ~295 FLOP/byte bf16 ridge, so the work is
// compute-bound.
//
// Two designs.  fdoct_recon_raw_u8_bf16 (the 'default' group step on CUDA)
// runs on the bf16 tensor cores, described before its kernel below.  The
// f32-operator instances and both yr instances keep the SIMT template that
// comes first: TF32 would break the f32 operator's 'highest' contract, so
// its tensor-core form is a later step.  The SIMT template's floor is the
// FP32 FMA rate (~67 TFLOP/s at 700 W: ~0.26 ms per group).  Each 128-thread
// block owns one 32-row x 32-depth output tile; the TPU grid's sequential
// batch axis (init at b == 0, += after) becomes a loop over b inside the
// block: per b, K is walked in 32-sample shared-memory chunks of the ratio
// tile and of op_re/op_im, two f32 accumulators (re, im) per output run over
// K, and at the end of K sqrt(re^2 + im^2) is added to a third.  The output
// is stored once: no atomics, no cross-block dependency, deterministic.  Each
// thread computes a 2-row x 4-depth micro-tile, so one k step costs two
// broadcast loads of the ratio and two float4 loads of the operator for 16
// FMAs.  Ragged edges (rows, n_in, ndisp not multiples of 32) are masked:
// out-of-range operands stage as zero and out-of-range outputs are not
// stored.

#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

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

// ---------------------------------------------------------------------------
// fdoct_recon_raw_u8_bf16 on the bf16 tensor cores.  The products run on
// mma.sync m16n8k16.f32.bf16.bf16 (exact products, f32 sums), at a 15x
// higher rate than the SIMT FMAs, so what bounds this form is the traffic
// from L2 into the SMs (each block reads its operator tile once per 64-pair
// tile and its frame rows, pi and inv_background once per 64-depth tile:
// 384 MiB a flagship group) and the pass that forms the ratio.
//
// M is (row, frame) pairs, ordered row * F + frame with F = min(8, B rounded
// up to a power of two) frames in flight, as the resident schedule's slab
// does: a 64-pair block holds all F frames of 64 / F rows, so pi and
// inv_background are staged once for all frames of a row and each operator
// tile serves every frame (the SIMT template re-stages both per frame).  N
// is 64 depths, re and im side by side.  Per 64-sample stage, the u8
// frames, pi, inv_background and the operator arrive by 16-byte cp.async in
// a 3-stage ring; the block then forms the bf16 ratio of its 64 pairs into
// one shared tile (4 samples per thread and step) and the tensor cores read
// it with ldmatrix and the depth-contiguous operator with ldmatrix.trans,
// so the operator needs no repacking.  Rows are padded (144 and 272 bytes)
// so neither load has bank conflicts.  Four warps (2 x 2) each hold 32 pairs
// x 32 depths: 64 f32 accumulators and 32 magnitude sums per thread.  After
// each chunk of F frames |re + i im| is added to the thread's frame slot;
// after the last, the F slots of a row (lanes whose groupID differs in its
// low log2(F) bits) are summed with __shfl_xor_sync and one lane stores.
// Without 16-byte alignment (n_in % 16, ndisp % 8, or a base pointer) the
// stages load element by element.  Masked pairs (frames past B, rows past
// rows) get a zero ratio; samples past n_in and depths past ndisp stage as
// zero.  No atomics, deterministic.  The tiles, the ring, the fragment
// mapping and the frame sum are namespace tc of hopper_mma.cuh, shared with
// int8_bscan.cu; what is this kernel's own is the staging, the ratio tile
// and the bf16 MMA step below.

constexpr int TC_A_LD = tc::KT * 2 + 16;         // bytes per bf16 ratio row: 144
constexpr int TC_OP_LD = 2 * tc::BN * 2 + 16;    // bytes per operator sample row: 272
constexpr int TC_RAW_BYTES = tc::BM * tc::KT;    // u8 frames [pair][k]
constexpr int TC_OP_BYTES = tc::KT * TC_OP_LD;   // bf16 operator [k][re 64 | im 64]
constexpr int TC_A_BYTES = tc::BM * TC_A_LD;     // bf16 ratio [pair][k], one buffer
static_assert(tc::KT % 16 == 0 && TC_A_LD % 16 == 0 && TC_OP_LD % 16 == 0, "16-byte rows");

// One stage: raw | operator | pi [R][KT] f32 | inv_background [R][KT] f32,
// R = tc::BM / F rows.
__host__ __device__ constexpr int tc_stage_bytes(int R) {
  return TC_RAW_BYTES + TC_OP_BYTES + 2 * R * tc::KT * static_cast<int>(sizeof(float));
}

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

template <bool VEC>
__device__ __forceinline__ void tc_load_stage(uint8_t* stage, const uint8_t* raw, const float* pi,
                                              const float* inv_bg, const __nv_bfloat16* op_re,
                                              const __nv_bfloat16* op_im, int kt, int b0, int fs,
                                              int R, int row0, int col0, int B, int rows,
                                              int n_in, int ndisp, int tid) {
  constexpr int KT = tc::KT;
  uint8_t* raw_s = stage;
  uint8_t* op_s = stage + TC_RAW_BYTES;
  float* pi_s = reinterpret_cast<float*>(op_s + TC_OP_BYTES);
  float* inv_s = pi_s + R * KT;
  const int k0 = kt * KT;
  for (int i = tid; i < tc::BM * (KT / 16); i += tc::THREADS) {
    const int m = i / (KT / 16), c = i % (KT / 16);
    const int b = b0 + tc::pair_frame(m, fs), r = row0 + tc::pair_row(m, fs), k = k0 + c * 16;
    const bool ok = b < B && r < rows;
    const uint8_t* src = raw + (static_cast<size_t>(b) * rows + r) * n_in + k;
    uint8_t* dst = raw_s + m * KT + c * 16;
    if (VEC) {
      const bool in = ok && k < n_in;
      cp_async16(dst, in ? src : raw, in ? 16 : 0);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 16; ++j) w[j >> 2] |= (ok && k + j < n_in ? src[j] : 0u) << ((j & 3) * 8);
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  for (int i = tid; i < R * (KT / 4); i += tc::THREADS) {
    const int rr = i / (KT / 4), c = i % (KT / 4);
    const int r = row0 + rr, k = k0 + c * 4;
    const size_t idx = static_cast<size_t>(r) * n_in + k;
    float* dp = pi_s + rr * KT + c * 4;
    float* di = inv_s + rr * KT + c * 4;
    if (VEC) {
      const bool in = r < rows && k < n_in;
      cp_async16(dp, in ? pi + idx : pi, in ? 16 : 0);
      cp_async16(di, in ? inv_bg + idx : inv_bg, in ? 16 : 0);
    } else {
      float p[4], v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool in = r < rows && k + j < n_in;
        p[j] = in ? pi[idx + j] : 0.f;
        v[j] = in ? inv_bg[idx + j] : 0.f;
      }
      *reinterpret_cast<float4*>(dp) = make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(di) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
  // the operator: 8 depths (16 bytes) per copy, re then im
  for (int i = tid; i < KT * (2 * tc::BN / 8); i += tc::THREADS) {
    const int k = i / (2 * tc::BN / 8), n8 = i % (2 * tc::BN / 8);
    const int gk = k0 + k, d = col0 + (n8 % (tc::BN / 8)) * 8;
    const __nv_bfloat16* op = n8 < tc::BN / 8 ? op_re : op_im;
    const size_t idx = static_cast<size_t>(gk) * ndisp + d;
    uint8_t* dst = op_s + k * TC_OP_LD + n8 * 16;
    if (VEC) {
      const bool in = gk < n_in && d < ndisp;
      cp_async16(dst, in ? op + idx : op, in ? 16 : 0);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        w[j >> 1] |= (gk < n_in && d + j < ndisp ? bf16_bits(op[idx + j]) : 0u) << ((j & 1) * 16);
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The bf16 ratio bf16((raw - pi) * inv_bg) of the stage's pairs into a_s;
// zero for masked pairs.
__device__ __forceinline__ void tc_ratio_tile(const uint8_t* stage, uint8_t* a_s, int b0, int fs,
                                              int R, int row0, int B, int rows, int tid) {
  constexpr int KT = tc::KT;
  const uint8_t* raw_s = stage;
  const float* pi_s = reinterpret_cast<const float*>(stage + TC_RAW_BYTES + TC_OP_BYTES);
  const float* inv_s = pi_s + R * KT;
  for (int i = tid; i < tc::BM * (KT / 4); i += tc::THREADS) {
    const int m = i / (KT / 4), k = (i % (KT / 4)) * 4;
    const int rr = tc::pair_row(m, fs);
    uint2 packed = make_uint2(0u, 0u);
    if (b0 + tc::pair_frame(m, fs) < B && row0 + rr < rows) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(raw_s + m * KT + k);
      const float4 p = *reinterpret_cast<const float4*>(pi_s + rr * KT + k);
      const float4 v = *reinterpret_cast<const float4*>(inv_s + rr * KT + k);
      const float x[4] = {
          __fmul_rn(__fsub_rn(static_cast<float>(w & 0xffu), p.x), v.x),
          __fmul_rn(__fsub_rn(static_cast<float>((w >> 8) & 0xffu), p.y), v.y),
          __fmul_rn(__fsub_rn(static_cast<float>((w >> 16) & 0xffu), p.z), v.z),
          __fmul_rn(__fsub_rn(static_cast<float>(w >> 24), p.w), v.w)};
      packed.x = bf16_bits(__float2bfloat16_rn(x[0])) | bf16_bits(__float2bfloat16_rn(x[1])) << 16;
      packed.y = bf16_bits(__float2bfloat16_rn(x[2])) | bf16_bits(__float2bfloat16_rn(x[3])) << 16;
    }
    *reinterpret_cast<uint2*>(a_s + m * TC_A_LD + k * 2) = packed;
  }
}

// One staged chunk through the tensor cores: acc[mt][j] re (j < 4), im (j >= 4)
__device__ __forceinline__ void tc_mma_stage(const uint8_t* a_s, const uint8_t* op_s,
                                             float (&acc)[2][8][4], const tc::Frag& f) {
  const uint32_t a_base = smem_addr(a_s);
  const uint32_t b_base = smem_addr(op_s);
  const int lane = f.lane;
#pragma unroll
  for (int kk = 0; kk < tc::KT; kk += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(a[mt], a_base + (f.wm * tc::WM + mt * 16 + (lane & 15)) * TC_A_LD +
                             (kk + (lane >> 4) * 8) * 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // matrices: re k0-7, re k8-15, im k0-7, im k8-15 of depths j*8..+7
      uint32_t b[4];
      const int krow = kk + ((lane >> 3) & 1) * 8 + (lane & 7);
      const int n = (lane >> 4) * tc::BN + f.wn * tc::WN + j * 8;
      ldmatrix_x4_trans(b, b_base + krow * TC_OP_LD + n * 2);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][j], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][4 + j], a[mt], b[2], b[3]);
      }
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(tc::THREADS)
fused_recon_bf16_tc_kernel(const uint8_t* __restrict__ raw, const float* __restrict__ pi,
                           const float* __restrict__ inv_bg,
                           const __nv_bfloat16* __restrict__ op_re,
                           const __nv_bfloat16* __restrict__ op_im, float* __restrict__ out,
                           int B, int rows, int n_in, int ndisp, int fs) {
  extern __shared__ __align__(128) uint8_t tc_smem[];
  const int R = tc::BM >> fs;
  const int stage_bytes = tc_stage_bytes(R);
  uint8_t* a_s = tc_smem + tc::STAGES * stage_bytes;

  const int tid = threadIdx.x;
  const tc::Frag f(tid, fs);
  const int row0 = blockIdx.y * R;
  const int col0 = blockIdx.x * tc::BN;
  const int nk = (n_in + tc::KT - 1) / tc::KT;

  float mag[2][2][4][2] = {};          // [mt][h][j][e], this thread's frame slot
  for (int b0 = 0; b0 < B; b0 += 1 << fs) {
    float acc[2][8][4] = {};
    tc::stage_ring(
        tc_smem, stage_bytes, nk,
        [&](uint8_t* stage, int kt) {
          tc_load_stage<VEC>(stage, raw, pi, inv_bg, op_re, op_im, kt, b0, fs, R, row0, col0, B,
                             rows, n_in, ndisp, tid);
        },
        [&](const uint8_t* stage) {   // a_s is free: every warp is past the last stage's MMAs
          tc_ratio_tile(stage, a_s, b0, fs, R, row0, B, rows, tid);
          __syncthreads();             // the ratio tile is whole
          tc_mma_stage(a_s, stage + TC_RAW_BYTES, acc, f);
        });
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            tc::add_magnitude(mag[mt][h][j][e], acc[mt][j][h * 2 + e], acc[mt][4 + j][h * 2 + e]);
  }
  tc::sum_frame_slots(mag, fs);
  if (f.slot() != 0) return;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = f.row(row0, mt, h);
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = f.depth(col0, j, e);
          if (d < ndisp) out[static_cast<size_t>(r) * ndisp + d] = mag[mt][h][j][e];
        }
      }
    }
  }
}

int launch_bf16_tc(const void* raw, const void* pi, const void* inv_bg, const void* op_re,
                   const void* op_im, void* out, int B, int rows, int n_in, int ndisp,
                   void* stream) {
  if (B < 1 || rows < 1 || n_in < 1 || ndisp < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int fs = tc::frames_shift(B);  // log2 of the frames in flight
  const int R = tc::BM >> fs;
  if ((rows + R - 1) / R > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = n_in % 16 == 0 && ndisp % 8 == 0 && aligned(raw) && aligned(pi) &&
                   aligned(inv_bg) && aligned(op_re) && aligned(op_im);
  const auto kernel = vec ? fused_recon_bf16_tc_kernel<true> : fused_recon_bf16_tc_kernel<false>;
  const int smem = tc::STAGES * tc_stage_bytes(R) + TC_A_BYTES;
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((ndisp + tc::BN - 1) / tc::BN, (rows + R - 1) / R);
  kernel<<<grid, tc::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(raw), static_cast<const float*>(pi),
      static_cast<const float*>(inv_bg), static_cast<const __nv_bfloat16*>(op_re),
      static_cast<const __nv_bfloat16*>(op_im), static_cast<float*>(out), B, rows, n_in, ndisp, fs);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The resident schedule: fdoct_recon_resident_u8_bf16 <- fused_recon_resident
// (_recon_resident_kernel, pallas_kernels.py:70-123).  The same sum as the
// raw bf16 instance above, with the bf16 operator the TPU kernel keeps in
// VMEM for the whole grid while each frame streams through once.
//
// On Hopper the 4 MiB bf16 operator of the flagship (2 x 2048 x 512) cannot
// sit in one SM's shared memory, but it stays hot in the 50 MB L2.  What
// fits is the other operand, so the roles swap.  A block owns RES_VROWS
// (frame, row) pairs -- all B frames of RES_VROWS / B rows (4 rows at B = 8)
// -- times RES_TD depths.  It forms the bf16-rounded ratio of those pairs
// once from the u8 frames, pi_frame and inv_background and keeps it in
// shared memory, RES_KS samples at a time; the operator streams from L2 in
// RES_TK-sample chunks, double-buffered through registers, and each chunk
// serves every frame of the tile before the next one lands.  Every frame
// byte is read from device memory once (and ndisp / RES_TD times from L2,
// by the blocks that split the depths).  Per thread 8 pairs x 4 depths x (re, im) = 64 f32
// accumulators; per k step two broadcast float4 loads of the ratio and two
// float4 loads of the operator feed 64 FMAs.  What bounds it: the SIMT FP32
// FMA rate, as kernels 1-2 (17.2 GFLOP per flagship group).  The b loop is
// inside the block; the block stores its output tile once per chunk of up to
// RES_VROWS frames: no atomics, deterministic.  Ragged rows, samples and
// depths are masked.

constexpr int RES_VROWS = 32;     // (frame, row) pairs per block
constexpr int RES_TD = 128;       // depths per block
constexpr int RES_KS = 512;       // spectral samples per ratio slab in shared memory
constexpr int RES_TK = 16;        // spectral samples per operator chunk
constexpr int RES_THREADS = 128;
constexpr int RES_VPT = 8;        // (frame, row) pairs per thread
constexpr int RES_DPT = 4;        // depths per thread
constexpr int RES_STRIDE = RES_VROWS + 4;   // floats per sample in the slab: 16-byte rows
constexpr int RES_OPBUF = 2 * RES_TK * RES_TD;   // floats per operator buffer (re, im)
constexpr size_t RES_SMEM = sizeof(float) * (static_cast<size_t>(RES_KS) * RES_STRIDE +
                                             2 * RES_OPBUF);
static_assert((RES_VROWS / RES_VPT) * (RES_TD / RES_DPT) == RES_THREADS, "thread tiling");
static_assert(RES_KS % RES_TK == 0, "slab holds whole operator chunks");
static_assert(RES_VROWS * RES_TD <= 2 * RES_OPBUF, "magnitudes fit the operator buffers");

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// One RES_TK x RES_TD chunk of op_re and op_im, held in registers between its
// load from L2 and its store to shared memory as f32.  VEC: ndisp % 8 == 0
// and 16-byte aligned operators, so 8 depths load as one uint4.
template <bool VEC> struct OpChunk;

template <> struct OpChunk<true> {
  static constexpr int SEGS = RES_TK * RES_TD / 8 / RES_THREADS;   // uint4 per thread per array
  uint4 v[2][SEGS];
  __device__ void load(const __nv_bfloat16* re, const __nv_bfloat16* im, int k0, int col0,
                       int n_in, int ndisp, int tid) {
#pragma unroll
    for (int s = 0; s < SEGS; ++s) {
      const int seg = tid + s * RES_THREADS;
      const int gk = k0 + seg / (RES_TD / 8), gc = col0 + (seg % (RES_TD / 8)) * 8;
      const bool ok = gk < n_in && gc < ndisp;
      const size_t idx = static_cast<size_t>(gk) * ndisp + gc;
      v[0][s] = ok ? *reinterpret_cast<const uint4*>(re + idx) : make_uint4(0, 0, 0, 0);
      v[1][s] = ok ? *reinterpret_cast<const uint4*>(im + idx) : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ void store(float* buf, int tid) const {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int s = 0; s < SEGS; ++s) {
        const int seg = tid + s * RES_THREADS;
        float* dst = buf + a * RES_TK * RES_TD + (seg / (RES_TD / 8)) * RES_TD +
                     (seg % (RES_TD / 8)) * 8;
        const uint4 w = v[a][s];
        *reinterpret_cast<float4*>(dst) = make_float4(bf16_lo(w.x), bf16_hi(w.x),
                                                      bf16_lo(w.y), bf16_hi(w.y));
        *reinterpret_cast<float4*>(dst + 4) = make_float4(bf16_lo(w.z), bf16_hi(w.z),
                                                          bf16_lo(w.w), bf16_hi(w.w));
      }
    }
  }
};

template <> struct OpChunk<false> {
  // thread t holds depth col0 + t of every sample of the chunk
  static_assert(RES_TD == RES_THREADS, "one depth per thread");
  __nv_bfloat16 v[2][RES_TK];
  __device__ void load(const __nv_bfloat16* re, const __nv_bfloat16* im, int k0, int col0,
                       int n_in, int ndisp, int tid) {
    const int gc = col0 + tid;
#pragma unroll
    for (int k = 0; k < RES_TK; ++k) {
      const int gk = k0 + k;
      const bool ok = gk < n_in && gc < ndisp;
      const size_t idx = static_cast<size_t>(gk) * ndisp + gc;
      v[0][k] = ok ? re[idx] : __float2bfloat16_rn(0.f);
      v[1][k] = ok ? im[idx] : __float2bfloat16_rn(0.f);
    }
  }
  __device__ void store(float* buf, int tid) const {
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int k = 0; k < RES_TK; ++k)
        buf[a * RES_TK * RES_TD + k * RES_TD + tid] = __bfloat162float(v[a][k]);
    }
  }
};

// R rows x Bc frames per block (R * Bc <= RES_VROWS); pair (r, b) is slab
// column r * Bc + b.
template <bool VEC>
__global__ void __launch_bounds__(RES_THREADS)
fused_recon_resident_kernel(const uint8_t* __restrict__ raw, const float* __restrict__ pi,
                            const float* __restrict__ inv_bg,
                            const __nv_bfloat16* __restrict__ op_re,
                            const __nv_bfloat16* __restrict__ op_im, float* __restrict__ out,
                            int B, int rows, int n_in, int ndisp, int R, int Bc) {
  extern __shared__ __align__(16) float res_smem[];
  float* slab = res_smem;                                   // [RES_KS][RES_STRIDE]
  float* opbuf = res_smem + static_cast<size_t>(RES_KS) * RES_STRIDE;   // 2 x [re|im][RES_TK][RES_TD]
  float* mag_s = opbuf;                                     // [RES_VROWS][RES_TD], after the K loop

  const int tid = threadIdx.x;
  const int tv = tid / (RES_TD / RES_DPT);   // warp-uniform: ratio loads broadcast
  const int tc = tid % (RES_TD / RES_DPT);
  const int row0 = blockIdx.y * R;
  const int col0 = blockIdx.x * RES_TD;
  const size_t frame = static_cast<size_t>(rows) * n_in;

  for (int b0 = 0; b0 < B; b0 += Bc) {
    const int nb = min(Bc, B - b0);
    float re[RES_VPT][RES_DPT] = {};
    float im[RES_VPT][RES_DPT] = {};
    for (int ks = 0; ks < n_in; ks += RES_KS) {
      const int nch = (min(RES_KS, n_in - ks) + RES_TK - 1) / RES_TK;
      const int kspan = nch * RES_TK;
      __syncthreads();                 // the last slab, chunk and magnitudes are read
      // the ratio slab: lanes walk k, so each frame row's reads coalesce;
      // pi and inv_background are read once for all frames of the row
      for (int i = tid; i < R * kspan; i += RES_THREADS) {
        const int r = i / kspan, k = i % kspan;
        const int gr = row0 + r, gk = ks + k;
        const bool ok = gr < rows && gk < n_in;
        const size_t rk = static_cast<size_t>(gr) * n_in + gk;
        const float p = ok ? pi[rk] : 0.f;
        const float inv = ok ? inv_bg[rk] : 0.f;
        float* dst = slab + k * RES_STRIDE + r * Bc;
        for (int b = 0; b < Bc; ++b) {
          float v = 0.f;
          if (ok && b < nb)
            v = as_operand<__nv_bfloat16>((static_cast<float>(raw[(b0 + b) * frame + rk]) - p) * inv);
          dst[b] = v;
        }
      }
      OpChunk<VEC> chunk;
      chunk.load(op_re, op_im, ks, col0, n_in, ndisp, tid);
      chunk.store(opbuf, tid);
      __syncthreads();
      for (int c = 0; c < nch; ++c) {
        const bool more = c + 1 < nch;
        if (more) chunk.load(op_re, op_im, ks + (c + 1) * RES_TK, col0, n_in, ndisp, tid);
        const float* a_s = slab + c * RES_TK * RES_STRIDE + tv * RES_VPT;
        const float* br_s = opbuf + (c & 1) * RES_OPBUF + tc * RES_DPT;
        const float* bi_s = br_s + RES_TK * RES_TD;
#pragma unroll
        for (int k = 0; k < RES_TK; ++k) {
          const float4 a0 = *reinterpret_cast<const float4*>(a_s + k * RES_STRIDE);
          const float4 a1 = *reinterpret_cast<const float4*>(a_s + k * RES_STRIDE + 4);
          const float4 br4 = *reinterpret_cast<const float4*>(br_s + k * RES_TD);
          const float4 bi4 = *reinterpret_cast<const float4*>(bi_s + k * RES_TD);
          const float a[RES_VPT] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
          const float br[RES_DPT] = {br4.x, br4.y, br4.z, br4.w};
          const float bi[RES_DPT] = {bi4.x, bi4.y, bi4.z, bi4.w};
#pragma unroll
          for (int i = 0; i < RES_VPT; ++i) {
#pragma unroll
            for (int j = 0; j < RES_DPT; ++j) {
              re[i][j] = fmaf(a[i], br[j], re[i][j]);
              im[i][j] = fmaf(a[i], bi[j], im[i][j]);
            }
          }
        }
        if (more) chunk.store(opbuf + ((c + 1) & 1) * RES_OPBUF, tid);
        __syncthreads();
      }
    }
    // |re + i im| of every pair, then the sum over the chunk's frames per row
#pragma unroll
    for (int i = 0; i < RES_VPT; ++i) {
      float m[RES_DPT];
#pragma unroll
      for (int j = 0; j < RES_DPT; ++j) m[j] = sqrtf(re[i][j] * re[i][j] + im[i][j] * im[i][j]);
      *reinterpret_cast<float4*>(mag_s + (tv * RES_VPT + i) * RES_TD + tc * RES_DPT) =
          make_float4(m[0], m[1], m[2], m[3]);
    }
    __syncthreads();
    for (int i = tid; i < R * RES_TD; i += RES_THREADS) {
      const int r = i / RES_TD, d = i % RES_TD;
      const int gr = row0 + r, gc = col0 + d;
      if (gr >= rows || gc >= ndisp) continue;
      float s = 0.f;
      for (int b = 0; b < nb; ++b) s += mag_s[(r * Bc + b) * RES_TD + d];
      float* o = out + static_cast<size_t>(gr) * ndisp + gc;
      *o = b0 == 0 ? s : *o + s;       // this thread wrote it for the last chunk
    }
  }
}

template <bool VEC>
int launch_resident(const void* raw, const void* pi, const void* inv_bg, const void* op_re,
                    const void* op_im, void* out, int B, int rows, int n_in, int ndisp,
                    int R, int Bc, void* stream) {
  const auto kernel = fused_recon_resident_kernel<VEC>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(RES_SMEM));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((ndisp + RES_TD - 1) / RES_TD, (rows + R - 1) / R);
  kernel<<<grid, RES_THREADS, RES_SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(raw), static_cast<const float*>(pi),
      static_cast<const float*>(inv_bg), static_cast<const __nv_bfloat16*>(op_re),
      static_cast<const __nv_bfloat16*>(op_im), static_cast<float*>(out),
      B, rows, n_in, ndisp, R, Bc);
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
  return launch_bf16_tc(raw, pi, inv_bg, op_re, op_im, out, B, rows, n_in, ndisp, stream);
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

// The resident schedule; op_re, op_im are bf16.  Frames per block
// min(B, RES_VROWS), rows per block RES_VROWS / that.
int fdoct_recon_resident_u8_bf16(const void* raw, const void* pi, const void* inv_bg,
                                 const void* op_re, const void* op_im, void* out,
                                 int B, int rows, int n_in, int ndisp, void* stream) {
  if (B < 1 || rows < 1 || n_in < 1 || ndisp < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int Bc = B < RES_VROWS ? B : RES_VROWS;
  const int R = RES_VROWS / Bc;
  if ((rows + R - 1) / R > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = ndisp % 8 == 0 && reinterpret_cast<uintptr_t>(op_re) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(op_im) % 16 == 0;
  return vec ? launch_resident<true>(raw, pi, inv_bg, op_re, op_im, out, B, rows, n_in, ndisp,
                                     R, Bc, stream)
             : launch_resident<false>(raw, pi, inv_bg, op_re, op_im, out, B, rows, n_in, ndisp,
                                      R, Bc, stream);
}

}  // extern "C"
