// Fused FD-OCT group reconstruction for NVIDIA Hopper (sm_90a).
//
//   out[r, d] = sum_b | x_b[r, :] @ (op_re + i*op_im)[:, d] |
//
// Replaces three Pallas TPU kernels of fdoct_tpu/ops/pallas_kernels.py:
//   * fdoct_recon_raw_u8_*  <- fused_recon_raw_accumulate (_recon_raw_kernel,
//     pallas_kernels.py:126-160): x_b = (raw[b] - pi_frame) * inv_background,
//     computed on chip as the tile is staged, so the f32 apodization ratio
//     never reaches device memory;
//   * fdoct_recon_yr_f32_*  <- fused_recon_accumulate (_recon_kernel,
//     pallas_kernels.py:275-308): x_b = yr[b], an f32 ratio that
//     preprocess/normalization already made;
//   * fdoct_recon_resident_u8_bf16 <- fused_recon_resident, the schedule at
//     the end of the file.
// The suffix names the operator type: f32, or bf16.  With a bf16 operator the
// ratio is rounded to bf16 before the product (round to nearest even, as
// torch's .to(torch.bfloat16)), matching the bf16 branch of
// fdoct_tpu/pipeline.py:_op_matmul_pair; a bf16 x bf16 product is exact in
// f32, so every bf16 form computes bf16-operand / f32-accumulate numerics.
// With an f32 operator ('highest', the metrology route) the product keeps
// f32 accuracy: TF32 alone (~3 decimal digits) would break that contract.
//
// What bounds them.  At the flagship shape (B=8 frames of 512 rows x 2048
// spectral samples, 512 display depths) one group is 2 matmuls x 2 x 4096 x
// 2048 x 512 = 17.2 GFLOP against 21-41 MiB of compulsory traffic (8 MiB u8
// frames or 32 MiB f32 ratio, 8 MiB pi/inv_background, 4-8 MiB operator,
// 1 MiB out): 400-800 FLOP/byte, compute-bound at every precision.  The
// least time for the products: 17.4 us on the bf16 tensor cores (989
// TFLOP/s); with an f32 operator 0.256 ms on the SIMT FP32 pipes (67
// TFLOP/s) or 0.104 ms as three TF32 products on the tensor cores (495
// TFLOP/s), the form taken here.
//
// The four raw and yr entry points run one tensor-core schedule,
// fused_recon_tc_kernel<In, Op> below; the resident kernel keeps its own SIMT
// schedule.

#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace {

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// ---------------------------------------------------------------------------
// fused_recon_tc_kernel<In, Op>: the group sum on the tensor cores, for raw
// u8 frames (In = uint8_t, the ratio formed on chip) or an f32 ratio stack
// (In = float), against a bf16 or an f32 operator (Op).  The C entry points:
//
//   fdoct_recon_raw_u8_bf16  mma.sync.m16n8k16.f32.bf16.bf16.f32
//   fdoct_recon_yr_f32_bf16  mma.sync.m16n8k16.f32.bf16.bf16.f32
//   fdoct_recon_raw_u8_f32   mma.sync.m16n8k8.f32.tf32.tf32.f32, 3xTF32
//   fdoct_recon_yr_f32_f32   mma.sync.m16n8k8.f32.tf32.tf32.f32, 3xTF32
//
// The schedule is namespace tc of hopper_mma.cuh, shared with int8_bscan.cu.
// M is (row, frame) pairs, ordered row * F + frame with F = min(8, B rounded
// up to a power of two) frames in flight: a 64-pair block holds all F frames
// of 64 / F rows, so pi and inv_background are staged once for all frames of
// a row and each operator tile serves every frame (the SIMT form this
// replaces re-staged both per frame and reached ~10 % of the FP32 peak).  N
// is 64 depths, re and im side by side.  Per stage of KT samples the input
// rows, pi, inv_background (raw only) and the operator arrive by 16-byte
// cp.async in a 3-stage ring.  Four warps (2 x 2) each hold 32 pairs x 32
// depths: 64 f32 accumulators and 32 magnitude sums per thread.  After each
// chunk of F frames |re + i im| is added to the thread's frame slot; after
// the last, the F slots of a row are summed with __shfl_xor_sync and one lane
// stores.  Without 16-byte alignment (n_in or ndisp not a whole number of
// 16-byte copies, or a base pointer) the stages load element by element.
// Masked pairs (frames past B, rows past rows) get a zero ratio; samples past
// n_in and depths past ndisp stage as zero.  No atomics, deterministic.
//
// The A tile (the ratio of the stage's pairs, as the tensor cores take it):
//   * raw frames: formed from the staged u8, pi and inv_background into its
//     own shared tile, rounded op by op as torch computes it ((raw - pi) *
//     inv), then rounded to bf16 for a bf16 operator;
//   * yr, bf16 operator: the staged f32 rows rounded to bf16
//     (__float2bfloat16_rn, as the plain version's .to(torch.bfloat16)) into
//     its own tile.  The stage holds 64 x 64 f32 (16 KiB) instead of kernel
//     1's 4 KiB u8 + pi/inv_background: 110,592 B of shared memory, two
//     blocks per SM;
//   * yr, f32 operator: the staged f32 rows themselves; no pass, one barrier
//     per stage.
// Either tile pass runs after the stage's barrier (every warp is then past
// the previous stage's MMAs) and before one more.
//
// bf16 operator (KT = 64): A by ldmatrix, the depth-contiguous operator by
// ldmatrix.trans, so the operator needs no repacking; rows are padded to 144
// and 272 bytes so neither load has bank conflicts.  What bounds it: the
// L2 -> SM traffic (the operator tile once per 64-pair tile, the frame rows
// once per 64-depth tile: 384 MiB a flagship group for raw frames, 768 MiB
// for a yr stack), the tile pass and two barriers a stage, not the tensor
// cores (~11 % of the bf16 peak for the raw instance).
//
// f32 operator, 3xTF32 (KT = 32).  Each f32 operand a is split as a = a_hi +
// a_lo, a_hi its round to the nearest TF32 (ties away from zero) and a_lo the
// exact remainder truncated to TF32, so |a - a_hi - a_lo| <= 2^-21 |a|; then
// a.b ~ a_lo.b_hi + a_hi.b_lo + a_hi.b_hi on mma.sync m16n8k8 tf32 with f32
// sums (the dropped a_lo.b_lo is below 2^-22 |a.b|): f32-grade products at
// three times the TF32 work, 0.104 ms of tensor-core time a flagship group.
// The tensor cores' f32 sums are not rounded to nearest: on the H100, 768
// MMAs chained into one accumulator (2048 samples x 3 products) erred 20-26x
// more than cuBLAS f32 against the float64 product, and lo.hi and hi.lo in
// an accumulator of their own cut that by less than 3x.  So each stage's 12
// MMAs per output go into a zeroed fragment, added to the running sums with
// __fadd_rn: then the card's error is cuBLAS f32's or below.
// ldmatrix moves only 16-bit elements, so the fragments come by 32-bit
// shared loads; the A rows are padded to 36 floats and the operator rows to
// 136, so lane (g, t) reads bank (4g + t) % 32 of A and (8t + g) % 32 of the
// operator: no conflicts.  A is split in registers as its fragment loads
// (one A fragment serves 8 operator fragments).  The operator is split in
// registers too, as its fragment loads (once per 16-pair tile, which keeps
// the zeroed fragment at 32 registers), not once per staged tile into hi/lo
// shared tiles or once per Calibration into hi/lo tables: both of those
// double the operator's shared-memory footprint (and the tables its L2 -> SM
// traffic, 512 -> 1,024 MiB a flagship group), and a staged split spends as
// many issue slots (a pass of 32 loads, 2 x 32 stores and 32 x 4 integer ops
// a thread, then twice the fragment loads) as the 4 integer ops per element
// it saves.  KT = 32 keeps the f32 ring at 73,728 B (raw) and 79,872 B (yr)
// at B = 8, two blocks per SM.  What bounds it: the tensor cores' TF32 rate
// (48 MMAs per warp per 8 samples) and the split's integer work beside it.

// Per operator type: spectral samples per stage and the row pitches (bytes)
// of the A tile [pair][k] and of the operator tile [k][re 64 | im 64].
template <typename Op> struct TcOp;
template <> struct TcOp<__nv_bfloat16> {
  static constexpr int KT = tc::KT;                  // 64
  static constexpr int A_LD = KT * 2 + 16;           // 144
  static constexpr int OP_LD = 2 * tc::BN * 2 + 16;  // 272
};
template <> struct TcOp<float> {
  static constexpr int KT = tc::KT / 2;              // 32
  static constexpr int A_LD = KT * 4 + 16;           // 144: 36 floats
  static constexpr int OP_LD = 2 * tc::BN * 4 + 32;  // 544: 136 floats
};

// The input rows of a stage, [pair][k]: u8 frames, or the f32 ratio (its
// rows at A's pitch where the MMAs read them as the A tile).
template <typename In, typename Op> struct TcIn {
  static constexpr bool RAW = std::is_same<In, uint8_t>::value;
  static constexpr bool A_IN_STAGE = !RAW && std::is_same<Op, float>::value;
  static constexpr int LD = RAW ? TcOp<Op>::KT
                                : (A_IN_STAGE ? TcOp<Op>::A_LD : TcOp<Op>::KT * 4);
  static constexpr int BYTES = tc::BM * LD;
};
static_assert(TcOp<__nv_bfloat16>::A_LD % 16 == 0 && TcOp<__nv_bfloat16>::OP_LD % 16 == 0 &&
              TcOp<float>::A_LD % 16 == 0 && TcOp<float>::OP_LD % 16 == 0, "16-byte rows");
static_assert(TcOp<float>::KT % 16 == 0, "whole 16-byte copies of u8 rows");

// One stage: input rows | operator | pi [R][KT] f32 | inv_background [R][KT]
// f32 (raw frames only), R = tc::BM / F rows.
template <typename In, typename Op>
__host__ __device__ constexpr int tc_stage_bytes(int R) {
  return TcIn<In, Op>::BYTES + TcOp<Op>::KT * TcOp<Op>::OP_LD +
         (TcIn<In, Op>::RAW ? 2 * R * TcOp<Op>::KT * static_cast<int>(sizeof(float)) : 0);
}

// 16 bytes (16 / sizeof(T) elements) from src into shared dst, the elements
// from n on zero (all of them for n <= 0).  VEC: one cp.async, for a 16-byte
// aligned src and n either <= 0 or a whole copy; otherwise element loads.
template <bool VEC, typename T>
__device__ __forceinline__ void stage16(void* dst, const T* src, int n, const T* base) {
  if (VEC) {
    cp_async16(dst, n > 0 ? src : base, n > 0 ? 16 : 0);
  } else {
    using Bits = typename std::conditional<
        sizeof(T) == 1, uint8_t,
        typename std::conditional<sizeof(T) == 2, uint16_t, uint32_t>::type>::type;
    constexpr int N = 16 / static_cast<int>(sizeof(T));
    const Bits* s = reinterpret_cast<const Bits*>(src);
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < N; ++j)
      w[j * sizeof(T) / 4] |= (j < n ? static_cast<uint32_t>(s[j]) : 0u)
                              << ((j * sizeof(T)) % 4 * 8);
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

template <typename In, typename Op, bool VEC>
__device__ __forceinline__ void tc_load_stage(uint8_t* stage, const In* x, const float* pi,
                                              const float* inv_bg, const Op* op_re,
                                              const Op* op_im, int kt, int b0, int fs, int R,
                                              int row0, int col0, int B, int rows, int n_in,
                                              int ndisp, int tid) {
  using I = TcIn<In, Op>;
  constexpr int KT = TcOp<Op>::KT;
  constexpr int XN = 16 / static_cast<int>(sizeof(In));   // input samples per copy
  constexpr int ON = 16 / static_cast<int>(sizeof(Op));   // operator depths per copy
  uint8_t* op_s = stage + I::BYTES;
  const int k0 = kt * KT;
  for (int i = tid; i < tc::BM * (KT / XN); i += tc::THREADS) {
    const int m = i / (KT / XN), c = i % (KT / XN);
    const int b = b0 + tc::pair_frame(m, fs), r = row0 + tc::pair_row(m, fs), k = k0 + c * XN;
    stage16<VEC>(stage + m * I::LD + c * 16, x + (static_cast<size_t>(b) * rows + r) * n_in + k,
                 b < B && r < rows ? n_in - k : 0, x);
  }
  if constexpr (I::RAW) {
    float* pi_s = reinterpret_cast<float*>(op_s + KT * TcOp<Op>::OP_LD);
    float* inv_s = pi_s + R * KT;
    for (int i = tid; i < R * (KT / 4); i += tc::THREADS) {
      const int rr = i / (KT / 4), c = i % (KT / 4);
      const int r = row0 + rr, k = k0 + c * 4;
      const int n = r < rows ? n_in - k : 0;
      const size_t idx = static_cast<size_t>(r) * n_in + k;
      stage16<VEC>(pi_s + rr * KT + c * 4, pi + idx, n, pi);
      stage16<VEC>(inv_s + rr * KT + c * 4, inv_bg + idx, n, inv_bg);
    }
  }
  // the operator: ON depths per copy, re then im
  for (int i = tid; i < KT * (2 * tc::BN / ON); i += tc::THREADS) {
    const int k = i / (2 * tc::BN / ON), c = i % (2 * tc::BN / ON);
    const int gk = k0 + k, d = col0 + (c % (tc::BN / ON)) * ON;
    const Op* op = c < tc::BN / ON ? op_re : op_im;
    stage16<VEC>(op_s + k * TcOp<Op>::OP_LD + c * 16, op + static_cast<size_t>(gk) * ndisp + d,
                 gk < n_in ? ndisp - d : 0, op);
  }
}

// The A tile of one stage into a_s (not for A_IN_STAGE), 4 samples per
// thread and step: the ratio of each pair as the operator type takes it.
template <typename In, typename Op>
__device__ __forceinline__ void tc_ratio_tile(const uint8_t* stage, uint8_t* a_s, int b0, int fs,
                                              int R, int row0, int B, int rows, int tid) {
  using I = TcIn<In, Op>;
  constexpr int KT = TcOp<Op>::KT;
  for (int i = tid; i < tc::BM * (KT / 4); i += tc::THREADS) {
    const int m = i / (KT / 4), k = (i % (KT / 4)) * 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (I::RAW) {
      const float* pi_s = reinterpret_cast<const float*>(stage + I::BYTES + KT * TcOp<Op>::OP_LD);
      const float* inv_s = pi_s + R * KT;
      const int rr = tc::pair_row(m, fs);
      if (b0 + tc::pair_frame(m, fs) < B && row0 + rr < rows) {
        const uint32_t w = *reinterpret_cast<const uint32_t*>(stage + m * I::LD + k);
        const float4 p = *reinterpret_cast<const float4*>(pi_s + rr * KT + k);
        const float4 v = *reinterpret_cast<const float4*>(inv_s + rr * KT + k);
        x[0] = __fmul_rn(__fsub_rn(static_cast<float>(w & 0xffu), p.x), v.x);
        x[1] = __fmul_rn(__fsub_rn(static_cast<float>((w >> 8) & 0xffu), p.y), v.y);
        x[2] = __fmul_rn(__fsub_rn(static_cast<float>((w >> 16) & 0xffu), p.z), v.z);
        x[3] = __fmul_rn(__fsub_rn(static_cast<float>(w >> 24), p.w), v.w);
      }
    } else {   // masked pairs staged as zero
      const float4 y = *reinterpret_cast<const float4*>(stage + m * I::LD + k * 4);
      x[0] = y.x, x[1] = y.y, x[2] = y.z, x[3] = y.w;
    }
    if constexpr (std::is_same<Op, float>::value) {
      *reinterpret_cast<float4*>(a_s + m * TcOp<Op>::A_LD + k * 4) =
          make_float4(x[0], x[1], x[2], x[3]);
    } else {
      uint2 packed;
      packed.x = bf16_bits(__float2bfloat16_rn(x[0])) | bf16_bits(__float2bfloat16_rn(x[1])) << 16;
      packed.y = bf16_bits(__float2bfloat16_rn(x[2])) | bf16_bits(__float2bfloat16_rn(x[3])) << 16;
      *reinterpret_cast<uint2*>(a_s + m * TcOp<Op>::A_LD + k * 2) = packed;
    }
  }
}

// One staged chunk through the bf16 tensor cores: acc[mt][j] re (j < 4), im
// (j >= 4)
__device__ __forceinline__ void tc_mma_stage_bf16(const uint8_t* a_s, const uint8_t* op_s,
                                                  float (&acc)[2][8][4], const tc::Frag& f) {
  using T = TcOp<__nv_bfloat16>;
  const uint32_t a_base = smem_addr(a_s);
  const uint32_t b_base = smem_addr(op_s);
  const int lane = f.lane;
#pragma unroll
  for (int kk = 0; kk < T::KT; kk += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
      ldmatrix_x4(a[mt], a_base + (f.wm * tc::WM + mt * 16 + (lane & 15)) * T::A_LD +
                             (kk + (lane >> 4) * 8) * 2);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // matrices: re k0-7, re k8-15, im k0-7, im k8-15 of depths j*8..+7
      uint32_t b[4];
      const int krow = kk + ((lane >> 3) & 1) * 8 + (lane & 7);
      const int n = (lane >> 4) * tc::BN + f.wn * tc::WN + j * 8;
      ldmatrix_x4_trans(b, b_base + krow * T::OP_LD + n * 2);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        mma_bf16(acc[mt][j], a[mt], b[0], b[1]);
        mma_bf16(acc[mt][4 + j], a[mt], b[2], b[3]);
      }
    }
  }
}

// x = hi + lo + e, |e| <= 2^-21 |x|, hi and lo TF32 (low 13 bits zero): hi
// rounds x to nearest, ties away from zero; lo truncates the exact x - hi
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & 0xffffe000u;
}

// One staged chunk through the TF32 tensor cores, three products per pair of
// operands: acc[mt][j] re (j < 4), im (j >= 4).  Each 16-pair tile mt sums
// the stage's MMAs into a zeroed fragment, added to acc in round-to-nearest
// f32 (the tensor cores truncate their sums; see the note above); one tile
// at a time, so the fragment costs 32 registers, not 64, and the operator
// fragments are loaded and split once per tile.
__device__ __forceinline__ void tc_mma_stage_tf32x3(const uint8_t* a_s, const uint8_t* op_s,
                                                    float (&acc)[2][8][4], const tc::Frag& f) {
  using T = TcOp<float>;
  constexpr int ALD = T::A_LD / 4, OLD = T::OP_LD / 4;   // in floats
  const float* a = reinterpret_cast<const float*>(a_s) + (f.wm * tc::WM + f.g) * ALD + f.t;
  const float* b = reinterpret_cast<const float*>(op_s) + f.t * OLD + f.wn * tc::WN + f.g;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float part[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < T::KT; kk += 8) {
      uint32_t ah[4], al[4];         // rows g, g + 8 x samples t, t + 4 of the 16-pair tile
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split_tf32(a[(mt * 16 + (i & 1) * 8) * ALD + kk + (i >> 1) * 4], ah[i], al[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {  // depths (j & 3) * 8.. of re (j < 4), then of im
        const float* bj = b + kk * OLD + (j >> 2) * tc::BN + (j & 3) * 8;
        uint32_t bh[2], bl[2];       // samples t, t + 4
        split_tf32(bj[0], bh[0], bl[0]);
        split_tf32(bj[4 * OLD], bh[1], bl[1]);
        mma_tf32(part[j], al, bh[0], bh[1]);
        mma_tf32(part[j], ah, bl[0], bl[1]);
        mma_tf32(part[j], ah, bh[0], bh[1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = __fadd_rn(acc[mt][j][e], part[j][e]);
  }
}

template <typename In, typename Op, bool VEC>
__global__ void __launch_bounds__(tc::THREADS)
fused_recon_tc_kernel(const In* __restrict__ x, const float* __restrict__ pi,
                      const float* __restrict__ inv_bg, const Op* __restrict__ op_re,
                      const Op* __restrict__ op_im, float* __restrict__ out,
                      int B, int rows, int n_in, int ndisp, int fs) {
  using I = TcIn<In, Op>;
  extern __shared__ __align__(128) uint8_t tc_smem[];
  const int R = tc::BM >> fs;
  const int stage_bytes = tc_stage_bytes<In, Op>(R);
  uint8_t* a_s = tc_smem + tc::STAGES * stage_bytes;   // the A tile, unless A_IN_STAGE

  const int tid = threadIdx.x;
  const tc::Frag f(tid, fs);
  const int row0 = blockIdx.y * R;
  const int col0 = blockIdx.x * tc::BN;
  const int nk = (n_in + TcOp<Op>::KT - 1) / TcOp<Op>::KT;

  float mag[2][2][4][2] = {};          // [mt][h][j][e], this thread's frame slot
  for (int b0 = 0; b0 < B; b0 += 1 << fs) {
    float acc[2][8][4] = {};
    tc::stage_ring(
        tc_smem, stage_bytes, nk,
        [&](uint8_t* stage, int kt) {
          tc_load_stage<In, Op, VEC>(stage, x, pi, inv_bg, op_re, op_im, kt, b0, fs, R, row0,
                                     col0, B, rows, n_in, ndisp, tid);
        },
        [&](const uint8_t* stage) {
          const uint8_t* op_s = stage + I::BYTES;
          const uint8_t* a_tile = stage;
          if constexpr (!I::A_IN_STAGE) {   // a_s is free: every warp is past the last MMAs
            tc_ratio_tile<In, Op>(stage, a_s, b0, fs, R, row0, B, rows, tid);
            __syncthreads();                 // the A tile is whole
            a_tile = a_s;
          }
          if constexpr (std::is_same<Op, float>::value) tc_mma_stage_tf32x3(a_tile, op_s, acc, f);
          else tc_mma_stage_bf16(a_tile, op_s, acc, f);
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

template <typename In, typename Op>
int launch_tc(const void* x, const void* pi, const void* inv_bg, const void* op_re,
              const void* op_im, void* out, int B, int rows, int n_in, int ndisp, void* stream) {
  using I = TcIn<In, Op>;
  if (B < 1 || rows < 1 || n_in < 1 || ndisp < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int fs = tc::frames_shift(B);  // log2 of the frames in flight
  const int R = tc::BM >> fs;
  if ((rows + R - 1) / R > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool vec = n_in % (16 / sizeof(In)) == 0 && ndisp % (16 / sizeof(Op)) == 0 &&
                   aligned(x) && aligned(op_re) && aligned(op_im) &&
                   (!I::RAW || (aligned(pi) && aligned(inv_bg)));
  const auto kernel =
      vec ? fused_recon_tc_kernel<In, Op, true> : fused_recon_tc_kernel<In, Op, false>;
  const int smem = tc::STAGES * tc_stage_bytes<In, Op>(R) +
                   (I::A_IN_STAGE ? 0 : tc::BM * TcOp<Op>::A_LD);
  const cudaError_t attr =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((ndisp + tc::BN - 1) / tc::BN, (rows + R - 1) / R);
  kernel<<<grid, tc::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const In*>(x), static_cast<const float*>(pi), static_cast<const float*>(inv_bg),
      static_cast<const Op*>(op_re), static_cast<const Op*>(op_im), static_cast<float*>(out), B,
      rows, n_in, ndisp, fs);
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
// FMA rate (17.2 GFLOP per flagship group: 0.256 ms at 67 TFLOP/s).  The b loop is
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
            v = bf16_round((static_cast<float>(raw[(b0 + b) * frame + rk]) - p) * inv);
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
  return launch_tc<uint8_t, float>(raw, pi, inv_bg, op_re, op_im, out, B, rows, n_in, ndisp,
                                   stream);
}

int fdoct_recon_raw_u8_bf16(const void* raw, const void* pi, const void* inv_bg,
                            const void* op_re, const void* op_im, void* out,
                            int B, int rows, int n_in, int ndisp, void* stream) {
  return launch_tc<uint8_t, __nv_bfloat16>(raw, pi, inv_bg, op_re, op_im, out, B, rows, n_in,
                                           ndisp, stream);
}

int fdoct_recon_yr_f32_f32(const void* yr, const void* op_re, const void* op_im, void* out,
                           int B, int rows, int n_in, int ndisp, void* stream) {
  return launch_tc<float, float>(yr, nullptr, nullptr, op_re, op_im, out, B, rows, n_in, ndisp,
                                 stream);
}

int fdoct_recon_yr_f32_bf16(const void* yr, const void* op_re, const void* op_im, void* out,
                            int B, int rows, int n_in, int ndisp, void* stream) {
  return launch_tc<float, __nv_bfloat16>(yr, nullptr, nullptr, op_re, op_im, out, B, rows, n_in,
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
