// Fused FD-OCT group reconstruction for NVIDIA Hopper (sm_90a).
//
//   out[r, d] = sum_b | x_b[r, :] @ (op_re + i*op_im)[:, d] |
//
// Replaces three Pallas TPU kernels of fdoct_tpu/ops/pallas_kernels.py:
//   * fdoct_recon_raw_{u8,u16}_*  <- fused_recon_raw_accumulate
//     (_recon_raw_kernel, pallas_kernels.py:126-160), raw u8 or u16 frames as
//     the TPU kernel takes them: x_b = (raw[b] - pi_frame) * inv_background,
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
// or 16 MiB u16 frames, or 32 MiB f32 ratio, 8 MiB pi/inv_background, 4-8
// MiB operator, 1 MiB out): 400-800 FLOP/byte, compute-bound at every
// precision.  The least time for the products: 17.4 us on the bf16 tensor
// cores (989 TFLOP/s); with an f32 operator 0.256 ms on the SIMT FP32 pipes (67
// TFLOP/s) or 0.104 ms as three TF32 products on the tensor cores (495
// TFLOP/s), the form taken here.
//
// The six raw and yr entry points run one mma.sync schedule,
// fused_recon_tc_kernel<In, Op> below; the resident kernel runs its own
// wgmma + TMA schedule at the end of the file.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace {

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// ---------------------------------------------------------------------------
// fused_recon_tc_kernel<In, Op>: the group sum on the tensor cores, for raw
// u8 or u16 frames (In = uint8_t or uint16_t, the ratio formed on chip) or
// an f32 ratio stack (In = float), against a bf16 or an f32 operator (Op).
// The C entry points:
//
//   fdoct_recon_raw_u8_bf16   mma.sync.m16n8k16.f32.bf16.bf16.f32
//   fdoct_recon_raw_u16_bf16  mma.sync.m16n8k16.f32.bf16.bf16.f32
//   fdoct_recon_yr_f32_bf16   mma.sync.m16n8k16.f32.bf16.bf16.f32
//   fdoct_recon_raw_u8_f32    mma.sync.m16n8k8.f32.tf32.tf32.f32, 3xTF32
//   fdoct_recon_raw_u16_f32   mma.sync.m16n8k8.f32.tf32.tf32.f32, 3xTF32
//   fdoct_recon_yr_f32_f32    mma.sync.m16n8k8.f32.tf32.tf32.f32, 3xTF32
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
// u16 frames (Mono16, 12-bit counts, the synthetic source's bpp > 8) stage
// as u8 frames do, two bytes a sample: a 16-byte copy holds 8 samples, so
// the vector path needs n_in % 8 == 0 where u8 needs n_in % 16, and the
// frame rows of a stage take twice the bytes.  At B = 8 a bf16 block holds
// 98,304 B of shared memory (u8: 86,016) and an f32 block 79,872 B (u8:
// 73,728), still two blocks per SM; at B = 1 (R = 64 rows, pi and
// inv_background 32 KiB a stage) 184,320 B, one block, as u8's 172,032 B.
// The u8 instances' code is unchanged (the u16 widening is a branch of its
// own in tc_ratio_tile).
//
// The A tile (the ratio of the stage's pairs, as the tensor cores take it):
//   * raw frames: formed from the staged u8/u16, pi and inv_background into its
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

// The input rows of a stage, [pair][k]: u8 or u16 frames, or the f32 ratio
// (its rows at A's pitch where the MMAs read them as the A tile).  LD is in
// bytes.
template <typename In, typename Op> struct TcIn {
  static constexpr bool RAW = std::is_same<In, uint8_t>::value ||
                              std::is_same<In, uint16_t>::value;
  static constexpr bool A_IN_STAGE = !RAW && std::is_same<Op, float>::value;
  static constexpr int LD = RAW ? TcOp<Op>::KT * static_cast<int>(sizeof(In))
                                : (A_IN_STAGE ? TcOp<Op>::A_LD : TcOp<Op>::KT * 4);
  static constexpr int BYTES = tc::BM * LD;
};
static_assert(TcOp<__nv_bfloat16>::A_LD % 16 == 0 && TcOp<__nv_bfloat16>::OP_LD % 16 == 0 &&
              TcOp<float>::A_LD % 16 == 0 && TcOp<float>::OP_LD % 16 == 0, "16-byte rows");
static_assert(TcOp<float>::KT % 16 == 0, "whole 16-byte copies of u8 (and u16) rows");

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
        const float4 p = *reinterpret_cast<const float4*>(pi_s + rr * KT + k);
        const float4 v = *reinterpret_cast<const float4*>(inv_s + rr * KT + k);
        float c[4];                    // the 4 counts, exact in f32
        if constexpr (sizeof(In) == 1) {
          const uint32_t w = *reinterpret_cast<const uint32_t*>(stage + m * I::LD + k);
          c[0] = static_cast<float>(w & 0xffu), c[1] = static_cast<float>((w >> 8) & 0xffu);
          c[2] = static_cast<float>((w >> 16) & 0xffu), c[3] = static_cast<float>(w >> 24);
        } else {
          const uint2 w = *reinterpret_cast<const uint2*>(stage + m * I::LD + k * 2);
          c[0] = static_cast<float>(w.x & 0xffffu), c[1] = static_cast<float>(w.x >> 16);
          c[2] = static_cast<float>(w.y & 0xffffu), c[3] = static_cast<float>(w.y >> 16);
        }
        x[0] = __fmul_rn(__fsub_rn(c[0], p.x), v.x);
        x[1] = __fmul_rn(__fsub_rn(c[1], p.y), v.y);
        x[2] = __fmul_rn(__fsub_rn(c[2], p.z), v.z);
        x[3] = __fmul_rn(__fsub_rn(c[3], p.w), v.w);
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
// raw bf16 instance above, with the bf16 operator that the TPU kernel keeps
// in VMEM for the whole grid while each frame streams through once.
//
// On Hopper the 4 MiB bf16 operator of the flagship (2 x 2048 x 512) stays
// hot in the 50 MB L2, and what the schedule saves is the work around the
// products: TMA moves every tile (no thread instruction or register per
// byte), and wgmma takes its A operand, the bf16 ratio, straight from
// registers, so the ratio never goes through shared memory and needs no
// barrier of its own.
//
//   * Block tile: 128 (row, frame) pairs (tc::pair_row / pair_frame: pair
//     m = row * F + frame, F = 1 << tc::frames_shift(B) frames in flight,
//     so 16 rows x 8 frames at B >= 8) x 128 depths.  Two warpgroups of 64
//     pairs each run wgmma.mma_async.m64n256k16.f32.bf16.bf16: N = 256 is
//     re and im of the 128 depths, 128 f32 sums per thread.  The flagship
//     grid is 4 depth tiles x 32 pair tiles = 128 blocks, one wave on 132
//     SMs.  Groups of more than F frames run in chunks of F.
//   * A from registers: lane (g, t) of warp w holds pairs 16w + g and 16w +
//     g + 8 of its warpgroup (rows 2w and 2w + 1, frame g at F = 8).  Per
//     16-sample step it reads its 8 u8 samples, pi and inv_background from
//     the stage, forms the ratio op by op as tc_ratio_tile does ((raw - pi)
//     * inv, each rounded to f32, then to bf16 to nearest even) and packs
//     the four A registers.  pi and inv_background are the same for the 8
//     g-lanes of a row: their loads broadcast.  The frames tile arrives
//     pair-major ([row][frame][64 samples]) with TMA's 64-byte swizzle, so
//     the 8 g-lanes' sample loads fall on 8 distinct bank groups.
//   * B, the operator, by TMA into a 128-byte-swizzled ring of RES_STAGES
//     stages, MN-major (the operator is depth-contiguous as Calibration
//     builds it): per 64-sample stage re and im as four 64 x 64 boxes (a
//     128-byte swizzle limits a box's row to 64 bf16).  With the frames
//     (64 B x 128 pairs), pi and inv_background (R rows x 64 f32 each) a
//     stage is 48 KiB at B >= 8; 4 stages, 192 KiB.  One mbarrier per stage
//     counts the TMA bytes in (full), one counts the 8 warps out (empty).
//     Thread 0 issues the loads: a stage's slot is reloaded as soon as the
//     wgmmas of the stage before have been waited for, so RES_STAGES - 1
//     stages are in flight behind the one being multiplied.
//   * Per 16-sample step one wgmma is committed and the previous one waited
//     for (wgmma.wait_group 1), the A registers double-buffered.  ptxas
//     still serialises the wgmmas (C7513: an A register is written while a
//     wgmma is in flight) and waits for each right after it is issued, so
//     one warpgroup forms its ratio while the other's wgmma runs, not its
//     own.  Forming a stage's four fragments before four back-to-back
//     wgmmas avoids the serialisation but measured no faster (PERF.md).
//     Each block loads its own operator tiles: a cluster of 2 that
//     multicast each tile to both SMs measured 17 % slower (PERF.md).
//   * Epilogue: after the last stage of a chunk of frames, |re + i im| is
//     added to the thread's frame slot (tc::add_magnitude's rounding); after
//     the last chunk the slots of a row are summed with tc::sum_frame_slots'
//     shuffles (the wgmma accumulator has the mma.sync (g, t) row map) and
//     one lane stores.  No atomics, deterministic.
//
// Ragged edges cost nothing: TMA fills elements outside a tensor with zero,
// so rows past ``rows`` and samples past n_in give a zero ratio and zero
// operator rows, depths past ndisp zero columns; pairs of frames past B are
// zeroed in registers.  TMA needs n_in % 16 == 0, ndisp % 8 == 0 and 16-byte
// aligned bases (resident_wgmma_applies); other shapes run the mma.sync
// schedule launch_tc<uint8_t, __nv_bfloat16> from the same C entry
// (ops.kernels.resident_schedule mirrors the rule).
//
// The least time: the products, 17.2 GFLOP a flagship group, 17.4 us at the
// dense bf16 peak, against L2 -> SM traffic of 128 MiB of operator (32 pair
// tiles x 4 MiB) and 64 MiB of frames, pi and
// inv_background (4 depth tiles x 16 MiB), where kernel 1 bf16 moves 384 MiB.
// Measured on an NVIDIA H100 80GB HBM3 at 700 W it takes ~58 us, and the
// products are not what bounds it: without any wgmma, without the ratio's
// formation or without the TMA traffic it still takes 41-53 us, and the
// stage loop with none of the three ~28 us (PERF.md).

namespace res {
constexpr int BM = 128;            // (row, frame) pairs per block: two warpgroups of 64
constexpr int BN = 128;            // depths per block; N = 256 with re and im
constexpr int KT = 64;             // spectral samples per stage
constexpr int MAX_STAGES = 4;
constexpr int THREADS = 256;
constexpr int OP_BOX = KT * 64 * 2;           // one 64-sample x 64-depth bf16 box
constexpr int OP_BYTES = 4 * OP_BOX;          // re 0-63 | re 64-127 | im 0-63 | im 64-127
constexpr int FRAME_BYTES = BM * KT;          // u8 [pair][sample], 64-byte swizzle
constexpr int SMEM_LIMIT = 232448;            // shared memory a block may take
constexpr int SMEM_EXTRA = 1024 + 2 * MAX_STAGES * 8;   // 1,024-byte alignment + barriers
static_assert(FRAME_BYTES % 1024 == 0 && OP_BOX % 1024 == 0, "1,024-byte aligned regions");

// One stage: operator | frames | pi [R][KT] f32 | inv_background [R][KT] f32,
// R = BM / F rows; a multiple of 1,024 bytes for every R.
__host__ __device__ constexpr int stage_bytes(int R) {
  return OP_BYTES + FRAME_BYTES + 2 * R * KT * static_cast<int>(sizeof(float));
}
}  // namespace res

// The A fragment of 16-sample step kk of a landed stage: pairs m0 (a[0],
// a[2]) and m1 = m0 + 8 (a[1], a[3]), rows r0 and r1 of the block, samples
// 16kk + 2t, +1 (a[0], a[1]) and +8, +9 (a[2], a[3]).  Pairs of frames past
// B (live false) are zero.
__device__ __forceinline__ void res_ratio_fragment(uint32_t (&a)[4], const uint8_t* stage, int kk,
                                                   int m0, int r0, int r1, int t, int R,
                                                   bool live) {
  const uint8_t* frames = stage + res::OP_BYTES;
  const float* pi_s = reinterpret_cast<const float*>(frames + res::FRAME_BYTES);
  const float* inv_s = pi_s + R * res::KT;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 8 * h, r = h ? r1 : r0;
    // 64-byte swizzle: the 16-byte chunk of a 64-byte row XOR bits 7-8 of its address
    const uint8_t* x = frames + m * res::KT + (((kk ^ (m >> 1)) & 3) << 4) + 2 * t;
    const uint32_t lo = *reinterpret_cast<const uint16_t*>(x);
    const uint32_t hi = *reinterpret_cast<const uint16_t*>(x + 8);
    const int k = r * res::KT + 16 * kk + 2 * t;
    const float2 p0 = *reinterpret_cast<const float2*>(pi_s + k);
    const float2 p1 = *reinterpret_cast<const float2*>(pi_s + k + 8);
    const float2 v0 = *reinterpret_cast<const float2*>(inv_s + k);
    const float2 v1 = *reinterpret_cast<const float2*>(inv_s + k + 8);
    float y[4] = {__fmul_rn(__fsub_rn(static_cast<float>(lo & 0xffu), p0.x), v0.x),
                  __fmul_rn(__fsub_rn(static_cast<float>(lo >> 8), p0.y), v0.y),
                  __fmul_rn(__fsub_rn(static_cast<float>(hi & 0xffu), p1.x), v1.x),
                  __fmul_rn(__fsub_rn(static_cast<float>(hi >> 8), p1.y), v1.y)};
    if (!live) y[0] = y[1] = y[2] = y[3] = 0.f;
    a[h] = bf16_bits(__float2bfloat16_rn(y[0])) | bf16_bits(__float2bfloat16_rn(y[1])) << 16;
    a[2 + h] = bf16_bits(__float2bfloat16_rn(y[2])) | bf16_bits(__float2bfloat16_rn(y[3])) << 16;
  }
}

__global__ void __launch_bounds__(res::THREADS, 1)
fused_recon_resident_kernel(const __grid_constant__ CUtensorMap raw_map,
                            const __grid_constant__ CUtensorMap pi_map,
                            const __grid_constant__ CUtensorMap inv_map,
                            const __grid_constant__ CUtensorMap re_map,
                            const __grid_constant__ CUtensorMap im_map, float* __restrict__ out,
                            int B, int rows, int n_in, int ndisp, int fs, int nst) {
  extern __shared__ uint8_t res_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(res_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  const int R = res::BM >> fs;
  const int sbytes = res::stage_bytes(R);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + nst * sbytes);
  uint64_t* empty = full + res::MAX_STAGES;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * R, col0 = blockIdx.x * res::BN;
  const int nk = (n_in + res::KT - 1) / res::KT;
  const int total = nk * ((B + (1 << fs) - 1) >> fs);    // stages of all chunks of frames

  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // thread 0: the copies of stage ``it`` into its slot, once the slot's
  // previous stage has been released by every warp
  const auto issue = [&](int it) {
    const int s = it % nst;
    uint8_t* st = smem + s * sbytes;
    const int k0 = (it % nk) * res::KT, b0 = (it / nk) << fs;
    if (it >= nst) mbar_wait(&empty[s], (it / nst - 1) & 1);
    mbar_expect_tx(&full[s], sbytes);
    tma_load_3d(st + res::OP_BYTES, &raw_map, &full[s], k0, b0, row0);
    tma_load_2d(st + res::OP_BYTES + res::FRAME_BYTES, &pi_map, &full[s], k0, row0);
    tma_load_2d(st + res::OP_BYTES + res::FRAME_BYTES + R * res::KT * 4, &inv_map, &full[s], k0,
                row0);
#pragma unroll
    for (int h = 0; h < 4; ++h)
      tma_load_2d(st + h * res::OP_BOX, h < 2 ? &re_map : &im_map, &full[s], col0 + (h & 1) * 64,
                  k0);
  };
  if (tid == 0)
    for (int it = 0; it < nst && it < total; ++it) issue(it);
  __syncwarp();

  const int m0 = (warp >> 2) * 64 + (warp & 3) * 16 + g;   // this lane's pairs: m0, m0 + 8
  const int frame = tc::pair_frame(m0, fs);                // the same for m0 + 8
  const int r0 = tc::pair_row(m0, fs), r1 = tc::pair_row(m0 + 8, fs);
  float acc[128];
  float mag[64];                     // [j][e]: re/im columns j*8 + 2t + (e & 1), row g + 8*(e >> 1)
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) mag[i] = 0.f;
  uint32_t a[2][4] = {};
  for (int it = 0; it < total; ++it) {
    const int s = it % nst, kt = it % nk;
    const uint8_t* st = smem + s * sbytes;
    const bool live = ((it / nk) << fs) + frame < B;
    const uint32_t b_base = smem_addr(st);
    mbar_wait(&full[s], (it / nst) & 1);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      res_ratio_fragment(a[kk & 1], st, kk, m0, r0, r1, t, R, live);
      wgmma_fence();
      wgmma_m64n256k16_rs(acc, a[kk & 1],
                          wgmma_desc_mn_sw128(b_base + kk * 16 * 128, res::OP_BOX, 1024),
                          kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();               // the step before is done: its A registers are free
      wgmma_hold(a[(kk + 1) & 1]);
      if (kk == 0 && it > 0) {       // ... and with it every wgmma of stage it - 1
        const int ps = (it - 1) % nst;
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[ps]);
        if (tid == 0 && it - 1 + nst < total) issue(it - 1 + nst);
        __syncwarp();
      }
    }
    if (kt == nk - 1) {              // the last stage of a chunk of frames
      wgmma_wait<0>();
      wgmma_hold(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) tc::add_magnitude(mag[i], acc[i], acc[64 + i]);
    }
  }
  // the F frame slots of a row (lanes 4 * slot apart)
  for (int off = 4; off < (4 << fs); off <<= 1)
#pragma unroll
    for (int i = 0; i < 64; ++i) mag[i] += __shfl_xor_sync(0xffffffffu, mag[i], off);
  if (frame == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + (h ? r1 : r0);
      if (r >= rows) continue;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int d = col0 + j * 8 + 2 * t + e;
          if (d < ndisp) out[static_cast<size_t>(r) * ndisp + d] = mag[4 * j + 2 * h + e];
        }
    }
  }
}

// cuTensorMapEncodeTiled, obtained at run time through the CUDA runtime's
// cudaGetDriverEntryPoint, so that the library does not link libcuda.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                            cudaEnableDefault, &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// A row-major tensor map: dims and box innermost first, strides (bytes) of
// dims 1.. ; zero fill outside the tensor.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                CUtensorMapSwizzle swizzle) {
  const EncodeTiledFn encode = encode_tiled();
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode != nullptr &&
         encode(map, type, static_cast<cuuint32_t>(rank), const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Whether TMA can address the shapes and bases (else the mma.sync schedule
// runs): 16-byte row strides of the u8 frames and of the bf16 operator, and
// 16-byte aligned bases.
bool resident_wgmma_applies(const void* raw, const void* pi, const void* inv_bg,
                            const void* op_re, const void* op_im, int n_in, int ndisp) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return n_in % 16 == 0 && ndisp % 8 == 0 && aligned(raw) && aligned(pi) && aligned(inv_bg) &&
         aligned(op_re) && aligned(op_im);
}

int launch_resident(const void* raw, const void* pi, const void* inv_bg, const void* op_re,
                    const void* op_im, void* out, int B, int rows, int n_in, int ndisp,
                    void* stream) {
  const int fs = tc::frames_shift(B);
  const int R = res::BM >> fs;
  const int gy = (rows + R - 1) / R;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t n = static_cast<cuuint64_t>(n_in), nr = static_cast<cuuint64_t>(rows);
  CUtensorMap maps[5];
  // frames pair-major: dims (sample, frame, row), box 64 x F x R
  const cuuint64_t raw_dims[3] = {n, static_cast<cuuint64_t>(B), nr};
  const cuuint64_t raw_strides[2] = {nr * n, n};
  const cuuint32_t raw_box[3] = {res::KT, static_cast<cuuint32_t>(1 << fs),
                                 static_cast<cuuint32_t>(R)};
  const cuuint64_t ratio_dims[2] = {n, nr}, ratio_strides[1] = {n * 4};
  const cuuint32_t ratio_box[2] = {res::KT, static_cast<cuuint32_t>(R)};
  const cuuint64_t op_dims[2] = {static_cast<cuuint64_t>(ndisp), n};
  const cuuint64_t op_strides[1] = {static_cast<cuuint64_t>(ndisp) * 2};
  const cuuint32_t op_box[2] = {64, res::KT};
  if (!tensor_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, raw, raw_dims, raw_strides,
                  raw_box, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !tensor_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, pi, ratio_dims, ratio_strides,
                  ratio_box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, inv_bg, ratio_dims,
                  ratio_strides, ratio_box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !tensor_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, op_re, op_dims, op_strides,
                  op_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !tensor_map(&maps[4], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, op_im, op_dims, op_strides,
                  op_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nst = std::min(res::MAX_STAGES,
                           (res::SMEM_LIMIT - res::SMEM_EXTRA) / res::stage_bytes(R));
  const int smem = nst * res::stage_bytes(R) + res::SMEM_EXTRA;
  const cudaError_t rc = cudaFuncSetAttribute(fused_recon_resident_kernel,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  fused_recon_resident_kernel<<<dim3((ndisp + res::BN - 1) / res::BN, gy), res::THREADS, smem,
                                static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<float*>(out), B, rows, n_in, ndisp,
      fs, nst);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes.  Every pointer is a contiguous device
// buffer: x (B, rows, n_in) u8, u16 or f32; pi, inv_bg (rows, n_in) f32;
// op_re, op_im (n_in, ndisp); out (rows, ndisp) f32.  Launches on
// ``stream`` and returns cudaGetLastError() (0 when the launch was
// accepted).
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

int fdoct_recon_raw_u16_f32(const void* raw, const void* pi, const void* inv_bg,
                            const void* op_re, const void* op_im, void* out,
                            int B, int rows, int n_in, int ndisp, void* stream) {
  return launch_tc<uint16_t, float>(raw, pi, inv_bg, op_re, op_im, out, B, rows, n_in, ndisp,
                                    stream);
}

int fdoct_recon_raw_u16_bf16(const void* raw, const void* pi, const void* inv_bg,
                             const void* op_re, const void* op_im, void* out,
                             int B, int rows, int n_in, int ndisp, void* stream) {
  return launch_tc<uint16_t, __nv_bfloat16>(raw, pi, inv_bg, op_re, op_im, out, B, rows, n_in,
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

// The resident schedule; op_re, op_im are bf16.  The wgmma + TMA schedule
// where TMA can address the inputs (resident_wgmma_applies), else the
// mma.sync schedule of fdoct_recon_raw_u8_bf16.
int fdoct_recon_resident_u8_bf16(const void* raw, const void* pi, const void* inv_bg,
                                 const void* op_re, const void* op_im, void* out,
                                 int B, int rows, int n_in, int ndisp, void* stream) {
  if (B < 1 || rows < 1 || n_in < 1 || ndisp < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!resident_wgmma_applies(raw, pi, inv_bg, op_re, op_im, n_in, ndisp))
    return launch_tc<uint8_t, __nv_bfloat16>(raw, pi, inv_bg, op_re, op_im, out, B, rows, n_in,
                                             ndisp, stream);
  return launch_resident(raw, pi, inv_bg, op_re, op_im, out, B, rows, n_in, ndisp, stream);
}

}  // extern "C"
