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
//   * fdoct_recon_resident_u8_bf16 <- fused_recon_resident
//     (pallas_kernels.py:90-123): kernel 1 u8's sum with a bf16 operator.
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
// Two schedules for each operator type.  Wherever TMA can address the
// inputs, a warp-specialised TMA + wgmma schedule: for the bf16-operator
// entries (and the resident one) fused_recon_ws_kernel<In, MULTI>
// (ws_applies), for the f32-operator entries fused_recon_ws32_kernel<In,
// MULTI>, 3xTF32 on a K-major TF32 table of the operator built once per
// Calibration (ws32_applies).  Elsewhere the mma.sync template
// fused_recon_tc_kernel<In, Op> below.  Each pair computes the same sums bit
// for bit.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

namespace {

__device__ __forceinline__ uint32_t bf16_bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// The constants of the bf16 instances' warp-specialised schedule
// (fused_recon_ws_kernel below), among them ROUND_STAGES, the interval at
// which both bf16 schedules round their tensor-core sums.
namespace ws {
constexpr int BM = 64;              // (row, frame) pairs per block: the M of one wgmma
constexpr int BN = 128;             // depths per block: 64 a consumer warpgroup, re and im make N = 128
constexpr int KT = 64;              // spectral samples per stage: four k16 steps
constexpr int ROUND_STAGES = 2;     // stages whose products one fragment sums before __fadd_rn
constexpr int MAX_STAGES = 4;
constexpr int THREADS = 512;        // warpgroups 0-1 consume (wgmma), 2 forms A, 3 produces (TMA)
constexpr int PRODUCER_REGS = 40;   // setmaxnreg of the producer warpgroup,
constexpr int FORMER_REGS = 104;    // of the one that forms A
constexpr int CONSUMER_REGS = 184;  // and of the consumers: 128 x (40 + 104) + 256 x 184 <= 65,536
constexpr int OP_BOX = KT * 64 * 2;           // one 64-sample x 64-depth bf16 box
constexpr int OP_BYTES = 4 * OP_BOX;          // re 0-63 | im 0-63 | re 64-127 | im 64-127
constexpr int A_BYTES = BM * KT * 2;          // the bf16 A tile of a stage, 64 pairs x KT
constexpr int A_TILES = 3;                    // a ring of A tiles, read by both consumer warpgroups
constexpr int SMEM_LIMIT = 232448;            // shared memory a block may take
constexpr int SMEM_EXTRA = 1024 + 2 * MAX_STAGES * 8;   // 1,024-byte alignment + the ring's barriers
static_assert((PRODUCER_REGS + FORMER_REGS) * 128 + CONSUMER_REGS * 256 <= 65536,
              "the register file");
static_assert(OP_BOX % 1024 == 0 && A_BYTES % 1024 == 0, "1,024-byte aligned regions");

template <typename In> __host__ __device__ constexpr bool raw() {
  return !std::is_same<In, float>::value;
}

// The input rows of a stage, [pair][KT] In.
template <typename In> __host__ __device__ constexpr int in_bytes() {
  return BM * KT * static_cast<int>(sizeof(In));
}
// One stage: operator | input rows | pi [R][KT] f32 | inv_background [R][KT]
// f32 (raw frames only), R = BM / F rows; a multiple of 1,024 bytes.
template <typename In> __host__ __device__ constexpr int stage_bytes(int R) {
  return OP_BYTES + in_bytes<In>() + (raw<In>() ? 2 * R * KT * static_cast<int>(sizeof(float)) : 0);
}

// log2 of the frames in flight, at every number of frames.
constexpr int FS = 3;
}  // namespace ws

// ---------------------------------------------------------------------------
// fused_recon_tc_kernel<In, Op>: the group sum on the tensor cores, for raw
// u8 or u16 frames (In = uint8_t or uint16_t, the ratio formed on chip) or
// an f32 ratio stack (In = float), against a bf16 or an f32 operator (Op).
// The C entry points that launch it:
//
//   fdoct_recon_raw_u8_bf16   mma.sync.m16n8k16.f32.bf16.bf16.f32, where TMA
//   fdoct_recon_raw_u16_bf16  cannot address the inputs (else the
//   fdoct_recon_yr_f32_bf16   warp-specialised schedule ws below)
//   fdoct_recon_raw_u8_f32    mma.sync.m16n8k8.f32.tf32.tf32.f32, 3xTF32,
//   fdoct_recon_raw_u16_f32   where TMA cannot address the inputs (else the
//   fdoct_recon_yr_f32_f32    warp-specialised 3xTF32 schedule ws32 below)
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
// bf16 operator (KT = 64), the shapes TMA cannot address (the others run
// the warp-specialised schedule below): A by ldmatrix, the depth-contiguous
// operator by ldmatrix.trans, so the operator needs no repacking; rows are
// padded to 144 and 272 bytes so neither load has bank conflicts.  The
// products go into a fragment that starts at zero every ws::ROUND_STAGES
// stages and is then added to the running sums with __fadd_rn, as the
// warp-specialised schedule rounds them (see its note): 64 more registers a
// thread, and the same sums bit for bit.  What
// bounds it: the L2 -> SM traffic (the operator tile once per 64-pair tile,
// the frame rows once per 64-depth tile: 384 MiB a flagship group for raw
// frames, 768 MiB for a yr stack), the tile pass and two barriers a stage,
// not the tensor cores (~11 % of the bf16 peak for the raw instance).
//
// f32 operator, 3xTF32 (KT = 32), the shapes TMA cannot address (the others
// run ws32 below, the same sums).  Each f32 operand a is split as a = a_hi +
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
// it saves (ws32 reads such a table all the same: wgmma takes tf32 operands
// K-major only).  KT = 32 keeps the f32 ring at 73,728 B (raw) and 79,872 B (yr)
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

// One staged chunk through the bf16 tensor cores, its products added to d
// (the tensor cores' truncating sums): d[mt][j] re (j < 4), im (j >= 4)
__device__ __forceinline__ void tc_mma_stage_bf16(const uint8_t* a_s, const uint8_t* op_s,
                                                  float (&d)[2][8][4], const tc::Frag& f) {
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
        mma_bf16(d[mt][j], a[mt], b[0], b[1]);
        mma_bf16(d[mt][4 + j], a[mt], b[2], b[3]);
      }
    }
  }
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

// d = 0; acc += d in round-to-nearest f32 (the end of a round: d holds its
// products' truncating tensor-core sums)
__device__ __forceinline__ void tc_zero(float (&d)[2][8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) d[mt][j][e] = 0.f;
}
__device__ __forceinline__ void tc_add_rn(float (&acc)[2][8][4], const float (&d)[2][8][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = __fadd_rn(acc[mt][j][e], d[mt][j][e]);
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
    float part[2][8][4] = {};          // bf16: a round's fragment
    int kt = 0;                        // the stage of this chunk of frames
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
          if constexpr (std::is_same<Op, float>::value) {
            tc_mma_stage_tf32x3(a_tile, op_s, acc, f);
          } else {                           // rounds of ws::ROUND_STAGES stages from the chunk's first
            if (kt % ws::ROUND_STAGES == 0) tc_zero(part);
            tc_mma_stage_bf16(a_tile, op_s, part, f);
            if (kt % ws::ROUND_STAGES == ws::ROUND_STAGES - 1 || kt == nk - 1) tc_add_rn(acc, part);
          }
          ++kt;
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
// The warp-specialised schedule (namespace ws) of the three bf16 instances:
//
//   fdoct_recon_raw_u8_bf16   In = uint8_t   <- fused_recon_raw_accumulate
//   fdoct_recon_raw_u16_bf16  In = uint16_t  <- fused_recon_raw_accumulate
//   fdoct_recon_yr_f32_bf16   In = float     <- fused_recon_accumulate
//
// (pallas_kernels.py:126-160, 275-308), and of fdoct_recon_resident_u8_bf16,
// which computes kernel 1 u8's sum with a bf16 operator (fused_recon_resident,
// pallas_kernels.py:90-123).  The same sums as the mma.sync instances above,
// bit for bit: the same bf16 A operand (the ratio formed op by op as
// tc_ratio_tile forms it, or the f32 ratio rounded with
// __float2bfloat16_rn), k16 steps in the same order into a fragment that
// starts at zero every ROUND_STAGES stages and is then added to f32 running
// sums with __fadd_rn, and tc::add_magnitude / the frame-slot butterfly of
// tc::sum_frame_slots after the last.
//
// The rounding.  The tensor cores' f32 sums are not rounded to nearest
// (see the 3xTF32 note above).  A chunk's 128 k16 steps chained into one
// accumulator erred 2.7x chip_smoke.py's BF16_F64_TOL against the float64
// product of the same rounded operands, on white-noise frames against the
// flagship operator, where cuBLAS f32 reads 0.5x and the JAX kernels (f32
// sums) 0.2x.  tests/test_torch_bf16_rounding.py models the sums (k16 steps
// truncated to 24 bits, a fragment every ROUND_STAGES stages added in f32):
// 3.2x never rounded, 0.15x at ROUND_STAGES = 2 (128 samples), 0.36x at 4,
// 0.86x at 8.
//
// What bounds it.  The products, 17.2 GFLOP a flagship group, take 17.4 us
// at the dense bf16 peak; the compulsory traffic (8-32 MiB of frames or
// ratio, 8 MiB of pi and inv_background, 4 MiB of operator) 4-13 us at
// 3.35 TB/s.  What the mma.sync schedule spends on top of that, and what
// this design does about each:
//   * staging by every thread (cp.async, an address and a register per 16
//     bytes): TMA moves every tile, issued by one thread of a producer
//     warpgroup that does nothing else.  It waits on the ring's "empty"
//     mbarriers and arms the "full" ones;
//   * the registers the rounding takes: a consumer thread holds 64 running
//     sums and a round's fragment of 64 (at m64n256 over 128 pairs, 256
//     would not fit), so a block is 64 (row, frame) pairs x 128 depths and
//     each of two consumer warpgroups issues wgmma.mma_async.m64n128k16 (the
//     block's 64 pairs x re and im of 64 depths, warpgroup w depths 64w ..
//     64w + 63), four back to back a 64-sample stage, on A and B in shared
//     memory.  A flagship group then moves 256 MiB of operator from the L2
//     (64 pair tiles x 4 MiB) and 64 MiB of frames, pi and inv_background
//     (4 depth tiles x 16 MiB); a u16 group 96 MiB of those, a yr group 128
//     MiB of ratio;
//   * the A tile: a fourth warpgroup forms each stage's, the block's 64
//     pairs' bf16 ratio in a K-major tile with the 128-byte swizzle
//     (16-byte chunk c of row r at chunk c ^ (r & 7)), into a ring of
//     A_TILES tiles that both consumer warpgroups read, so each output takes
//     the forming that a block of 128 pairs would and the consumers spend no
//     time on it.  Its stores are made visible to wgmma by fence.proxy.async
//     before it arrives on the tile's "full" mbarrier; the consumers release
//     a tile on its "empty" one once the wgmmas that read it are done.
//     Forming A in registers while a wgmma that reads other A registers is
//     in flight made ptxas serialise the wgmmas (C7513); shared memory has
//     no such hazard.  The counts become f32 by a byte permute and an add
//     (ws_count), not by a conversion instruction;
//   * the end of a round: its fragment is added to the running sums at the
//     next round's first stage, once that stage's A tile is ready and just
//     before its wgmmas start the fragment anew (the round's wgmmas have run
//     meanwhile), so the tensor cores wait only for the 64 adds.
// Registers (setmaxnreg): the producer warpgroup 40 a thread, the forming
// one 104, the consumers 184; 128 x (40 + 104) + 256 x 184 = 65,536.
// Measured on an NVIDIA H100 (PERF.md section 6; bench_sessions.py,
// ws_trace.py): ~50 us of device time a flagship group of u8 frames, ~52 us
// of u16 frames or of an f32 ratio, ~50 us for a group of one frame; the
// forming-and-consuming form without the fourth warpgroup took ~57 us, and
// rings of five stages, an L2 prefetch, 128-sample stages, two fragments in
// turn (spilled), a persistent grid, six A tiles and slots released as soon
// as their wgmmas finish measured no faster.  The loads and the ring's
// handoffs alone (ws_trace.py --loads-only: no forming, no wgmma) take ~33
// us (u8), ~35 (u16), ~38 (f32 ratio), ~31 (u8) with each slot released as
// soon as its wgmmas finish, a fifth stage adding nothing: the bytes each
// SM takes in (~80 GB/s each, ~10 TB/s in all), not the bytes the L2
// serves, set that floor.  With the work both roles wait for the loads,
// which forming and the wgmmas slow through the shared memory they share
// with TMA (ld.shared of the wgmmas' 48 KiB a stage in their place costs
// as much): TMA writes 40 KiB a stage, wgmma reads 48, forming moves 16.
// So clusters of two row tiles that multicast the operator, though they
// read 192 MiB from the L2 in place of 320, measured slower (53-56 us;
// their loads alone ~38), and ~86 us with the slots released by
// mbarrier.arrive.release.cluster (~1,100 more cycles a stage on each
// releasing warp).  A block of 128 pairs would halve the operator's bytes
// per output (an f32 ratio on such a block, its sums chained unrounded,
// took ~37 us) but leaves no registers for the round's fragment.
//
// The block tile and the pairs.  Pair m = row * F + frame (tc::pair_row /
// pair_frame) with F = 8 frames in flight at every number of frames B
// (ws::FS), so a block holds R = 8 rows and 512 rows are 4 depth tiles x
// 64 row tiles = 256 blocks, two waves on 132 SMs, whatever B is.  A group
// of fewer than 8 frames (one frame a launch on the per-frame and
// saveframes routes) takes zero frames: TMA fills them without reading
// memory and no A value is formed for them, and the wgmmas multiply their
// zeros on tensor cores that would otherwise idle.  Fewer frames in flight
// would give B = 1 fewer blocks of the same work each: two frames (F = 2)
// took 70 us a launch against 43 us at F = 8 (PERF.md).  Groups of more
// than 8 frames run in chunks of 8, each starting its rounds at its first
// stage (MULTI: |re + i im| is then added to a frame slot per chunk in 32
// more registers a thread; a group of at most 8 frames adds it once, after
// the last stage, into the running sums themselves).
//
// The ring.  A stage holds KT = 64 samples: the operator as four 64 x 64
// bf16 boxes (re 0-63, im 0-63, re 64-127, im 64-127: warpgroup w reads
// boxes 2w and 2w + 1 as one B of N = 128), MN-major with the 128-byte
// swizzle; the input rows pair-major ([row][frame][64 samples] through a 3-D
// tensor map of dims (sample, frame, row)), unswizzled (a warp reads whole
// rows); for raw frames pi and inv_background [8][64] f32.  40 KiB (u8), 44
// KiB (u16) or 48 KiB (f32) a stage; beside the three A tiles of 8 KiB, 4
// stages fit in 227 KB.  A stage's slot is free once the forming
// warpgroup has read its rows and the consumers' wgmmas its operator.  TMA
// fills elements outside a tensor with zero, so rows past ``rows``, frames
// past B, samples past n_in and depths past ndisp cost no memory traffic.
//
// The epilogue.  The wgmma accumulator has the mma.sync (g, t) row map: lane
// (g, t) of consumer warp w of warpgroup wg holds pairs 16 (w & 3) + g and
// + 8, depths 64 wg + 8j + 2t + (e & 1), re in acc[0..31], im in
// acc[32..63].  The F frame slots of a row lie in lanes 4 * slot apart; they
// are summed by tc::sum_frame_slots' butterfly and the slot-0 lanes store.
// No atomics, deterministic.
//
// TMA needs 16-byte row strides (n_in % 16 for u8, % 8 for u16, % 4 for f32,
// ndisp % 8) and 16-byte aligned bases (ws_applies); every other shape runs
// the mma.sync template launch_tc<In, __nv_bfloat16> from the same C entry,
// chosen before the launch (ops.kernels.bf16_schedule mirrors the rule).

// An integer count c < 2^23 as f32, exactly: the bits 0x4B000000 | c are the
// float 2^23 + c, and subtracting 2^23 is exact.  A byte permute and an add
// in the FP32 pipes, where a conversion instruction (I2F) runs at a quarter
// of their rate or less; the forming of the A tile is bound by that rate.
__device__ __forceinline__ float ws_count(uint32_t word, uint32_t selector) {
  return __fsub_rn(__uint_as_float(__byte_perm(word, 0x4B000000u, selector)), 8388608.f);
}

// Eight samples 8c..8c+7 of pair m of a landed stage, as f32: the ratio
// formed from raw counts, pi and inv_background ((raw - pi) * inv, each
// rounded to f32 as torch rounds it), or the f32 ratio itself.  p and v
// hold the pair's row of pi and inv_background (raw frames only).
template <typename In>
__device__ __forceinline__ void ws_samples(float (&y)[8], const uint8_t* in, int m, int c,
                                           const float (&p)[8], const float (&v)[8]) {
  float x[8];
  if constexpr (sizeof(In) == 1) {
    // byte j of a word -> 0x4B0000bb: selector nibbles j, 4, 5, 7
    const uint2 w = *reinterpret_cast<const uint2*>(in + m * ws::KT + 8 * c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[j] = ws_count(w.x, 0x7540u + j);
      x[4 + j] = ws_count(w.y, 0x7540u + j);
    }
  } else if constexpr (sizeof(In) == 2) {
    // the low and the high half of a word -> 0x4B00hhhh
    const uint4 w = *reinterpret_cast<const uint4*>(in + m * ws::KT * 2 + 16 * c);
    const uint32_t h[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[2 * j] = ws_count(h[j], 0x7410u);
      x[2 * j + 1] = ws_count(h[j], 0x7432u);
    }
  } else {
    const float4 a = *reinterpret_cast<const float4*>(in + m * ws::KT * 4 + 32 * c);
    const float4 b = *reinterpret_cast<const float4*>(in + m * ws::KT * 4 + 32 * c + 16);
    y[0] = a.x, y[1] = a.y, y[2] = a.z, y[3] = a.w, y[4] = b.x, y[5] = b.y, y[6] = b.z, y[7] = b.w;
  }
  if constexpr (ws::raw<In>()) {
#pragma unroll
    for (int j = 0; j < 8; ++j) y[j] = __fmul_rn(__fsub_rn(x[j], p[j]), v[j]);
  }
}

// A landed stage's A tile as thread t of the forming warpgroup forms it:
// chunk c = t & 7 (samples 8c..8c+7) of the tile's rows 4u..4u+3, u = t >>
// 3, so that a warp writes whole 128-byte rows and four frames of one row
// share one load of pi and inv_background.  PARTIAL (a chunk of fewer than
// eight frames): pairs of frames at or past ``frames`` are zero, and nothing
// is read for them; a thread's four pairs are frames 0-3 or 4-7 of one row,
// so the live ones come first and the first of them reads the row.
template <typename In, bool PARTIAL>
__device__ __forceinline__ void ws_form_a(uint32_t (&a)[4][4], const uint8_t* stage, int t,
                                          int frames) {
  constexpr int R = ws::BM >> ws::FS;
  const uint8_t* in = stage + ws::OP_BYTES;
  const float* pi_s = reinterpret_cast<const float*>(in + ws::in_bytes<In>());
  const float* inv_s = pi_s + R * ws::KT;
  const int c = t & 7, u = t >> 3;
  float p[8], v[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = 4 * u + i;
    if (PARTIAL && tc::pair_frame(m, ws::FS) >= frames) {
      a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0u;
      continue;
    }
    if constexpr (ws::raw<In>()) {
      if (i == 0) {                    // the row's pi and inv_background
        const float* pr = pi_s + tc::pair_row(m, ws::FS) * ws::KT + 8 * c;
        const float* vr = inv_s + tc::pair_row(m, ws::FS) * ws::KT + 8 * c;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float4 q = *reinterpret_cast<const float4*>(pr + 4 * h);
          const float4 w = *reinterpret_cast<const float4*>(vr + 4 * h);
          p[4 * h] = q.x, p[4 * h + 1] = q.y, p[4 * h + 2] = q.z, p[4 * h + 3] = q.w;
          v[4 * h] = w.x, v[4 * h + 1] = w.y, v[4 * h + 2] = w.z, v[4 * h + 3] = w.w;
        }
      }
    }
    float y[8];
    ws_samples<In>(y, in, m, c, p, v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {   // two samples rounded to nearest even in one instruction
      const __nv_bfloat162 pair = __floats2bfloat162_rn(y[2 * j], y[2 * j + 1]);
      a[i][j] = *reinterpret_cast<const uint32_t*>(&pair);
    }
  }
}

// Stores what ws_form_a formed into the 128-byte-swizzled K-major tile a_s.
__device__ __forceinline__ void ws_store_a(uint8_t* a_s, const uint32_t (&a)[4][4], int t) {
  const int c = t & 7, u = t >> 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * u + i;
    *reinterpret_cast<uint4*>(a_s + r * 128 + ((c ^ (r & 7)) << 4)) =
        make_uint4(a[i][0], a[i][1], a[i][2], a[i][3]);
  }
}

// acc += d in round-to-nearest f32: the end of a round, whose products the
// tensor cores summed into d.
template <int N>
__device__ __forceinline__ void ws_add_fragment(float (&acc)[N], const float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = __fadd_rn(acc[i], d[i]);
}

// |re + i im| of the N (pair, depth) sums of a thread's accumulators (re in
// acc[0..N-1], im in acc[N..2N-1]); into ``mag`` (added to it,
// tc::add_magnitude's rounding).
template <int N>
__device__ __forceinline__ void ws_add_magnitudes(float (&mag)[N], const float (&acc)[2 * N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) tc::add_magnitude(mag[i], acc[i], acc[N + i]);
}

// The epilogue of a consumer thread: the F frame slots of each of its 4J
// sums m[0..4J-1], depths 8j + 2 tq + (e & 1) for j < J (lanes 4 * slot
// apart), summed as tc::sum_frame_slots sums them, then stored by the slot-0
// lanes.
template <int J, int N>
__device__ __forceinline__ void ws_store_sums(float (&m)[N], float* __restrict__ out, int m0,
                                              int frame, int fs, int row0, int col0, int rows,
                                              int ndisp, int tq) {
  for (int off = 4; off < (4 << fs); off <<= 1)
#pragma unroll
    for (int i = 0; i < 4 * J; ++i) m[i] += __shfl_xor_sync(0xffffffffu, m[i], off);
  if (frame != 0) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + tc::pair_row(m0 + 8 * h, fs);
    if (r >= rows) continue;
#pragma unroll
    for (int j = 0; j < J; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = col0 + j * 8 + 2 * tq + e;
        if (d < ndisp) out[static_cast<size_t>(r) * ndisp + d] = m[4 * j + 2 * h + e];
      }
  }
}

template <typename In, bool MULTI>
__global__ void __launch_bounds__(ws::THREADS, 1)
fused_recon_ws_kernel(const __grid_constant__ CUtensorMap in_map,
                      const __grid_constant__ CUtensorMap pi_map,
                      const __grid_constant__ CUtensorMap inv_map,
                      const __grid_constant__ CUtensorMap re_map,
                      const __grid_constant__ CUtensorMap im_map, float* __restrict__ out, int B,
                      int rows, int n_in, int ndisp, int nst) {
  extern __shared__ uint8_t ws_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(ws_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  constexpr int fs = ws::FS, R = ws::BM >> fs;
  const int sbytes = ws::stage_bytes<In>(R);
  uint8_t* a_tiles = smem + nst * sbytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(a_tiles + ws::A_TILES * ws::A_BYTES);
  uint64_t* empty = full + ws::MAX_STAGES;
  uint64_t* a_full = empty + ws::MAX_STAGES;
  uint64_t* a_empty = a_full + ws::A_TILES;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int row0 = blockIdx.y * R, col0 = blockIdx.x * ws::BN;
  const int nk = (n_in + ws::KT - 1) / ws::KT;
  const int total = nk * ((B + (1 << fs) - 1) >> fs);    // stages of all chunks of frames

  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 12);      // the four forming and the eight consumer warps
    }
    for (int i = 0; i < ws::A_TILES; ++i) {
      mbar_init(&a_full[i], 4);      // the four forming warps
      mbar_init(&a_empty[i], 8);     // the eight consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 3) {
    // the producer: one thread issues every copy of stage it into slot it %
    // nst once the slot's previous stage has been released
    setmaxnreg_dec<ws::PRODUCER_REGS>();
    if (tid == 384) {
      for (int it = 0, s = 0, ph = 0, kt = 0, b0 = 0; it < total; ++it) {
        uint8_t* st = smem + s * sbytes;
        if (it >= nst) mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], sbytes);
        const int k0 = kt * ws::KT;
#pragma unroll
        for (int h = 0; h < 4; ++h)      // re 0-63, im 0-63, re 64-127, im 64-127
          tma_load_2d(st + h * ws::OP_BOX, h & 1 ? &im_map : &re_map, &full[s],
                      col0 + (h >> 1) * 64, k0);
        tma_load_3d(st + ws::OP_BYTES, &in_map, &full[s], k0, b0, row0);
        if constexpr (ws::raw<In>()) {
          uint8_t* pi_s = st + ws::OP_BYTES + ws::in_bytes<In>();
          tma_load_2d(pi_s, &pi_map, &full[s], k0, row0);
          tma_load_2d(pi_s + R * ws::KT * 4, &inv_map, &full[s], k0, row0);
        }
        if (++s == nst) s = 0, ph ^= 1;
        if (++kt == nk) kt = 0, b0 += 1 << fs;
      }
    }
    return;
  }

  if (wg == 2) {
    // the forming warpgroup: stage it's A tile into A tile it % A_TILES,
    // once the wgmmas that read that tile last are done; it releases the
    // stage's slot (its rows read) and announces the tile
    setmaxnreg_dec<ws::FORMER_REGS>();
    const int t = tid & 127;
    for (int it = 0, s = 0, ph = 0, kt = 0, b0 = 0, ai = 0, aph = 0; it < total; ++it) {
      const uint8_t* st = smem + s * sbytes;
      mbar_wait(&full[s], ph);
      uint32_t a[4][4];
      if (B - b0 < (1 << fs))          // the group's last chunk, short of eight frames
        ws_form_a<In, true>(a, st, t, B - b0);
      else
        ws_form_a<In, false>(a, st, t, B - b0);
      if (it >= ws::A_TILES) mbar_wait(&a_empty[ai], aph ^ 1);
      ws_store_a(a_tiles + ai * ws::A_BYTES, a, t);
      fence_proxy_async();             // the stores, before the consumers' wgmmas read them
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&a_full[ai]);
        mbar_arrive(&empty[s]);
      }
      if (++s == nst) s = 0, ph ^= 1;
      if (++kt == nk) kt = 0, b0 += 1 << fs;
      if (++ai == ws::A_TILES) ai = 0, aph ^= 1;
    }
    return;
  }

  // the consumers: warpgroup wg multiplies the block's 64 pairs by depths
  // 64 wg .. 64 wg + 63
  setmaxnreg_inc<ws::CONSUMER_REGS>();
  const int warp = tid >> 5, g = lane >> 2, tq = lane & 3;
  const int m0 = (warp & 3) * 16 + g;                      // this lane's pairs: m0, m0 + 8
  const int frame = tc::pair_frame(m0, fs);                // the same for m0 + 8
  float acc[64], part[64];   // the running sums and a round's fragment: re 0-31, im 32-63
  float mag[MULTI ? 32 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (MULTI ? 32 : 1); ++i) mag[i] = 0.f;
  const uint32_t b_mine = 2 * wg * ws::OP_BOX;             // its B: boxes re, im of its depths
  for (int it = 0, s = 0, ph = 0, kt = 0, b0 = 0, ai = 0, aph = 0; it < total; ++it) {
    mbar_wait(&full[s], ph);           // B has landed
    mbar_wait(&a_full[ai], aph);       // A is formed
    const bool fresh = kt % ws::ROUND_STAGES == 0;        // a round's first stage
    if (fresh && kt > 0) {             // the round before ends: its wgmmas ran meanwhile
      wgmma_wait<0>();
      wgmma_hold(part);
      ws_add_fragment(acc, part);
    }
    const uint32_t a_addr = smem_addr(a_tiles + ai * ws::A_BYTES);
    const uint32_t b_addr = smem_addr(smem + s * sbytes) + b_mine;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)     // a round's first k16 step starts its fragment at zero
      wgmma_m64n128k16_ss(part, wgmma_desc_k_sw128(a_addr + kk * 32),
                          wgmma_desc_mn_sw128(b_addr + kk * 16 * 128, ws::OP_BOX, 1024),
                          !fresh || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();                   // the stage before is done: release its slot and A tile
    if (it > 0) {
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty[s == 0 ? nst - 1 : s - 1]);
        mbar_arrive(&a_empty[ai == 0 ? ws::A_TILES - 1 : ai - 1]);
      }
    }
    if (kt == nk - 1) {                // the last stage of a chunk of frames ends its last round
      wgmma_wait<0>();
      wgmma_hold(part);
      ws_add_fragment(acc, part);
      if constexpr (MULTI) {
        ws_add_magnitudes(mag, acc);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      }
    }
    if (++s == nst) s = 0, ph ^= 1;
    if (++kt == nk) kt = 0, b0 += 1 << fs;
    if (++ai == ws::A_TILES) ai = 0, aph ^= 1;
  }
  if constexpr (MULTI) {
    ws_store_sums<8>(mag, out, m0, frame, fs, row0, col0 + 64 * wg, rows, ndisp, tq);
  } else {                             // one chunk: the magnitudes in place of re
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float v = 0.f;
      tc::add_magnitude(v, acc[i], acc[32 + i]);
      acc[i] = v;
    }
    ws_store_sums<8>(acc, out, m0, frame, fs, row0, col0 + 64 * wg, rows, ndisp, tq);
  }
}

// ---------------------------------------------------------------------------
// The warp-specialised schedule of the three f32-operator instances
// (namespace ws32), 3xTF32 on wgmma:
//
//   fdoct_recon_raw_u8_f32    In = uint8_t   <- fused_recon_raw_accumulate
//   fdoct_recon_raw_u16_f32   In = uint16_t  <- fused_recon_raw_accumulate
//   fdoct_recon_yr_f32_f32    In = float     <- fused_recon_accumulate
//
// (pallas_kernels.py:126-160, 275-308).  The sums of the mma.sync 3xTF32
// form above (tc_mma_stage_tf32x3) in the same order: the same split of each
// operand into TF32 parts (split_tf32), per k8 step lo.hi, hi.lo and hi.hi
// into a per-stage fragment that starts at zero (scale_d = 0 on a stage's
// first wgmma), added to the running sums with __fadd_rn after each stage of
// KT = 32 samples, then tc::add_magnitude and the frame-slot butterfly.
//
// What bounds it.  Three TF32 products, 51.5 GFLOP a flagship group, take
// 0.104 ms at the dense TF32 peak; the compulsory traffic (8-32 MiB of frames
// or ratio, 8 MiB of pi and inv_background, 16 MiB of operator table) 10-17
// us.  A TMA producer warpgroup and two consumer warpgroups (384 threads;
// setmaxnreg 40 and 232 a thread), as in the ws schedule of the bf16
// instances without its forming warpgroup, with these changes:
//   * wgmma takes tf32 operands K-major only (the transposed layouts are for
//     16-bit types), so the operator comes as a table built once per
//     Calibration (ops.kernels.pack_tf32_operator): (hi, lo) x (re, im) x
//     ndisp x n_in f32, each depth's samples contiguous and already split.
//     The producer loads the hi and the lo box of a stage (32 samples x re
//     and im of 64 depths, 128 bytes a row, the 128-byte swizzle) beside the
//     input rows and (raw frames) pi and inv_background;
//   * registers: a stage's sums go into a fragment of their own before the
//     __fadd_rn (the tensor cores truncate), so a thread holds the running
//     sums and the fragment; at m64n256 that would be 256 registers, so a
//     block is 128 (row, frame) pairs x 64 depths and each consumer warpgroup
//     runs wgmma.mma_async.m64n128k8 (re and im of 64 depths side by side):
//     64 running sums, 64 of fragment, 32 of A, 32 more for the magnitudes of
//     a group of more than eight frames;
//   * A from registers: a tf32 wgmma reads 6 KiB of shared memory for 64
//     cycles of tensor work with A in shared memory (twice the bf16 form's
//     bytes per operation), and the A tiles would add their stores, a proxy
//     fence and two barriers a stage; with A in registers the products read
//     only the table.  Each thread forms its own A fragments (its warp's 16
//     pairs at samples t and t + 4 of each k8 step: ratio, then split) after
//     the stage before's wgmmas have been waited for, so no register an
//     in-flight wgmma reads is written (ptxas would serialise the wgmmas),
//     and the other consumer warpgroup's wgmmas keep the tensor cores busy
//     meanwhile.  An f32 ratio stages with the 128-byte swizzle, so that the
//     lanes' scalar loads (8 pairs x 4 samples) fall on distinct banks.
// Measured on an NVIDIA H100 (PERF.md; bench_sessions.py, ws_trace.py):
// 187-198 us of device time a flagship group of u8 or u16 frames, 167 us of
// an f32 ratio (the mma.sync form 347-372 and 319), 1.6-1.9x the bound; A
// tiles in shared memory formed beside the wgmmas took 192-213 us.  A
// consumer warp spends a stage ~960-1,160 cycles forming A (u8, u16; ~660
// for a ratio) and ~670-810 waiting for its wgmmas: forming A sets the time.
// 512 rows x 512 depths make 256 blocks, two waves on 132 SMs.  TMA needs
// the input rows' 16-byte strides (n_in % 16 for u8, % 8 for u16, % 4 for
// f32, which the table's rows need too) and 16-byte aligned bases
// (ws32_applies); every other shape runs the mma.sync template
// launch_tc<In, float> from the same C entry, chosen before the launch
// (ops.kernels.f32_schedule mirrors the rule).

namespace ws32 {
constexpr int BM = 128;             // (row, frame) pairs per block: two consumer warpgroups of 64
constexpr int BN = 64;              // depths per block; N = 128 with re and im
constexpr int KT = 32;              // spectral samples per stage (128 bytes of f32): four k8 steps
constexpr int THREADS = 384;        // warpgroups 0-1 consume (wgmma), warpgroup 2 produces (TMA)
constexpr int PRODUCER_REGS = 40;   // setmaxnreg of the producer warpgroup
constexpr int CONSUMER_REGS = 232;  // and of the consumers: 128 x 40 + 256 x 232 <= 65,536
constexpr int OP_BOX = KT * 2 * BN * 4;       // one part (hi or lo) of the table: re | im rows
constexpr int OP_BYTES = 2 * OP_BOX;          // hi | lo
static_assert(OP_BOX % 1024 == 0, "1,024-byte aligned regions");

template <typename In> __host__ __device__ constexpr int in_bytes() {
  return BM * KT * static_cast<int>(sizeof(In));
}
// One stage: table hi | table lo | input rows | pi [R][KT] f32 |
// inv_background [R][KT] f32 (raw frames only); a multiple of 1,024 bytes.
template <typename In> __host__ __device__ constexpr int stage_bytes(int R) {
  return OP_BYTES + in_bytes<In>() +
         (ws::raw<In>() ? 2 * R * KT * static_cast<int>(sizeof(float)) : 0);
}
}  // namespace ws32

// Samples t + 4q (q = 0..7) of pair m of a landed ws32 stage, as f32:
// ws_samples' arithmetic (a count made exact by ws_count, then (raw - pi) *
// inv; or the f32 ratio).  Count rows are read whole (a u8 row is two
// 16-byte loads, a u16 row four) and the samples picked by byte permutes;
// an f32 ratio's 32-sample rows are staged with the 128-byte swizzle, so
// that the lanes' scalar loads (8 pairs x 4 samples) fall on distinct banks.
template <typename In>
__device__ __forceinline__ void ws32_samples(float (&x)[8], const uint8_t* in, const float* pi_s,
                                             const float* inv_s, int m, int t) {
  constexpr int KT = ws32::KT;
  if constexpr (sizeof(In) == 1) {
    const uint4 a = *reinterpret_cast<const uint4*>(in + m * KT);
    const uint4 b = *reinterpret_cast<const uint4*>(in + m * KT + 16);
    const uint32_t w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};   // samples 4q..4q+3
#pragma unroll
    for (int q = 0; q < 8; ++q) x[q] = ws_count(w[q], 0x7540u + t);
  } else if constexpr (sizeof(In) == 2) {
    const uint32_t half = t & 1 ? 0x7432u : 0x7410u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {   // samples 8v..8v+7
      const uint4 a = *reinterpret_cast<const uint4*>(in + m * KT * 2 + 16 * v);
      x[2 * v] = ws_count(t & 2 ? a.y : a.x, half);
      x[2 * v + 1] = ws_count(t & 2 ? a.w : a.z, half);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      x[q] = *reinterpret_cast<const float*>(in + m * KT * 4 + ((q ^ (m & 7)) << 4) + 4 * t);
  }
  if constexpr (ws::raw<In>()) {
    const int row = tc::pair_row(m, ws::FS) * KT + t;
#pragma unroll
    for (int q = 0; q < 8; ++q) x[q] = __fmul_rn(__fsub_rn(x[q], pi_s[row + 4 * q]), inv_s[row + 4 * q]);
  }
}

// This thread's A fragments of one landed stage, split into TF32 parts: for
// k8 step kk, pairs m0 and m0 + 8 (rows g and g + 8 of its warp's 16) at
// samples 8 kk + t and 8 kk + t + 4, in wgmma_m64n128k8_tf32_rs's order.
// PARTIAL (a chunk of fewer than eight frames): pairs of frames at or past
// ``frames`` are zero, and nothing is read for them (m0 and m0 + 8 are the
// same frame of two rows).
template <typename In, bool PARTIAL>
__device__ __forceinline__ void ws32_form_a(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                            const uint8_t* stage, int m0, int t, int frames) {
  constexpr int R = ws32::BM >> ws::FS;
  const uint8_t* in = stage + ws32::OP_BYTES;
  const float* pi_s = reinterpret_cast<const float*>(in + ws32::in_bytes<In>());
  const float* inv_s = pi_s + R * ws32::KT;
  if (PARTIAL && tc::pair_frame(m0, ws::FS) >= frames) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) hi[kk][i] = lo[kk][i] = 0u;
    return;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x[8];
    ws32_samples<In>(x, in, pi_s, inv_s, m0 + 8 * h, t);
#pragma unroll
    for (int q = 0; q < 8; ++q)        // sample t + 4q = 8 kk + t + 4 j: kk = q / 2, j = q % 2
      split_tf32(x[q], hi[q >> 1][h + 2 * (q & 1)], lo[q >> 1][h + 2 * (q & 1)]);
  }
}

template <typename In, bool MULTI>
__global__ void __launch_bounds__(ws32::THREADS, 1)
fused_recon_ws32_kernel(const __grid_constant__ CUtensorMap in_map,
                        const __grid_constant__ CUtensorMap pi_map,
                        const __grid_constant__ CUtensorMap inv_map,
                        const __grid_constant__ CUtensorMap op_map, float* __restrict__ out,
                        int B, int rows, int n_in, int ndisp, int nst) {
  extern __shared__ uint8_t ws_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(ws_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  constexpr int fs = ws::FS, R = ws32::BM >> fs;
  const int sbytes = ws32::stage_bytes<In>(R);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + nst * sbytes);
  uint64_t* empty = full + ws::MAX_STAGES;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int row0 = blockIdx.y * R, col0 = blockIdx.x * ws32::BN;
  const int nk = (n_in + ws32::KT - 1) / ws32::KT;
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
    // the producer: one thread issues every copy of stage it into slot it %
    // nst once the slot's previous stage has been released
    setmaxnreg_dec<ws32::PRODUCER_REGS>();
    if (tid == 256) {
      for (int it = 0, s = 0, ph = 0, kt = 0, b0 = 0; it < total; ++it) {
        uint8_t* st = smem + s * sbytes;
        if (it >= nst) mbar_wait(&empty[s], ph ^ 1);
        mbar_expect_tx(&full[s], sbytes);
        const int k0 = kt * ws32::KT;
        tma_load_3d(st, &op_map, &full[s], k0, col0, 0);                  // hi: re | im
        tma_load_3d(st + ws32::OP_BOX, &op_map, &full[s], k0, col0, 2);   // lo: re | im
        tma_load_3d(st + ws32::OP_BYTES, &in_map, &full[s], k0, b0, row0);
        if constexpr (ws::raw<In>()) {
          uint8_t* pi_s = st + ws32::OP_BYTES + ws32::in_bytes<In>();
          tma_load_2d(pi_s, &pi_map, &full[s], k0, row0);
          tma_load_2d(pi_s + R * ws32::KT * 4, &inv_map, &full[s], k0, row0);
        }
        if (++s == nst) s = 0, ph ^= 1;
        if (++kt == nk) kt = 0, b0 += 1 << fs;
      }
    }
    return;
  }

  // the consumers: warpgroup wg multiplies pairs 64 wg .. 64 wg + 63
  setmaxnreg_inc<ws32::CONSUMER_REGS>();
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = wg * 64 + (warp & 3) * 16 + g;            // this lane's pairs: m0, m0 + 8
  const int frame = tc::pair_frame(m0, fs);                // the same for m0 + 8
  float acc[64], part[64];   // the running sums and a stage's fragment: re 0-31, im 32-63
  float mag[MULTI ? 32 : 1];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (MULTI ? 32 : 1); ++i) mag[i] = 0.f;
  for (int it = 0, s = 0, ph = 0, kt = 0, b0 = 0; it < total; ++it) {
    const uint8_t* st = smem + s * sbytes;
    mbar_wait(&full[s], ph);
    uint32_t hi[4][4], lo[4][4];
    if (B - b0 < (1 << fs))            // the group's last chunk, short of eight frames
      ws32_form_a<In, true>(hi, lo, st, m0, tq, B - b0);
    else
      ws32_form_a<In, false>(hi, lo, st, m0, tq, B - b0);
    const uint32_t b_hi = smem_addr(st), b_lo = b_hi + ws32::OP_BOX;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // per k8 step lo.hi, hi.lo, hi.hi, as tc_mma_stage_tf32x3
      wgmma_m64n128k8_tf32_rs(part, lo[kk], wgmma_desc_k_sw128(b_hi + 32 * kk), kk > 0);
      wgmma_m64n128k8_tf32_rs(part, hi[kk], wgmma_desc_k_sw128(b_lo + 32 * kk), 1);
      wgmma_m64n128k8_tf32_rs(part, hi[kk], wgmma_desc_k_sw128(b_hi + 32 * kk), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    wgmma_hold(part);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);   // stage it's slot: its A formed, its table read
    ws_add_fragment(acc, part);
    if constexpr (MULTI) {
      if (kt == nk - 1) {              // the last stage of a chunk of frames
        ws_add_magnitudes(mag, acc);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      }
    }
    if (++s == nst) s = 0, ph ^= 1;
    if (++kt == nk) kt = 0, b0 += 1 << fs;
  }
  if constexpr (MULTI) {
    ws_store_sums<8>(mag, out, m0, frame, fs, row0, col0, rows, ndisp, tq);
  } else {                             // one chunk: the magnitudes in place of re
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float v = 0.f;
      tc::add_magnitude(v, acc[i], acc[32 + i]);
      acc[i] = v;
    }
    ws_store_sums<8>(acc, out, m0, frame, fs, row0, col0, rows, ndisp, tq);
  }
}

template <typename In> constexpr CUtensorMapDataType tma_type() {
  return sizeof(In) == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                         : sizeof(In) == 2 ? CU_TENSOR_MAP_DATA_TYPE_UINT16
                                           : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// Whether TMA can address the inputs of the bf16 instance on In (else the
// mma.sync schedule runs): 16-byte row strides of the input rows (n_in % 16
// for u8, % 8 for u16, % 4 for f32) and of the bf16 operator (ndisp % 8),
// and 16-byte aligned bases.
template <typename In>
bool ws_applies(const void* x, const void* pi, const void* inv_bg, const void* op_re,
                const void* op_im, int n_in, int ndisp) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return n_in % (16 / static_cast<int>(sizeof(In))) == 0 && ndisp % 8 == 0 && aligned(x) &&
         aligned(op_re) && aligned(op_im) &&
         (!ws::raw<In>() || (aligned(pi) && aligned(inv_bg)));
}

// The tensor maps of the input rows (maps[0]: pair-major, dims (sample,
// frame, row), box kt x F x R, written with ``swizzle``) and, for raw
// frames, of pi and inv_background (maps[1], maps[2]: box kt x R), at F = 8
// frames in flight.
template <typename In>
bool ws_input_maps(CUtensorMap* maps, const void* x, const void* pi, const void* inv_bg, int B,
                   int rows, int n_in, cuuint32_t kt, cuuint32_t R, CUtensorMapSwizzle swizzle) {
  constexpr int fs = ws::FS;
  const cuuint64_t n = static_cast<cuuint64_t>(n_in), nr = static_cast<cuuint64_t>(rows);
  const cuuint64_t es = sizeof(In);
  const cuuint64_t in_dims[3] = {n, static_cast<cuuint64_t>(B), nr};
  const cuuint64_t in_strides[2] = {nr * n * es, n * es};
  const cuuint32_t in_box[3] = {kt, static_cast<cuuint32_t>(1 << fs), R};
  const cuuint64_t ratio_dims[2] = {n, nr}, ratio_strides[1] = {n * 4};
  const cuuint32_t ratio_box[2] = {kt, R};
  bool ok = tensor_map(&maps[0], tma_type<In>(), 3, x, in_dims, in_strides, in_box, swizzle);
  if (ws::raw<In>())
    ok = ok &&
         tensor_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, pi, ratio_dims, ratio_strides,
                    ratio_box, CU_TENSOR_MAP_SWIZZLE_NONE) &&
         tensor_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, inv_bg, ratio_dims,
                    ratio_strides, ratio_box, CU_TENSOR_MAP_SWIZZLE_NONE);
  return ok;
}

template <typename In>
int launch_ws(const void* x, const void* pi, const void* inv_bg, const void* op_re,
              const void* op_im, void* out, int B, int rows, int n_in, int ndisp, void* stream) {
  constexpr int fs = ws::FS, R = ws::BM >> fs;
  const int gy = (rows + R - 1) / R;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[5] = {};
  const cuuint64_t op_dims[2] = {static_cast<cuuint64_t>(ndisp), static_cast<cuuint64_t>(n_in)};
  const cuuint64_t op_strides[1] = {static_cast<cuuint64_t>(ndisp) * 2};
  const cuuint32_t op_box[2] = {64, ws::KT};
  const bool ok = ws_input_maps<In>(maps, x, pi, inv_bg, B, rows, n_in, ws::KT, R,
                                    CU_TENSOR_MAP_SWIZZLE_NONE) &&
                  tensor_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, op_re, op_dims,
                             op_strides, op_box, CU_TENSOR_MAP_SWIZZLE_128B) &&
                  tensor_map(&maps[4], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, op_im, op_dims,
                             op_strides, op_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int extra = ws::SMEM_EXTRA + 2 * ws::A_TILES * 8 + ws::A_TILES * ws::A_BYTES;
  constexpr int nst = std::min(ws::MAX_STAGES, (ws::SMEM_LIMIT - extra) / ws::stage_bytes<In>(R));
  static_assert(nst >= 2, "a ring of at least two stages");
  const int smem = nst * ws::stage_bytes<In>(R) + extra;
  const auto kernel = B > (1 << fs) ? fused_recon_ws_kernel<In, true>
                                    : fused_recon_ws_kernel<In, false>;
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<dim3((ndisp + ws::BN - 1) / ws::BN, gy), ws::THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1], maps[2], maps[3], maps[4],
                                                static_cast<float*>(out), B, rows, n_in, ndisp,
                                                nst);
  return static_cast<int>(cudaGetLastError());
}

// Every bf16 instance: the warp-specialised schedule where TMA can address
// the inputs, else the mma.sync template; the choice is made from the
// shapes and pointers, before the launch.
template <typename In>
int launch_bf16(const void* x, const void* pi, const void* inv_bg, const void* op_re,
                const void* op_im, void* out, int B, int rows, int n_in, int ndisp,
                void* stream) {
  if (B < 1 || rows < 1 || n_in < 1 || ndisp < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (ws_applies<In>(x, pi, inv_bg, op_re, op_im, n_in, ndisp))
    return launch_ws<In>(x, pi, inv_bg, op_re, op_im, out, B, rows, n_in, ndisp, stream);
  return launch_tc<In, __nv_bfloat16>(x, pi, inv_bg, op_re, op_im, out, B, rows, n_in, ndisp,
                                      stream);
}

// Whether TMA can address the inputs of the f32-operator instance on In
// (else the mma.sync schedule runs): 16-byte row strides of the input rows
// (n_in % 16 for u8, % 8 for u16, % 4 for f32) and of the K-major TF32 table
// (n_in % 4), and 16-byte aligned bases of the rows, the table and (raw
// frames) pi and inv_background.  The table's depths are its rows, so ndisp
// enters no rule.
template <typename In>
bool ws32_applies(const void* x, const void* pi, const void* inv_bg, const void* op_tf32,
                  int n_in) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return n_in % (16 / static_cast<int>(sizeof(In))) == 0 && n_in % 4 == 0 && aligned(x) &&
         aligned(op_tf32) && (!ws::raw<In>() || (aligned(pi) && aligned(inv_bg)));
}

template <typename In>
int launch_ws32(const void* x, const void* pi, const void* inv_bg, const void* op_tf32,
                void* out, int B, int rows, int n_in, int ndisp, void* stream) {
  constexpr int fs = ws::FS, R = ws32::BM >> fs;
  const int gy = (rows + R - 1) / R;
  if (gy > 65535) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[4] = {};
  // the table (hi re, hi im, lo re, lo im) x ndisp x n_in: dims (sample,
  // depth, part), box KT x BN x 2 (re and im of one part)
  const cuuint64_t n = static_cast<cuuint64_t>(n_in), nd = static_cast<cuuint64_t>(ndisp);
  const cuuint64_t op_dims[3] = {n, nd, 4}, op_strides[2] = {n * 4, nd * n * 4};
  const cuuint32_t op_box[3] = {ws32::KT, ws32::BN, 2};
  // an f32 ratio with the 128-byte swizzle (ws32_samples reads it so)
  const bool ok = ws_input_maps<In>(maps, x, pi, inv_bg, B, rows, n_in, ws32::KT, R,
                                    ws::raw<In>() ? CU_TENSOR_MAP_SWIZZLE_NONE
                                                  : CU_TENSOR_MAP_SWIZZLE_128B) &&
                  tensor_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, op_tf32, op_dims,
                             op_strides, op_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int nst = std::min(ws::MAX_STAGES,
                               (ws::SMEM_LIMIT - ws::SMEM_EXTRA) / ws32::stage_bytes<In>(R));
  static_assert(nst >= 2, "a ring of at least two stages");
  const int smem = nst * ws32::stage_bytes<In>(R) + ws::SMEM_EXTRA;
  const auto kernel = B > (1 << fs) ? fused_recon_ws32_kernel<In, true>
                                    : fused_recon_ws32_kernel<In, false>;
  const cudaError_t rc =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<dim3((ndisp + ws32::BN - 1) / ws32::BN, gy), ws32::THREADS, smem,
           static_cast<cudaStream_t>(stream)>>>(maps[0], maps[1], maps[2], maps[3],
                                                static_cast<float*>(out), B, rows, n_in, ndisp,
                                                nst);
  return static_cast<int>(cudaGetLastError());
}

// Every f32-operator instance: the warp-specialised 3xTF32 schedule on the
// table op_tf32 where TMA can address the inputs, else the mma.sync template
// on op_re and op_im; the choice is made from the shapes and pointers, before
// the launch.
template <typename In>
int launch_f32(const void* x, const void* pi, const void* inv_bg, const void* op_re,
               const void* op_im, const void* op_tf32, void* out, int B, int rows, int n_in,
               int ndisp, void* stream) {
  if (B < 1 || rows < 1 || n_in < 1 || ndisp < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (ws32_applies<In>(x, pi, inv_bg, op_tf32, n_in))
    return launch_ws32<In>(x, pi, inv_bg, op_tf32, out, B, rows, n_in, ndisp, stream);
  return launch_tc<In, float>(x, pi, inv_bg, op_re, op_im, out, B, rows, n_in, ndisp, stream);
}

}  // namespace

// Plain C entry points for ctypes.  Every pointer is a contiguous device
// buffer: x (B, rows, n_in) u8, u16 or f32; pi, inv_bg (rows, n_in) f32;
// op_re, op_im (n_in, ndisp); op_tf32 (the f32 entries) (2, 2, ndisp, n_in)
// f32, ops.kernels.pack_tf32_operator of op_re and op_im; out (rows, ndisp)
// f32.  Launches on
// ``stream`` and returns cudaGetLastError() (0 when the launch was
// accepted).
extern "C" {

int fdoct_recon_raw_u8_f32(const void* raw, const void* pi, const void* inv_bg,
                           const void* op_re, const void* op_im, const void* op_tf32,
                           void* out, int B, int rows, int n_in, int ndisp, void* stream) {
  return launch_f32<uint8_t>(raw, pi, inv_bg, op_re, op_im, op_tf32, out, B, rows, n_in, ndisp,
                             stream);
}

int fdoct_recon_raw_u8_bf16(const void* raw, const void* pi, const void* inv_bg,
                            const void* op_re, const void* op_im, void* out,
                            int B, int rows, int n_in, int ndisp, void* stream) {
  return launch_bf16<uint8_t>(raw, pi, inv_bg, op_re, op_im, out, B, rows, n_in, ndisp,
                              stream);
}

int fdoct_recon_raw_u16_f32(const void* raw, const void* pi, const void* inv_bg,
                            const void* op_re, const void* op_im, const void* op_tf32,
                            void* out, int B, int rows, int n_in, int ndisp, void* stream) {
  return launch_f32<uint16_t>(raw, pi, inv_bg, op_re, op_im, op_tf32, out, B, rows, n_in, ndisp,
                              stream);
}

int fdoct_recon_raw_u16_bf16(const void* raw, const void* pi, const void* inv_bg,
                             const void* op_re, const void* op_im, void* out,
                             int B, int rows, int n_in, int ndisp, void* stream) {
  return launch_bf16<uint16_t>(raw, pi, inv_bg, op_re, op_im, out, B, rows, n_in, ndisp,
                               stream);
}

int fdoct_recon_yr_f32_f32(const void* yr, const void* op_re, const void* op_im,
                           const void* op_tf32, void* out, int B, int rows, int n_in, int ndisp,
                           void* stream) {
  return launch_f32<float>(yr, nullptr, nullptr, op_re, op_im, op_tf32, out, B, rows, n_in,
                           ndisp, stream);
}

int fdoct_recon_yr_f32_bf16(const void* yr, const void* op_re, const void* op_im, void* out,
                            int B, int rows, int n_in, int ndisp, void* stream) {
  return launch_bf16<float>(yr, nullptr, nullptr, op_re, op_im, out, B, rows, n_in, ndisp,
                            stream);
}

// The resident kernel's sum (kernel 1 u8 with a bf16 operator; op_re,
// op_im are bf16): the bf16 instances' schedule, as fdoct_recon_raw_u8_bf16.
int fdoct_recon_resident_u8_bf16(const void* raw, const void* pi, const void* inv_bg,
                                 const void* op_re, const void* op_im, void* out,
                                 int B, int rows, int n_in, int ndisp, void* stream) {
  return launch_bf16<uint8_t>(raw, pi, inv_bg, op_re, op_im, out, B, rows, n_in, ndisp, stream);
}

}  // extern "C"
