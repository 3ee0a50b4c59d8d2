// What the tensor-core kernels of fused_recon.cu and int8_bscan.cu share
// (sm_90a): PTX wrappers for 16-byte cp.async staging, ldmatrix fragment
// loads and the three mma.sync shapes (s8, bf16, tf32), and the block
// schedule of namespace tc.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; the bytes past ``src_bytes`` are zero.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 16-byte matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}
// The same, each 8 x 8 matrix of 16-bit values transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += a (16 x 32 s8, row-major) @ b (32 x 8 s8, K-major): exact s32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16 x 16 bf16, row-major) @ b (16 x 8 bf16): exact products, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a (16 x 8 tf32, row-major) @ b (8 x 8 tf32): tf32 operands (f32 bit
// patterns with the low 13 mantissa bits zero), exact products, f32 sums.
// The accumulator fragment has the layout of m16n8k16's.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The block schedule of every tensor-core kernel.  A block of four warps
// (2 along pairs x 2 along depths) sums sum_b |x_b @ (op_re + i op_im)| for
// a tile of BM (row, frame) pairs x BN depths, re and im side by side in N.
// Pair m is frame m & (F - 1) of row m >> fs, with F = 1 << fs frames in
// flight: all F frames of BM / F rows, so every operator tile a block stages
// serves all of them, and a warp's WM pairs hold whole rows.  Groups of more
// than F frames run in chunks of F.  Spectral samples arrive KT at a time
// (KT / 2 with an f32 operator) through a STAGES-deep cp.async ring.
namespace tc {

constexpr int BM = 64;           // (row, frame) pairs per block
constexpr int BN = 64;           // depths per block, for re and for im
constexpr int KT = 64;           // spectral samples per stage
constexpr int STAGES = 3;
constexpr int THREADS = 128;     // 4 warps: 2 along pairs x 2 along depths
constexpr int WM = 32;           // pairs per warp
constexpr int WN = 32;           // depths per warp
constexpr int MAX_F = 8;         // frames in flight: the 8 groupIDs of a quad column
static_assert(BM % (2 * MAX_F) == 0 && WM % MAX_F == 0, "a warp's pairs hold whole rows");

// log2 of the frames in flight for a group of B: min(MAX_F, B rounded up to
// a power of two).
inline int frames_shift(int B) {
  int fs = 0;
  while ((1 << fs) < B && (1 << fs) < MAX_F) ++fs;
  return fs;
}

// The frame and the row (relative to the block's first) of pair m.
__device__ __forceinline__ int pair_frame(int m, int fs) { return m & ((1 << fs) - 1); }
__device__ __forceinline__ int pair_row(int m, int fs) { return m >> fs; }

// Where a thread's accumulators lie.  The mma.sync m16n8 fragments of warp
// (wm, wn) give lane (g, t) = (lane / 4, lane % 4) element (mt, h, j, e):
// pair wm * WM + mt * 16 + h * 8 + g and depth wn * WN + j * 8 + t * 2 + e
// of the block's tile; the re sums are acc[mt][j], the im sums acc[mt][4 + j].
// The F frames of a row sit in the lanes whose g differs in its low fs bits.
struct Frag {
  int lane, wm, wn, g, t, fs;
  __device__ Frag(int tid, int fs_)
      : lane(tid & 31), wm((tid >> 5) >> 1), wn((tid >> 5) & 1), g(lane >> 2), t(lane & 3),
        fs(fs_) {}
  __device__ int slot() const { return pair_frame(g, fs); }   // this thread's frame in a chunk
  __device__ int row(int row0, int mt, int h) const {
    return row0 + pair_row(wm * WM + mt * 16 + h * 8 + g, fs);
  }
  __device__ int depth(int col0, int j, int e) const { return col0 + wn * WN + j * 8 + t * 2 + e; }
};

// Runs the nk stages of one chunk of frames through the ring: load(stage,
// kt) issues the copies of stage kt into its buffer, compute(stage) reads a
// landed one.  Every thread of the block calls it.  Stage buffers are
// stage_bytes apart from smem on.
template <typename T, typename Load, typename Compute>
__device__ __forceinline__ void stage_ring(T* smem, int stage_bytes, int nk, Load&& load,
                                           Compute&& compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(smem + s * stage_bytes, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();                   // stage kt landed; stage kt-1's buffer is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) load(smem + (nxt % STAGES) * stage_bytes, nxt);
    cp_async_commit();
    compute(smem + (kt % STAGES) * stage_bytes);
  }
  cp_async_wait<0>();
  __syncthreads();                     // the next chunk of frames reuses the buffers
}

// mag += |re + i im|, rounded op by op as torch computes it.
__device__ __forceinline__ void add_magnitude(float& mag, float re, float im) {
  mag = __fadd_rn(mag, __fsqrt_rn(__fadd_rn(__fmul_rn(re, re), __fmul_rn(im, im))));
}

// The sum over the F frame slots of each row (lanes 4 * slot apart); every
// slot ends with the row's sum.
__device__ __forceinline__ void sum_frame_slots(float (&mag)[2][2][4][2], int fs) {
  for (int off = 4; off < (4 << fs); off <<= 1) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            mag[mt][h][j][e] += __shfl_xor_sync(0xffffffffu, mag[mt][h][j][e], off);
  }
}

}  // namespace tc

}  // namespace
