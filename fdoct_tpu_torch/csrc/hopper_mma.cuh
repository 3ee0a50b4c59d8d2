// What the tensor-core kernels of fused_recon.cu and int8_bscan.cu share
// (sm_90a): PTX wrappers for 16-byte cp.async staging, ldmatrix fragment
// loads and the three mma.sync shapes (s8, bf16, tf32), the block schedule
// of namespace tc, and Hopper's asynchronous pieces (mbarrier, TMA tensor
// loads, wgmma with A from registers) that the
// resident kernel's schedule is built from.
#pragma once

#include <cstdint>

#include <cuda.h>            // CUtensorMap (the type only; libcuda is not linked)
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

// ---------------------------------------------------------------------------
// mbarriers.  A wait that has not completed after ~10^10 cycles (~6 s) traps:
// a fault in a barrier protocol then ends the kernel with an error instead of
// hanging the card.

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// Makes the initialised barriers visible to TMA (the async proxy).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also announces ``bytes`` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Until the phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - t0 > 10000000000LL) __trap();
}

// ---------------------------------------------------------------------------
// TMA tensor loads (cp.async.bulk.tensor): one box of the tensor ``map``
// (a __grid_constant__ kernel parameter) at the coordinates, innermost
// first, into shared ``dst``; the bytes complete on ``bar``.  Elements
// outside the tensor arrive as zero.

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma: a warpgroup (four consecutive warps) multiplies a 64-row A by B.

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Ties registers to this point of the program, so that the compiler neither
// reads an accumulator before the wgmma writing it has been waited for nor
// reuses an A register that a wgmma in flight still reads.
template <int N> __device__ __forceinline__ void wgmma_hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void wgmma_hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor of an MN-major (transposed) bf16 B tile
// that TMA wrote with a 128-byte swizzle: 64 MN elements (128 bytes) per
// row, rows along K, 8-row swizzle atoms of 1,024 bytes.  lbo: bytes from
// one 64-element atom to the next along MN; sbo: bytes from 8 K rows to the
// next 8.  The tile must start on a 1,024-byte boundary (base offset 0).
__device__ __forceinline__ uint64_t wgmma_desc_mn_sw128(uint32_t addr, uint32_t lbo,
                                                        uint32_t sbo) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

// d (+)= a @ B, m64n256k16, bf16 operands, f32 sums; A from registers in the
// mma.sync m16n8k16 layout per warp (warp w of the group holds rows
// 16w..16w+15), B by descriptor, MN-major.  d[4j + e]: row g (e < 2) or
// g + 8 (e >= 2) of the warp's 16, column 8j + 2t + (e & 1).  scale_d = 0
// ignores d's old value.  The sums are the tensor cores' (not rounded to
// nearest).
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4],
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]),
        "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
        "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]),
        "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

}  // namespace
