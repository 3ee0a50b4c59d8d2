// What the tensor-core kernels of fused_recon.cu, int8_bscan.cu and
// angio_product.cu share (sm_90a): PTX wrappers for 16-byte cp.async
// staging, ldmatrix fragment loads and the three mma.sync shapes (s8, bf16,
// tf32), the 3xTF32 split of an f32 operand, the block schedule
// of namespace tc, Hopper's asynchronous pieces (mbarrier, TMA tensor
// loads, wgmma with A and B from shared memory, named barriers, the
// async-proxy fence, setmaxnreg) that the warp-specialised schedules of the
// bf16, the f32-operator and the int8 instances are built from, and the
// host's encoding of their TMA tensor maps.
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

// The 3xTF32 split of an f32 operand (the f32-operator instances of
// fused_recon.cu and the split-spectrum product of angio_product.cu): x = hi
// + lo + e, |e| <= 2^-21 |x|, hi and lo TF32 (low 13 bits zero): hi rounds x
// to nearest, ties away from zero; lo truncates the exact x - hi
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(x, __uint_as_float(hi))) & 0xffffe000u;
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
// Ties registers to this point of the program, so that the compiler does
// not read an accumulator before the wgmma writing it has been waited for.
template <int N> __device__ __forceinline__ void wgmma_hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void wgmma_hold(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor of a K-major tile written with the
// 128-byte swizzle (by TMA, or by threads storing 16-byte chunk c of row r
// at chunk c ^ (r & 7)): 128 bytes of K per row (64 bf16, 32 tf32 or 128
// s8 elements), 8-row atoms of 1,024 bytes (the stride byte offset); the
// leading byte offset is unused for a swizzled K-major tile.  The tile
// starts on a 1,024-byte boundary; the k step kk of a row (k16 for bf16, k8
// for tf32, k32 for s8: 32 bytes each) starts ``addr + 32 * kk``.
__device__ __forceinline__ uint64_t wgmma_desc_k_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | static_cast<uint64_t>(1024 >> 4) << 32 |
         1ull << 62;
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

// d (+)= A @ B, m64n128k16, bf16 operands, f32 sums, both by descriptor: A
// K-major (wgmma_desc_k_sw128), B MN-major (wgmma_desc_mn_sw128).  Warp w
// of the group holds rows 16w..16w+15 of d: d[4j + e] is row g (e < 2) or g
// + 8 (e >= 2) of the warp's 16, column 8j + 2t + (e & 1), lane (g, t) =
// (lane / 4, lane % 4), the mma.sync m16n8 accumulator layout.  scale_d = 0
// ignores d's old value.  The sums are the tensor cores' (not rounded to
// nearest).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
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
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (+)= A @ B, m64n256k32, s8 operands, s32 sums (exact), both by
// descriptor and both K-major (wgmma_desc_k_sw128: 8-bit types have no
// transposed layout; a k32 step is 32 bytes of a 128-byte row, as a k16
// step of bf16).  d has the layout of wgmma_m64n128k16_ss's: d[4j + e] is
// row g (e < 2) or g + 8 (e >= 2) of the warp's 16, column 8j + 2t + (e &
// 1).  scale_d = 0 ignores d's old value.
__device__ __forceinline__ void wgmma_m64n256k32_s8_ss(int (&d)[128], uint64_t desc_a,
                                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
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
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]), "+r"(d[66]),
        "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]), "+r"(d[72]),
        "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]),
        "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]), "+r"(d[90]),
        "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]), "+r"(d[96]),
        "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]),
        "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]),
        "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]), "+r"(d[120]),
        "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]),
        "+r"(d[127])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (+)= A @ B, m64n128k8, tf32 operands, f32 sums: A from registers, B by
// descriptor, K-major (wgmma_desc_k_sw128: wgmma takes the transposed,
// MN-major, layouts for 16-bit types only).  Lane (g, t) = (lane / 4,
// lane % 4) of warp w of the group gives a = A's rows 16w + g and 16w + g +
// 8 at columns t and t + 4, in the order (g, t), (g + 8, t), (g, t + 4),
// (g + 8, t + 4) (the mma.sync m16n8k8 tf32 A fragment).  Operands are f32
// bit patterns of which the tensor cores read the TF32 part (the low 13
// mantissa bits are ignored).  d has the layout of wgmma_m64n128k16_ss's:
// d[4j + e] is row g (e < 2) or g + 8 (e >= 2) of the warp's 16, column 8j +
// 2t + (e & 1).  scale_d = 0 ignores d's old value; the sums are the tensor
// cores' (not rounded to nearest).  a must not change until the
// wgmma has been waited for.
__device__ __forceinline__ void wgmma_m64n128k8_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                                        uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
        "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// ---------------------------------------------------------------------------
// Warp specialisation: named barriers over part of a block, the fence that
// makes generic-proxy shared-memory stores visible to wgmma (the async
// proxy), and setmaxnreg, which moves registers between warpgroups (every
// warp of the warpgroup executes it; the count is a multiple of 8 in
// [24, 256]).

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// TMA tensor maps, encoded on the host.  cuTensorMapEncodeTiled is obtained
// at run time through the CUDA runtime's cudaGetDriverEntryPoint, so that
// the library does not link libcuda.
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
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
inline bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
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

}  // namespace
