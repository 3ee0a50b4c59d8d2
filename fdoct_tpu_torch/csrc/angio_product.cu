// The split-spectrum product of an OCT-angiography volume and its
// magnitudes, for NVIDIA Hopper (sm_90a):
//
//   mags[r, c] = | yr[r, :] @ (op_re + i*op_im)[:, c] |
//
// yr is the (rows, n_in) f32 ratio stack of a volume (every frame's rows one
// after another), op = [M | M_1 .. M_B] the split-spectrum operator of
// fdoct_tpu_torch/angio.py, (1 + B) * ndisp columns.  It replaces no TPU
// kernel: the JAX package leaves this product to XLA, and the port ran it as
// two cuBLAS f32 SGEMMs (re and im, 8.2 GB written at the OCTA-500 shape)
// followed by passes that formed the magnitudes from them.  It is the
// 'highest' route of angio.ratio_ssada (ops.kernels.split_spectrum_mags), and
// keeps that route float32-grade: 3xTF32 on the tensor cores, the sums of
// each stage of KT samples taken in a fragment of their own and added to the
// running sums in round-to-nearest f32, as the f32-operator instances of
// fused_recon.cu take them (see the 3xTF32 note there: the tensor cores
// truncate their f32 sums).
//
// What bounds it.  At the OCTA-500 shape (320,000 rows = 800 frames x 400
// A-lines, n_in 2048, 3,200 columns) the three TF32 products are 12.6 T
// multiply-adds, 50.8 ms at the dense TF32 peak (495 TFLOP/s); the
// compulsory traffic (2.6 GB of ratio, the 105 MB K-major TF32 table, 4.1 GB
// of magnitudes) 2.0 ms at 3.35 TB/s.  Compute-bound, as long as the tiles'
// reads stay in the 50 MB L2 and within what an SM takes in.
//
// The design differs from the group kernels' (fused_recon_ws32_kernel) where
// their shapes differ:
//   * rows are rows: no (row, frame) pairs and no sum over frames, so every
//     one of a tile's 128 rows is live (the group kernel at B = 1 runs one
//     live frame in eight frame slots) and the epilogue stores each
//     magnitude once;
//   * 3,200 columns: the table (hi, lo) x (re, im) x columns x n_in is 105
//     MB, twice the L2.  A tile is 128 rows x 64 columns, so each table
//     slice a stage brings serves 128 rows; the blocks are persistent, one an
//     SM, and walk the tiles in groups of GROUP row tiles, column-tile-major
//     inside a group: the ~132 tiles in flight share ~9 table slices of 2 MB
//     (each read from device memory once a group, 16.5 GB a volume) and
//     GROUP MB of ratio rows (read from device memory once);
//   * the ring runs on from one tile to the next, so a tile's epilogue (the
//     magnitudes of its 8,192 outputs, stored from registers) overlaps the
//     loads of the next tile's first stages.
// Per stage (KT = 32 samples): the producer warpgroup's one thread brings
// the hi and the lo box of the table (32 samples x re and im of 64 columns,
// 16 KiB each) and the tile's 128 ratio rows (16 KiB, 128-byte swizzle) by
// TMA; each of two consumer warpgroups loads its 64 rows' A fragments with
// one ldmatrix.x4 a k8 step (an 8 x 8 b16 matrix is 8 rows x 4 f32
// samples, lane (g, t) receiving row g, sample t: the tf32 fragment), splits
// them into TF32 parts in registers (wgmma's A from registers) and issues,
// per k8 step, wgmma m64n128k8 tf32 lo.hi, hi.lo, hi.hi (re and im of 64
// columns side by side in N = 128) into a fragment that starts at zero at
// the stage's first wgmma, then adds it to its 64 running sums with
// __fadd_rn.  The same sums, in the same order, as fused_recon_accumulate's
// f32 instances at B = 1 (both of its schedules), bit for bit; the
// magnitudes are tc::add_magnitude's.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6): 68-69
// ms at the OCTA-500 shape, 1.35x the bound, against cuBLAS's 164 ms for the
// two f32 products alone.  The group kernel's A loads (16 scalar ld.shared a
// stage a thread) took 75-76 ms, with A made in registers instead (wrong
// results) 65 ms.  With no TMA traffic at all (wrong results) this kernel
// takes 61 ms: the consumers' work between their wgmmas sets most of the
// time.  Loads alone (each stage released as it lands) took 90 ms, longer
// than the whole kernel, so they give no floor.  The order of the tiles
// moved nothing (GROUP 4, 8, 16, 32: 76-78 ms with the scalar A loads).
//
// TMA needs 16-byte row strides (n_in % 4) and 16-byte aligned bases of the
// ratio and the table; elsewhere the entry runs fdoct_recon_yr_f32_f32 at
// B = 1, whose rule (ws32_applies) then fails too: the mma.sync template of
// fused_recon.cu, the same sums bit for bit (ops.kernels.f32_schedule
// mirrors the rule).  Rows past ``rows``, samples past n_in and columns past
// ``ncols`` arrive as TMA's zeros and are not stored.

#include <algorithm>
#include <cstddef>
#include <cstdint>

#include <cuda_runtime.h>

#include "hopper_mma.cuh"

extern "C" int fdoct_recon_yr_f32_f32(const void* yr, const void* op_re, const void* op_im,
                                      const void* op_tf32, void* out, int B, int rows, int n_in,
                                      int ndisp, void* stream);

namespace {

namespace ssm {
constexpr int BM = 128;             // rows of a tile: two consumer warpgroups of 64
constexpr int BN = 64;              // columns of a tile; N = 128 with re and im
constexpr int KT = 32;              // samples a stage (128 bytes of f32): four k8 steps
constexpr int GROUP = 16;           // row tiles a group of the tile order walks together
constexpr int THREADS = 384;        // warpgroups 0-1 consume (wgmma), warpgroup 2 produces (TMA)
constexpr int PRODUCER_REGS = 40;   // setmaxnreg of the producer warpgroup
constexpr int CONSUMER_REGS = 232;  // and of the consumers: 128 x 40 + 256 x 232 <= 65,536
constexpr int STAGES = 4;
constexpr int OP_BOX = KT * 2 * BN * 4;       // one part (hi or lo) of the table: re | im rows
constexpr int A_BYTES = BM * KT * 4;          // the tile's ratio rows of a stage
constexpr int STAGE_BYTES = 2 * OP_BOX + A_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES + 1024 + 2 * STAGES * 8;   // + alignment, barriers
static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * 256 <= 65536, "the register file");
static_assert(OP_BOX % 1024 == 0 && A_BYTES % 1024 == 0, "1,024-byte aligned regions");
static_assert(SMEM <= 232448, "the shared memory a block may take");
}  // namespace ssm

// The first row and column of tile ``tile`` of the walk: groups of GROUP
// row tiles (the last group may have fewer), column-tile-major inside a
// group.
__device__ __forceinline__ void ssm_tile(int tile, int nrt, int nct, int& row0, int& col0) {
  const int per_group = ssm::GROUP * nct;
  const int group = tile / per_group, idx = tile - group * per_group;
  const int first = group * ssm::GROUP;
  const int in_group = min(ssm::GROUP, nrt - first);
  row0 = (first + idx % in_group) * ssm::BM;
  col0 = (idx / in_group) * ssm::BN;
}

__global__ void __launch_bounds__(ssm::THREADS, 1)
split_spectrum_mags_kernel(const __grid_constant__ CUtensorMap yr_map,
                           const __grid_constant__ CUtensorMap op_map, float* __restrict__ mags,
                           int rows, int n_in, int ncols) {
  extern __shared__ uint8_t ssm_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(ssm_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + ssm::STAGES * ssm::STAGE_BYTES);
  uint64_t* empty = full + ssm::STAGES;

  const int tid = threadIdx.x, wg = tid >> 7;
  const int nk = (n_in + ssm::KT - 1) / ssm::KT;
  const int nrt = (rows + ssm::BM - 1) / ssm::BM, nct = (ncols + ssm::BN - 1) / ssm::BN;
  const int tiles = nrt * nct;

  if (tid == 0) {
    for (int s = 0; s < ssm::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);       // the eight consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // the producer: one thread issues every copy of the block's stages, the
    // ring running on across its tiles
    setmaxnreg_dec<ssm::PRODUCER_REGS>();
    if (tid == 256) {
      int s = 0, ph = 0, it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int row0, col0;
        ssm_tile(tile, nrt, nct, row0, col0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          uint8_t* st = smem + s * ssm::STAGE_BYTES;
          if (it >= ssm::STAGES) mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], ssm::STAGE_BYTES);
          const int k0 = kt * ssm::KT;
          tma_load_3d(st, &op_map, &full[s], k0, col0, 0);                 // hi: re | im
          tma_load_3d(st + ssm::OP_BOX, &op_map, &full[s], k0, col0, 2);   // lo: re | im
          tma_load_2d(st + 2 * ssm::OP_BOX, &yr_map, &full[s], k0, row0);
          if (++s == ssm::STAGES) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg multiplies rows 64 wg .. 64 wg + 63 of each tile
  setmaxnreg_inc<ssm::CONSUMER_REGS>();
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int m0 = wg * 64 + (warp & 3) * 16 + g;            // this lane's rows: m0, m0 + 8
  // the row and chunk whose address this lane gives ldmatrix: row a_r (+ 8
  // for matrices 1 and 3) of its warp's 16, chunk 2 kk + a_q
  const int a_r = lane & 7, a_q = lane >> 4;
  const uint32_t a_lane =
      2 * ssm::OP_BOX + (m0 - g + a_r + 8 * ((lane >> 3) & 1)) * 128;
  float acc[64], part[64];     // the running sums and a stage's fragment: re 0-31, im 32-63
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  int s = 0, ph = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int row0, col0;
    ssm_tile(tile, nrt, nct, row0, col0);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const uint8_t* st = smem + s * ssm::STAGE_BYTES;
      mbar_wait(&full[s], ph);
      // A, one ldmatrix.x4 a k8 step kk: the 16-byte chunks of the ratio
      // rows (128 bytes each, 16-byte chunk c of row m at c ^ (m & 7)) hold
      // 4 samples, so an 8 x 8 b16 matrix is 8 rows x 4 samples and lane
      // (g, t) receives its row g, sample t: matrix i is rows + 8 (i & 1),
      // samples 8 kk + 4 (i >> 1) .., which is wgmma_m64n128k8_tf32_rs's
      // register i; then split into TF32 parts
      uint32_t hi[4][4], lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t x[4];
        ldmatrix_x4(x, smem_addr(st) + a_lane + (((2 * kk + a_q) ^ a_r) << 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(x[i]), hi[kk][i], lo[kk][i]);
      }
      const uint32_t b_hi = smem_addr(st), b_lo = b_hi + ssm::OP_BOX;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {   // per k8 step lo.hi, hi.lo, hi.hi
        wgmma_m64n128k8_tf32_rs(part, lo[kk], wgmma_desc_k_sw128(b_hi + 32 * kk), kk > 0);
        wgmma_m64n128k8_tf32_rs(part, hi[kk], wgmma_desc_k_sw128(b_lo + 32 * kk), 1);
        wgmma_m64n128k8_tf32_rs(part, hi[kk], wgmma_desc_k_sw128(b_hi + 32 * kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      wgmma_hold(part);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);   // the stage's slot: its A read, its table used
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
      if (++s == ssm::STAGES) s = 0, ph ^= 1;
    }
    // the epilogue: acc[4j + 2h + e] (re) and acc[32 + 4j + 2h + e] (im) are
    // row m0 + 8h, column 8j + 2 tq + e of the tile
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + m0 + 8 * h;
      if (r >= rows) continue;
      float* out = mags + static_cast<size_t>(r) * ncols;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col0 + 8 * j + 2 * tq;
        float v[2] = {0.f, 0.f};
#pragma unroll
        for (int e = 0; e < 2; ++e)
          tc::add_magnitude(v[e], acc[4 * j + 2 * h + e], acc[32 + 4 * j + 2 * h + e]);
        if (c + 1 < ncols && ncols % 2 == 0) {
          *reinterpret_cast<float2*>(out + c) = make_float2(v[0], v[1]);
        } else {
          if (c < ncols) out[c] = v[0];
          if (c + 1 < ncols) out[c + 1] = v[1];
        }
      }
    }
  }
}

// Whether TMA can address the inputs (else the mma.sync template runs): a
// 16-byte row stride of the ratio and of the K-major table (n_in % 4) and
// 16-byte aligned bases of both; as ws32_applies of fused_recon.cu for an f32
// ratio.
bool ssm_applies(const void* yr, const void* op_tf32, int n_in) {
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return n_in % 4 == 0 && aligned(yr) && aligned(op_tf32);
}

int launch_ssm(const void* yr, const void* op_tf32, void* mags, int rows, int n_in, int ncols,
               void* stream) {
  CUtensorMap maps[2] = {};
  const cuuint64_t n = static_cast<cuuint64_t>(n_in), nc = static_cast<cuuint64_t>(ncols);
  // the ratio rows: dims (sample, row), box KT x BM, the 128-byte swizzle
  const cuuint64_t yr_dims[2] = {n, static_cast<cuuint64_t>(rows)}, yr_strides[1] = {n * 4};
  const cuuint32_t yr_box[2] = {ssm::KT, ssm::BM};
  // the table (hi re, hi im, lo re, lo im) x ncols x n_in: dims (sample,
  // column, part), box KT x BN x 2 (re and im of one part)
  const cuuint64_t op_dims[3] = {n, nc, 4}, op_strides[2] = {n * 4, nc * n * 4};
  const cuuint32_t op_box[3] = {ssm::KT, ssm::BN, 2};
  const bool ok = tensor_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, yr, yr_dims,
                             yr_strides, yr_box, CU_TENSOR_MAP_SWIZZLE_128B) &&
                  tensor_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, op_tf32, op_dims,
                             op_strides, op_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(split_spectrum_mags_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, ssm::SMEM);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long tiles = static_cast<long long>((rows + ssm::BM - 1) / ssm::BM) *
                          ((ncols + ssm::BN - 1) / ssm::BN);
  const int grid = static_cast<int>(std::min<long long>(tiles, sms));
  split_spectrum_mags_kernel<<<grid, ssm::THREADS, ssm::SMEM,
                               static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], static_cast<float*>(mags), rows, n_in, ncols);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes.  Every pointer is a contiguous device
// buffer: yr (rows, n_in) f32; op_re, op_im (n_in, ncols) f32; op_tf32 (2,
// 2, ncols, n_in) f32, ops.kernels.pack_tf32_operator of op_re and op_im;
// mags (rows, ncols) f32.  Launches on ``stream`` and returns
// cudaGetLastError() (0 when the launch was accepted).
extern "C" {

int fdoct_split_spectrum_mags_f32(const void* yr, const void* op_re, const void* op_im,
                                  const void* op_tf32, void* mags, int rows, int n_in, int ncols,
                                  void* stream) {
  if (rows < 1 || n_in < 1 || ncols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long tiles = static_cast<long long>((rows + ssm::BM - 1) / ssm::BM) *
                          ((ncols + ssm::BN - 1) / ssm::BN);
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (ssm_applies(yr, op_tf32, n_in))
    return launch_ssm(yr, op_tf32, mags, rows, n_in, ncols, stream);
  return fdoct_recon_yr_f32_f32(yr, op_re, op_im, op_tf32, mags, 1, rows, n_in, ncols, stream);
}

}  // extern "C"
