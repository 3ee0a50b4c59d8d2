// The C-scan volume's product and its magnitudes, for NVIDIA Hopper (sm_90a):
//
//   mags[f, d, r] = | ((raw[f, r, :] - pi[r, :]) * inv_bg[r, :]) @ (op_re + i*op_im)[:, d] |
//
// raw is a (F, rows, n_in) volume of u8 or u16 camera frames, pi and inv_bg
// the (rows, n_in) f32 terms of the apodization ratio (y - pi) / S(k),
// op_re and op_im the bf16 operator (n_in, ndisp); the magnitudes are
// stored depth-major, (F, ndisp, rows), the layout the volume is returned in.
// It replaces no TPU kernel: the JAX package leaves the volume's product to
// XLA, and the port ran it at 'default' as the f32 ratio stack rounded to
// bf16 and back to f32, two cuBLAS f32 SGEMMs (re and im) and passes for the
// magnitudes and the transposing copy (parallel/sharded.py).  It is the
// 'default' route of sharded_cscan_volume on one card
// (ops.kernels.cscan_volume_mags) and computes what that chain computes: the
// ratio formed op by op as torch forms it, (raw - pi) * inv_bg in f32, then
// rounded to nearest bf16; exact bf16 products with f32 sums, each round of
// ROUND_STAGES stages in a fragment of its own that is added to the running
// sums with __fadd_rn, as the bf16 instances of fused_recon.cu round them
// (see the rounding note there: the tensor cores truncate their sums).  The
// sums of one frame are kernel 1's (fdoct_recon_raw_{u8,u16}_bf16) at B = 1,
// bit for bit, in both of its schedules.
//
// What bounds it.  At the flagship volume (512 frames of 512 rows x 2048
// samples, 512 depths) the products are 2 x 512 x 512 x 2048 x 512 = 550 G
// multiply-adds, 1.112 ms at the dense bf16 peak (989 TFLOP/s); the
// compulsory traffic (0.54 GB of u8 frames in, 0.54 GB of f32 magnitudes
// out) 0.32 ms at 3.35 TB/s.  Compute-bound, if the tiles' bytes reach the
// SMs fast enough: the L2 -> SM traffic per multiply-add, not device
// memory, is what the tile shape has to keep low.
//
// The design: rows as rows, as split_spectrum_mags of angio_product.cu
// takes them, with kernel 1's bf16 roles.
//   * No sum over frames: every (frame, row) pair of the volume is a row of
//     the product (M = F x rows), each magnitude is stored once, from the
//     epilogue, and no f32 ratio, bf16 copy, re or im reaches device memory.
//   * A tile is 128 pairs x 64 depths: 16 frames x 8 rows, pair m = frame *
//     8 + row.  The frames come by one TMA box (64 samples x 8 rows x 16
//     frames) in their own order, and the stage's 8 rows of pi and inv_bg
//     serve all 16 frames: 4 KiB of terms a stage beside 8 KiB of u8
//     frames.  With 128 consecutive rows of one frame (the order of the
//     volume's memory) the terms would be 64 KiB a stage and set the
//     L2 -> SM traffic.  Consumer warpgroup w multiplies frames 8w .. 8w + 7
//     by the tile's 64 depths (re and im make wgmma m64n128k16's N), so both
//     read the same 16 KiB of operator a stage: 28 KiB a stage for 1 M
//     multiply-adds, 0.027 bytes each, where kernel 1's 64-pair x 128-depth
//     block takes 40 KiB.
//   * A forming warpgroup (kernel 1's) makes each stage's bf16 A tile, 128
//     pairs x 64 samples, K-major with the 128-byte swizzle, into a ring of
//     A_TILES tiles; thread t forms samples 8 (t & 7) .. + 7 of eight frames
//     of one row, so it reads that row's pi and inv_bg once.  The counts
//     become f32 by a byte permute and an add (raw_counts of hopper_mma.cuh).
//   * Persistent blocks, one an SM, walk the tiles depth-tile-major, so the
//     8 depth tiles of a pair tile run side by side and its frames are read
//     from device memory once; the ring runs on from one tile to the next,
//     so a tile's epilogue overlaps the next tile's loads and forming.  The
//     operator (4 MiB) and pi and inv_bg (8 MiB) stay in the 50 MB L2.
//   * The epilogue stores the magnitudes depth-major, mags[f, d, r]: the
//     eight lanes of a quad column hold eight consecutive rows of one
//     (frame, depth), so each store instruction writes four whole 32-byte
//     sectors, and the transposing copy that followed the product is gone.
// Registers (setmaxnreg): the producer warpgroup 40 a thread, the forming
// one 104, the consumers 184 (64 running sums and a round's fragment of 64);
// 128 x (40 + 104) + 256 x 184 = 65,536.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 21,
// PERF.md section 6): 3.67-3.82 ms at the flagship volume, 3.3x the bound
// (3.67 ms traced in the benchmark's cell), against 22.1 ms for cuBLAS's f32
// pair alone and 32.3-32.6 ms for the chain it replaces (the f32 ratio, its
// bf16 round trip, the pair, the magnitudes, the transposing copy), whose
// peak of device memory above the frames was 6.0 GiB against 0.5 GiB here;
// 0.070 of BF16_F64_TOL against the float64 product of its rounded
// operands.  The magnitudes are stored depth-major from the epilogue: the
// transposing copy it spares took 2.7 ms a flagship volume.  ptxas: 128
// registers at launch (setmaxnreg moves them), no spills.
//
// TMA needs 16-byte row strides (n_in % 16 for u8, % 8 for u16; ndisp % 8
// for the operator) and 16-byte aligned bases of the frames, pi, inv_bg
// and the operator (tma_applies of hopper_mma.cuh, kernel 1's rule; mirrored
// by ops.kernels.bf16_schedule).  Elsewhere the entry runs kernel 1's bf16
// entry once a frame at B = 1 into the caller's (rows, ndisp) scratch, whose
// rule then fails too (the mma.sync template of fused_recon.cu), and
// transposes each frame into place: the same sums bit for bit.  Frames past
// F, rows past ``rows``, samples past n_in and depths past ndisp arrive as
// TMA's zeros and are not stored.

#include <algorithm>
#include <climits>
#include <cstddef>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper_mma.cuh"

extern "C" int fdoct_recon_raw_u8_bf16(const void* raw, const void* pi, const void* inv_bg,
                                       const void* op_re, const void* op_im, void* out, int B,
                                       int rows, int n_in, int ndisp, void* stream);
extern "C" int fdoct_recon_raw_u16_bf16(const void* raw, const void* pi, const void* inv_bg,
                                        const void* op_re, const void* op_im, void* out, int B,
                                        int rows, int n_in, int ndisp, void* stream);

namespace {

namespace cv {
constexpr int RT = 8;               // rows of a tile
constexpr int FT = 16;              // frames of a tile; pair m = frame * RT + row
constexpr int BM = RT * FT;         // 128 pairs: two consumer warpgroups of 64 (8 frames each)
constexpr int BN = 64;              // depths of a tile; re and im make the wgmma's N = 128
constexpr int KT = 64;              // samples a stage: four k16 steps
constexpr int ROUND_STAGES = 2;     // as ws::ROUND_STAGES of fused_recon.cu: kernel 1's sums
constexpr int MAX_STAGES = 6;
constexpr int THREADS = 512;        // warpgroups 0-1 consume (wgmma), 2 forms A, 3 produces (TMA)
constexpr int PRODUCER_REGS = 40;   // setmaxnreg of the producer warpgroup,
constexpr int FORMER_REGS = 104;    // of the one that forms A
constexpr int CONSUMER_REGS = 184;  // and of the consumers: 128 x (40 + 104) + 256 x 184 <= 65,536
constexpr int OP_BOX = KT * BN * 2;           // one 64-sample x 64-depth bf16 box
constexpr int OP_BYTES = 2 * OP_BOX;          // re | im
constexpr int A_BYTES = BM * KT * 2;          // the bf16 A tile of a stage, 128 pairs x KT
constexpr int A_TILES = 3;                    // a ring of A tiles
constexpr int TERMS_BYTES = RT * KT * 4;      // the stage's rows of pi (or of inv_bg), f32
constexpr int SMEM_LIMIT = 232448;            // shared memory a block may take
constexpr int SMEM_EXTRA = 1024 + (2 * MAX_STAGES + 2 * A_TILES) * 8;  // alignment, barriers
static_assert((PRODUCER_REGS + FORMER_REGS) * 128 + CONSUMER_REGS * 256 <= 65536,
              "the register file");
static_assert(OP_BOX % 1024 == 0 && A_BYTES % 1024 == 0 && TERMS_BYTES % 1024 == 0,
              "1,024-byte aligned regions");

// The frames of a stage, [frame][row][KT] In.
template <typename In> __host__ __device__ constexpr int in_bytes() {
  return BM * KT * static_cast<int>(sizeof(In));
}
// One stage: operator (re | im) | frames | pi [RT][KT] f32 | inv_bg [RT][KT] f32.
template <typename In> __host__ __device__ constexpr int stage_bytes() {
  return OP_BYTES + in_bytes<In>() + 2 * TERMS_BYTES;
}
// The ring's stages: as many as fit beside the A tiles (u8 6, u16 4).
template <typename In> __host__ __device__ constexpr int stages() {
  return (SMEM_LIMIT - SMEM_EXTRA - A_TILES * A_BYTES) / stage_bytes<In>() < MAX_STAGES
             ? (SMEM_LIMIT - SMEM_EXTRA - A_TILES * A_BYTES) / stage_bytes<In>()
             : MAX_STAGES;
}
}  // namespace cv

// The first frame, row and depth of tile ``tile`` of the walk: the depth
// tiles of a pair tile one after another, then the row tiles of a frame
// tile, then the frame tiles.
__device__ __forceinline__ void cv_tile(int tile, int nrt, int nct, int& f0, int& r0, int& d0) {
  const int pt = tile / nct;
  d0 = (tile - pt * nct) * cv::BN;
  r0 = (pt % nrt) * cv::RT;
  f0 = (pt / nrt) * cv::FT;
}

// A landed stage's A tile as thread t of the forming warpgroup forms it:
// samples 8c .. 8c + 7, c = t & 7, of row r = (t >> 3) & 7 of frames 8h ..
// 8h + 7, h = t >> 6 (pairs m = (8h + i) * RT + r), each sample (raw - pi) *
// inv_bg rounded op by op as torch rounds it, then to nearest bf16, two in
// one instruction.  A warp reads four whole rows of each frame.
template <typename In>
__device__ __forceinline__ void cv_form_a(uint32_t (&a)[8][4], const uint8_t* stage, int t) {
  const uint8_t* in = stage + cv::OP_BYTES;
  const float* pi_s = reinterpret_cast<const float*>(in + cv::in_bytes<In>());
  const float* inv_s = pi_s + cv::RT * cv::KT;
  const int c = t & 7, r = (t >> 3) & 7, h = t >> 6;
  float p[8], v[8];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float4 pq = *reinterpret_cast<const float4*>(pi_s + r * cv::KT + 8 * c + 4 * q);
    const float4 vq = *reinterpret_cast<const float4*>(inv_s + r * cv::KT + 8 * c + 4 * q);
    p[4 * q] = pq.x, p[4 * q + 1] = pq.y, p[4 * q + 2] = pq.z, p[4 * q + 3] = pq.w;
    v[4 * q] = vq.x, v[4 * q + 1] = vq.y, v[4 * q + 2] = vq.z, v[4 * q + 3] = vq.w;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = (8 * h + i) * cv::RT + r;
    float x[8];
    raw_counts<In>(x, in + (m * cv::KT + 8 * c) * sizeof(In));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 pair =
          __floats2bfloat162_rn(__fmul_rn(__fsub_rn(x[2 * j], p[2 * j]), v[2 * j]),
                                __fmul_rn(__fsub_rn(x[2 * j + 1], p[2 * j + 1]), v[2 * j + 1]));
      a[i][j] = *reinterpret_cast<const uint32_t*>(&pair);
    }
  }
}

// Stores what cv_form_a formed into the 128-byte-swizzled K-major tile a_s
// (16-byte chunk c of pair m at chunk c ^ (m & 7)).
__device__ __forceinline__ void cv_store_a(uint8_t* a_s, const uint32_t (&a)[8][4], int t) {
  const int c = t & 7, r = (t >> 3) & 7, h = t >> 6;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = (8 * h + i) * cv::RT + r;
    *reinterpret_cast<uint4*>(a_s + m * 128 + ((c ^ (m & 7)) << 4)) =
        make_uint4(a[i][0], a[i][1], a[i][2], a[i][3]);
  }
}

template <typename In>
__global__ void __launch_bounds__(cv::THREADS, 1)
cscan_volume_mags_kernel(const __grid_constant__ CUtensorMap in_map,
                         const __grid_constant__ CUtensorMap pi_map,
                         const __grid_constant__ CUtensorMap inv_map,
                         const __grid_constant__ CUtensorMap re_map,
                         const __grid_constant__ CUtensorMap im_map, float* __restrict__ mags,
                         int F, int rows, int n_in, int ndisp) {
  extern __shared__ uint8_t cv_smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(cv_smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  constexpr int nst = cv::stages<In>(), sbytes = cv::stage_bytes<In>();
  uint8_t* a_tiles = smem + nst * sbytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(a_tiles + cv::A_TILES * cv::A_BYTES);
  uint64_t* empty = full + cv::MAX_STAGES;
  uint64_t* a_full = empty + cv::MAX_STAGES;
  uint64_t* a_empty = a_full + cv::A_TILES;

  const int tid = threadIdx.x, wg = tid >> 7, lane = tid & 31;
  const int nk = (n_in + cv::KT - 1) / cv::KT;
  const int nrt = (rows + cv::RT - 1) / cv::RT, nct = (ndisp + cv::BN - 1) / cv::BN;
  const int tiles = nrt * ((F + cv::FT - 1) / cv::FT) * nct;

  if (tid == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 12);      // the four forming and the eight consumer warps
    }
    for (int i = 0; i < cv::A_TILES; ++i) {
      mbar_init(&a_full[i], 4);      // the four forming warps
      mbar_init(&a_empty[i], 8);     // the eight consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == 3) {
    // the producer: one thread issues every copy of the block's stages, the
    // ring running on across its tiles
    setmaxnreg_dec<cv::PRODUCER_REGS>();
    if (tid == 384) {
      int s = 0, ph = 0, it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int f0, r0, d0;
        cv_tile(tile, nrt, nct, f0, r0, d0);
        for (int kt = 0; kt < nk; ++kt, ++it) {
          uint8_t* st = smem + s * sbytes;
          if (it >= nst) mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], sbytes);
          const int k0 = kt * cv::KT;
          tma_load_2d(st, &re_map, &full[s], d0, k0);
          tma_load_2d(st + cv::OP_BOX, &im_map, &full[s], d0, k0);
          tma_load_3d(st + cv::OP_BYTES, &in_map, &full[s], k0, r0, f0);
          uint8_t* terms = st + cv::OP_BYTES + cv::in_bytes<In>();
          tma_load_2d(terms, &pi_map, &full[s], k0, r0);
          tma_load_2d(terms + cv::TERMS_BYTES, &inv_map, &full[s], k0, r0);
          if (++s == nst) s = 0, ph ^= 1;
        }
      }
    }
    return;
  }

  if (wg == 2) {
    // the forming warpgroup: each stage's A tile into A tile it % A_TILES,
    // once the wgmmas that read that tile last are done; it releases the
    // stage's slot (its frames and terms read) and announces the tile
    setmaxnreg_dec<cv::FORMER_REGS>();
    const int t = tid & 127;
    int s = 0, ph = 0, ai = 0, aph = 0, it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      for (int kt = 0; kt < nk; ++kt, ++it) {
        mbar_wait(&full[s], ph);
        uint32_t a[8][4];
        cv_form_a<In>(a, smem + s * sbytes, t);
        if (it >= cv::A_TILES) mbar_wait(&a_empty[ai], aph ^ 1);
        cv_store_a(a_tiles + ai * cv::A_BYTES, a, t);
        fence_proxy_async();           // the stores, before the consumers' wgmmas read them
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&a_full[ai]);
          mbar_arrive(&empty[s]);
        }
        if (++s == nst) s = 0, ph ^= 1;
        if (++ai == cv::A_TILES) ai = 0, aph ^= 1;
      }
    }
    return;
  }

  // the consumers: warpgroup wg multiplies the tile's pairs 64 wg .. 64 wg +
  // 63 (frames 8 wg .. 8 wg + 7) by its 64 depths
  setmaxnreg_inc<cv::CONSUMER_REGS>();
  const int warp = tid >> 5, g = lane >> 2, tq = lane & 3;
  float acc[64], part[64];   // the running sums and a round's fragment: re 0-31, im 32-63
#pragma unroll
  for (int i = 0; i < 64; ++i) part[i] = 0.f;
  const uint32_t a_mine = wg * (cv::A_BYTES / 2);          // its 64 pairs' rows of an A tile
  int s = 0, ph = 0, ai = 0, aph = 0, it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    int f0, r0, d0;
    cv_tile(tile, nrt, nct, f0, r0, d0);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      mbar_wait(&full[s], ph);         // B has landed
      mbar_wait(&a_full[ai], aph);     // A is formed
      const bool fresh = kt % cv::ROUND_STAGES == 0;      // a round's first stage
      if (fresh && kt > 0) {           // the round before ends: its wgmmas ran meanwhile
        wgmma_wait<0>();
        wgmma_hold(part);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
      }
      const uint32_t a_addr = smem_addr(a_tiles + ai * cv::A_BYTES) + a_mine;
      const uint32_t b_addr = smem_addr(smem + s * sbytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // a round's first k16 step starts its fragment at zero
        wgmma_m64n128k16_ss(part, wgmma_desc_k_sw128(a_addr + kk * 32),
                            wgmma_desc_mn_sw128(b_addr + kk * 16 * 128, cv::OP_BOX, 1024),
                            !fresh || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();                 // the stage before is done: release its slot and A tile
      if (it > 0) {
        __syncwarp();
        if (lane == 0) {
          mbar_arrive(&empty[s == 0 ? nst - 1 : s - 1]);
          mbar_arrive(&a_empty[ai == 0 ? cv::A_TILES - 1 : ai - 1]);
        }
      }
      if (kt == nk - 1) {              // the tile's last stage ends its last round
        wgmma_wait<0>();
        wgmma_hold(part);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = __fadd_rn(acc[i], part[i]);
      }
      if (++s == nst) s = 0, ph ^= 1;
      if (++ai == cv::A_TILES) ai = 0, aph ^= 1;
    }
    // the epilogue: acc[4j + 2h + e] (re) and acc[32 + 4j + 2h + e] (im) are
    // pair 16 (warp & 3) + 8h + g of the warpgroup's 64, depth 8j + 2 tq + e:
    // frame f0 + 8 wg + 2 (warp & 3) + h, row r0 + g
    const int r = r0 + g;
    if (r < rows) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int f = f0 + 8 * wg + 2 * (warp & 3) + h;
        if (f >= F) continue;
        float* out = mags + static_cast<size_t>(f) * ndisp * rows + r;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int d = d0 + 8 * j + 2 * tq + e;
            if (d >= ndisp) continue;
            float v = 0.f;
            tc::add_magnitude(v, acc[4 * j + 2 * h + e], acc[32 + 4 * j + 2 * h + e]);
            out[static_cast<size_t>(d) * rows] = v;
          }
      }
    }
  }
}

// out (ndisp, rows) = in (rows, ndisp) transposed, through 32 x 33 tiles of
// shared memory: the fallback's frame into its place in the volume.
__global__ void cv_transpose_kernel(const float* __restrict__ in, float* __restrict__ out,
                                    int rows, int ndisp) {
  __shared__ float tile[32][33];
  const int d0 = blockIdx.x * 32, r0 = blockIdx.y * 32;
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int r = r0 + i, d = d0 + threadIdx.x;
    if (r < rows && d < ndisp) tile[i][threadIdx.x] = in[static_cast<size_t>(r) * ndisp + d];
  }
  __syncthreads();
  for (int i = threadIdx.y; i < 32; i += blockDim.y) {
    const int d = d0 + i, r = r0 + threadIdx.x;
    if (r < rows && d < ndisp) out[static_cast<size_t>(d) * rows + r] = tile[threadIdx.x][i];
  }
}

template <typename In>
int launch_cv(const void* raw, const void* pi, const void* inv_bg, const void* op_re,
              const void* op_im, void* mags, int F, int rows, int n_in, int ndisp, void* stream) {
  const long long tiles = static_cast<long long>((rows + cv::RT - 1) / cv::RT) *
                          ((F + cv::FT - 1) / cv::FT) * ((ndisp + cv::BN - 1) / cv::BN);
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap maps[5] = {};
  const cuuint64_t n = static_cast<cuuint64_t>(n_in), nr = static_cast<cuuint64_t>(rows);
  const cuuint64_t es = sizeof(In);
  // the frames: dims (sample, row, frame), box KT x RT x FT, landing as
  // [frame][row][sample]
  const cuuint64_t in_dims[3] = {n, nr, static_cast<cuuint64_t>(F)};
  const cuuint64_t in_strides[2] = {n * es, nr * n * es};
  const cuuint32_t in_box[3] = {cv::KT, cv::RT, cv::FT};
  // pi and inv_bg: dims (sample, row), box KT x RT
  const cuuint64_t t_dims[2] = {n, nr}, t_strides[1] = {n * 4};
  const cuuint32_t t_box[2] = {cv::KT, cv::RT};
  // the depth-contiguous operator: dims (depth, sample), box BN x KT,
  // MN-major with the 128-byte swizzle
  const cuuint64_t op_dims[2] = {static_cast<cuuint64_t>(ndisp), n};
  const cuuint64_t op_strides[1] = {static_cast<cuuint64_t>(ndisp) * 2};
  const cuuint32_t op_box[2] = {cv::BN, cv::KT};
  const bool ok =
      tensor_map(&maps[0], tma_type<In>(), 3, raw, in_dims, in_strides, in_box,
                 CU_TENSOR_MAP_SWIZZLE_NONE) &&
      tensor_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, pi, t_dims, t_strides, t_box,
                 CU_TENSOR_MAP_SWIZZLE_NONE) &&
      tensor_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, inv_bg, t_dims, t_strides, t_box,
                 CU_TENSOR_MAP_SWIZZLE_NONE) &&
      tensor_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, op_re, op_dims, op_strides,
                 op_box, CU_TENSOR_MAP_SWIZZLE_128B) &&
      tensor_map(&maps[4], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, op_im, op_dims, op_strides,
                 op_box, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int nst = cv::stages<In>();
  static_assert(nst >= 2, "a ring of at least two stages");
  constexpr int smem = nst * cv::stage_bytes<In>() + cv::A_TILES * cv::A_BYTES + cv::SMEM_EXTRA;
  static_assert(smem <= cv::SMEM_LIMIT, "the shared memory a block may take");
  int device = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(cscan_volume_mags_kernel<In>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int grid = static_cast<int>(std::min<long long>(tiles, sms));
  cscan_volume_mags_kernel<In><<<grid, cv::THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], static_cast<float*>(mags), F, rows, n_in,
      ndisp);
  return static_cast<int>(cudaGetLastError());
}

// Where TMA cannot address the inputs: kernel 1's bf16 entry on each frame
// at B = 1 into ``scratch`` (rows, ndisp), then the frame transposed into
// its place; the same sums bit for bit.
template <typename In>
int launch_frames(const void* raw, const void* pi, const void* inv_bg, const void* op_re,
                  const void* op_im, void* mags, void* scratch, int F, int rows, int n_in,
                  int ndisp, void* stream) {
  const auto entry = sizeof(In) == 1 ? fdoct_recon_raw_u8_bf16 : fdoct_recon_raw_u16_bf16;
  const size_t frame_in = static_cast<size_t>(rows) * n_in * sizeof(In);
  const size_t frame_out = static_cast<size_t>(rows) * ndisp;
  const dim3 grid((ndisp + 31) / 32, (rows + 31) / 32), block(32, 8);
  for (int f = 0; f < F; ++f) {
    int rc = entry(static_cast<const uint8_t*>(raw) + f * frame_in, pi, inv_bg, op_re, op_im,
                   scratch, 1, rows, n_in, ndisp, stream);
    if (rc != 0) return rc;
    cv_transpose_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(scratch), static_cast<float*>(mags) + f * frame_out, rows,
        ndisp);
    rc = static_cast<int>(cudaGetLastError());
    if (rc != 0) return rc;
  }
  return 0;
}

template <typename In>
int launch_volume(const void* raw, const void* pi, const void* inv_bg, const void* op_re,
                  const void* op_im, void* mags, void* scratch, int F, int rows, int n_in,
                  int ndisp, void* stream) {
  if (F < 1 || rows < 1 || n_in < 1 || ndisp < 1) return static_cast<int>(cudaErrorInvalidValue);
  // TMA addresses the inputs (kernel 1's rule for raw frames), else the
  // per-frame fallback runs
  if (tma_applies<In>(n_in, ndisp, {raw, pi, inv_bg, op_re, op_im}))
    return launch_cv<In>(raw, pi, inv_bg, op_re, op_im, mags, F, rows, n_in, ndisp, stream);
  return launch_frames<In>(raw, pi, inv_bg, op_re, op_im, mags, scratch, F, rows, n_in, ndisp,
                           stream);
}

}  // namespace

// Plain C entry points for ctypes.  Every pointer is a contiguous device
// buffer: raw (F, rows, n_in) u8 or u16; pi, inv_bg (rows, n_in) f32; op_re,
// op_im (n_in, ndisp) bf16; mags (F, ndisp, rows) f32; scratch (rows, ndisp)
// f32, written only where TMA cannot address the inputs (ops.kernels.
// bf16_schedule says "mma.sync").  Launches on
// ``stream`` and returns cudaGetLastError() (0 when the launches were
// accepted).
extern "C" {

int fdoct_cscan_mags_u8_bf16(const void* raw, const void* pi, const void* inv_bg,
                             const void* op_re, const void* op_im, void* mags, void* scratch,
                             int F, int rows, int n_in, int ndisp, void* stream) {
  return launch_volume<uint8_t>(raw, pi, inv_bg, op_re, op_im, mags, scratch, F, rows, n_in,
                                ndisp, stream);
}

int fdoct_cscan_mags_u16_bf16(const void* raw, const void* pi, const void* inv_bg,
                              const void* op_re, const void* op_im, void* mags, void* scratch,
                              int F, int rows, int n_in, int ndisp, void* stream) {
  return launch_volume<uint16_t>(raw, pi, inv_bg, op_re, op_im, mags, scratch, F, rows, n_in,
                                 ndisp, stream);
}

}  // extern "C"
