// csd_spmm_dw — backward-weights (UP, paper eq. (4b)) of the block-sparse
// junction for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/csd_spmm.py:csd_spmm_dw (Pallas body
// _dw_kernel), in its 4-D and its expert-batched (5-D) form:
//   dw[e, rb, f] = x[e, :, block_idx[rb, f]]^T @ g[e, :, rb]
// summed over each expert's M rows, the pattern shared by all E experts,
// f32 accumulation and dw stored in the dtype of x; with want_db also
// db[e, rb] = sum_m g[e, m, rb] in f32. g is the cotangent with the fused
// activation's derivative already folded in: the caller masks dy once per
// backward (csd_mask_cotangent.cu) and hands the same g to dx and dw. The
// 4-D form is E = 1.
//
// What bounds it on the card: every (bL x bR) block of the slab is a
// product with depth M (4096 tokens for gemma3-4b at 2 x 2048), so the work
// is 2 * M * (weights of the slab) operations, about 107 GFLOP for an
// up/gate junction and 172 GFLOP for down, against ~70-110 MB of x, g and
// dw: bound by operations, ~108 us (up/gate) and ~174 us (down) at
// 989 TFLOP/s in bf16. The expert junctions of granite-moe-1b-a400m in
// training (32 experts of C = 1280 rows, 128 x 256 blocks) are smaller
// products, about 21 and 32 GFLOP against ~140 MB: bound by bytes.
//
// What the design does about it. bf16: a GEMM with depth M on the tensor
// cores' wgmma path. Each CTA owns a BI x BJ tile of one block (rb, f) (BI
// 128, or 64 where bL % 128 != 0; BJ the widest of 256, 128 and 64 that
// divides bR: wider tiles read fewer bytes per product) and loops
// over all of M itself, so the reduction over M never crosses CTAs: no
// split, no atomics, and the result repeats bit for bit. Both operands
// arrive M-major (x and g are row-major), so they go to the tensor cores as
// they lie: each stage holds 64 rows of M of the x columns and of the g
// columns in 64-wide TMA boxes, and wgmma reads both through MN-major
// descriptors (its transpose bits). Warpgroup 0 is the producer: one
// thread keeps a ring of 4 such stages in flight through TMA, each
// completing on an mbarrier. Each consumer warpgroup runs wgmma
// m64nBJk16 on 64 of the tile's rows, f32 accumulators in registers, one
// group of products in flight while the next stage is waited for, and
// stores dw from the registers. db is the column sum of the g tiles, read
// from shared memory in one fixed order (ascending M) by the first
// consumer warpgroup of the CTAs of slot f = 0 and row tile 0 only, while
// their products run, so each g element is counted once. The tensor maps
// are 3-D (column, row, expert): the expert is a coordinate, one body
// serves E = 1 and E > 1, and rows past each expert's M read as zeros and
// add nothing. f32 (not on the main path): the CUDA cores, one 64 x 64
// tile per CTA fed by a 3-stage cp.async ring.
#include "csd_spmm_common.cuh"
#include "hopper.cuh"

namespace {

using csd::cp_async16;
using csd::cp_async_commit;
using csd::cp_async_wait;
using csd::store;
using csd::to_f32;

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kBK = 64;  // rows of M per stage
constexpr int kBox = 64 * kBK * 2;  // one 64-column box of 64 rows, bytes

// WG consumer warpgroups (BI = 64 WG dw rows), BJ dw columns per CTA;
// kRingStages (x, g) stages.
template <int WG, int BJ>
struct DwRing {
  static constexpr int BI = 64 * WG;
  static constexpr int X_BYTES = WG * kBox;
  static constexpr int STAGE = X_BYTES + (BJ / 64) * kBox;
  static constexpr int STAGES = hopper::kRingStages;
  static constexpr int THREADS = 128 * (1 + WG);
  static constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8;
};

// CTA (x, y, z) owns dw rows [BI y, BI y + BI) and columns [BJ x, BJ x +
// BJ) of block z = (e n_rb + rb) d_in_b + f.
template <int WG, int BJ>
__global__ void __launch_bounds__(DwRing<WG, BJ>::THREADS, 1)
    csd_spmm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                             const __grid_constant__ CUtensorMap tm_g,
                             const int* __restrict__ idx,
                             __nv_bfloat16* __restrict__ dw,
                             float* __restrict__ db, int M, int n_out,
                             int d_in_b, int bL, int bR) {
  using R = DwRing<WG, BJ>;
  constexpr int S = R::STAGES;
  constexpr int NQ = (BJ + 127) / 128;  // db columns per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t bars = ring + S * R::STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };

  const int j0 = blockIdx.x * BJ;     // column offset inside the right block
  const int i0 = blockIdx.y * R::BI;  // row offset inside the left block
  const int n_blk = n_out / bR * d_in_b;  // slab blocks per expert
  const int ex = blockIdx.z / n_blk;
  const int blk = blockIdx.z - ex * n_blk;  // rb * d_in_b + f
  const int rb = blk / d_in_b;
  const int f = blk - rb * d_in_b;
  const int n_steps = (M + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 128 * WG);  // every consumer thread
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    if constexpr (WG == 2) hopper::regs_producer();
    if (threadIdx.x == 0) {
      const int xcol = __ldg(idx + blk) * bL + i0;
      const int gcol = rb * bR + j0;
      for (int t = 0; t < n_steps; ++t) {
        const int s = t % S;
        hopper::mbar_wait(empty(s), ((t / S) & 1) ^ 1);
        const uint32_t a = ring + s * R::STAGE;
        hopper::mbar_expect_tx(full(s), R::STAGE);
#pragma unroll
        for (int c = 0; c < WG; ++c)
          hopper::tma_load_3d(a + c * kBox, &tm_x, full(s), xcol + 64 * c,
                              t * kBK, ex);
#pragma unroll
        for (int c = 0; c < BJ / 64; ++c)
          hopper::tma_load_3d(a + R::X_BYTES + c * kBox, &tm_g, full(s),
                              gcol + 64 * c, t * kBK, ex);
      }
    }
    return;
  }

  if constexpr (WG == 2) hopper::regs_consumer();
  const int c = wg - 1;  // dw rows [64 c, 64 c + 64) of the tile
  const int tid = threadIdx.x % 128;
  // db of columns j0 + 128 q + tid: the first consumer warpgroup of the
  // CTAs of slot 0 and row tile 0
  const bool takes_db = db != nullptr && f == 0 && i0 == 0 && c == 0;
  float colsum[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) colsum[q] = 0.f;
  float acc[BJ / 2];
#pragma unroll
  for (int i = 0; i < BJ / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    const int s = t % S;
    hopper::mbar_wait(full(s), (t / S) & 1);
    const uint32_t a = ring + s * R::STAGE + c * kBox;
    const uint32_t b = ring + s * R::STAGE + R::X_BYTES;
    // MN-major: lbo steps from one 64-wide box to the next, sbo over 8 rows
    const uint64_t da = hopper::make_desc(a, kBox, 1024);
    const uint64_t dg = hopper::make_desc(b, kBox, 1024);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)  // 16 rows of 128 bytes per step
      hopper::wgmma<BJ, 1, 1>(acc, da + 128 * kk, dg + 128 * kk);
    hopper::wgmma_commit();
    if (takes_db) {
      // column j of the g boxes: box j / 64, 16-byte chunk (j % 64) / 8 of
      // each row, swizzled by the row
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int j = 128 * q + tid;
        if (j >= BJ) continue;
        const unsigned char* box = smem_raw + (b - raw) + (j / 64) * kBox;
        const int chunk = (j % 64) / 8, within = (j % 8) * 2;
#pragma unroll 8
        for (int r = 0; r < kBK; ++r)
          colsum[q] += to_f32(*reinterpret_cast<const __nv_bfloat16*>(
              box + r * 128 + ((chunk ^ (r % 8)) << 4) + within));
      }
    }
    hopper::wgmma_wait<1>();  // step t - 1's products are done
    if (t > 0) hopper::mbar_arrive(empty((t - 1) % S));
  }
  hopper::wgmma_wait<0>();

  const int n_rb = n_out / bR;
  __nv_bfloat16* out =
      dw + ((((static_cast<size_t>(ex) * n_rb + rb) * d_in_b + f) * bL + i0 +
             c * 64) * bR + j0);
#pragma unroll
  for (int h = 0; h < 4; h += 2) {
    __nv_bfloat16* row =
        out + static_cast<size_t>(hopper::frag_row(tid, h)) * bR;
#pragma unroll
    for (int q = 0; q < BJ / 8; ++q)
      *reinterpret_cast<__nv_bfloat162*>(row + hopper::frag_col(tid, q)) =
          __floats2bfloat162_rn(acc[4 * q + h], acc[4 * q + h + 1]);
  }
  if (takes_db) {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      if (128 * q + tid < BJ)
        db[static_cast<size_t>(ex) * n_out + rb * bR + j0 + 128 * q + tid] =
            colsum[q];
  }
}

// ---------------------------------------------------------------------------
// f32: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 128;
constexpr int kF32BI = 64;  // dw rows (inside bL) per CTA
constexpr int kF32BJ = 64;  // dw columns (inside bR) per CTA

struct F32Tile {
  static constexpr int BK = 32;          // rows of M per stage
  static constexpr int XS = kF32BI + 4;  // x rows: [k][i], BK x kF32BI
  static constexpr int DS = kF32BJ + 4;  // g rows: [k][j], BK x kF32BJ
  static constexpr int STAGES = 3;
  static constexpr int SMEM = STAGES * (BK * XS + BK * DS) * 4;
};

__global__ void __launch_bounds__(kF32Threads)
    csd_spmm_dw_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ dy,
                           const int* __restrict__ idx, float* __restrict__ dw,
                           float* __restrict__ db, int M, int n_in, int n_out,
                           int d_in_b, int bL, int bR) {
  constexpr int BK = F32Tile::BK, XS = F32Tile::XS, DS = F32Tile::DS;
  constexpr int S = F32Tile::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* dys = xs + S * BK * XS;

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kF32BJ;
  const int i0 = blockIdx.y * kF32BI;
  const int n_blk = n_out / bR * d_in_b;
  const int ex = blockIdx.z / n_blk;
  const int blk = blockIdx.z - ex * n_blk;  // rb * d_in_b + f
  x += static_cast<size_t>(ex) * M * n_in;
  dy += static_cast<size_t>(ex) * M * n_out;
  dw += static_cast<size_t>(ex) * n_blk * bL * bR;
  if (db != nullptr) db += static_cast<size_t>(ex) * n_out;
  const int rb = blk / d_in_b;
  const int f = blk - rb * d_in_b;
  const int lb = __ldg(idx + blk);
  const bool takes_db = db != nullptr && f == 0 && blockIdx.y == 0;
  const int n_steps = (M + BK - 1) / BK;
  const size_t xcol = static_cast<size_t>(lb) * bL + i0;
  const size_t dcol = static_cast<size_t>(rb) * bR + j0;

  auto load_stage = [&](int t) {
    if (t >= n_steps) return;
    const int stage = t % S;
    const int mrow0 = t * BK;
    float* xdst = xs + stage * BK * XS;
    float* ddst = dys + stage * BK * DS;
    constexpr int C = kF32BI / 4;  // chunks per row (kF32BI == kF32BJ)
    for (int c = tid; c < BK * C; c += kF32Threads) {
      const int r = c / C, cc = c - r * C;
      const int m = mrow0 + r;
      const bool ok = m < M;
      const size_t row = static_cast<size_t>(ok ? m : 0);
      cp_async16(xdst + r * XS + cc * 4, x + row * n_in + xcol + cc * 4, ok);
      cp_async16(ddst + r * DS + cc * 4, dy + row * n_out + dcol + cc * 4,
                 ok);
    }
  };

  for (int s = 0; s < S - 1; ++s) {
    load_stage(s);
    cp_async_commit();
  }
  float colsum = 0.f;  // thread j < kF32BJ: db of column j0 + j
  // 16 threads across 64 columns (4 each), 8 across rows
  constexpr int TM = kF32BI / 8;
  const int tx = tid % 16, ty = tid / 16;
  float acc[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<S - 2>();
    __syncthreads();
    load_stage(t + S - 1);
    cp_async_commit();
    const int stage = t % S;
    const float* xt = xs + stage * BK * XS;
    const float* dt = dys + stage * BK * DS;
    if (takes_db && tid < kF32BJ)
      for (int r = 0; r < BK; ++r) colsum += dt[r * DS + tid];
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 b4 = *reinterpret_cast<const float4*>(dt + kk * DS + tx * 4);
      const float4* ap =
          reinterpret_cast<const float4*>(xt + kk * XS + ty * TM);
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 a4 = ap[q];
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int i = q * 4 + u;
          acc[i][0] = fmaf(a[u], b4.x, acc[i][0]);
          acc[i][1] = fmaf(a[u], b4.y, acc[i][1]);
          acc[i][2] = fmaf(a[u], b4.z, acc[i][2]);
          acc[i][3] = fmaf(a[u], b4.w, acc[i][3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  float* out = dw + (static_cast<size_t>(blk) * bL + i0) * bR + j0;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store(acc[i][j], out + static_cast<size_t>(ty * TM + i) * bR + tx * 4 + j);
  if (takes_db && tid < kF32BJ) db[dcol + tid] = colsum;
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// The bf16 kernel's tile: rows 128 (two consumer warpgroups) where the left
// block holds whole 128-row tiles, else 64; columns the widest of 256, 128
// and 64 that divides the right block.
int bf16_wg(int bL) { return bL % 128 == 0 ? 2 : 1; }
int bf16_bj(int bR) { return bR % 256 == 0 ? 256 : bR % 128 == 0 ? 128 : 64; }

template <int WG>
int ring_smem(int bj) {
  return bj == 256 ? DwRing<WG, 256>::SMEM
                   : bj == 128 ? DwRing<WG, 128>::SMEM : DwRing<WG, 64>::SMEM;
}

plan::Dims dw_dims(int dtype, int E, int n_rb, int d_in_b, int bL, int bR) {
  if (dtype == 0)
    return {dim3(bR / kF32BJ, bL / kF32BI, E * n_rb * d_in_b), kF32Threads,
            static_cast<size_t>(F32Tile::SMEM)};
  const int wg = bf16_wg(bL), bj = bf16_bj(bR);
  return {dim3(bR / bj, bL / (64 * wg), E * n_rb * d_in_b), 128 * (1 + wg),
          static_cast<size_t>(wg == 2 ? ring_smem<2>(bj) : ring_smem<1>(bj))};
}

// Opts the kernel into its dynamic shared memory once per library.
template <typename K>
int configure(K kernel, size_t smem, bool* done) {
  if (*done) return 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  *done = true;
  return 0;
}

bool configured_f32 = false;
bool configured_bf16[2][3] = {};  // [WG - 1][BJ 64, 128, 256]

template <int WG, int BJ>
int launch_bf16(const void* x, const void* g, const int* idx, void* dw,
                float* db, int E, int M, int n_in, int n_rb, int d_in_b,
                int bL, int bR, cudaStream_t stream) {
  const plan::Dims d = dw_dims(1, E, n_rb, d_in_b, bL, bR);
  int rc = configure(csd_spmm_dw_wgmma_kernel<WG, BJ>, d.smem,
                     &configured_bf16[WG - 1][BJ == 256 ? 2 : BJ / 128]);
  if (rc != 0) return rc;
  CUtensorMap tm_x, tm_g;
  if (!hopper::encode_3d(&tm_x, x, n_in, M, E, kBK) ||
      !hopper::encode_3d(&tm_g, g, static_cast<uint64_t>(n_rb) * bR, M, E,
                         kBK))
    return hopper::kEncodeFailed;
  csd_spmm_dw_wgmma_kernel<WG, BJ><<<d.grid, d.threads, d.smem, stream>>>(
      tm_x, tm_g, idx, static_cast<__nv_bfloat16*>(dw), db, M, n_rb * bR,
      d_in_b, bL, bR);
  return static_cast<int>(cudaGetLastError());
}

template <int WG>
int launch_bf16_wg(const void* x, const void* g, const int* idx, void* dw,
                   float* db, int E, int M, int n_in, int n_rb, int d_in_b,
                   int bL, int bR, cudaStream_t stream) {
  const int bj = bf16_bj(bR);
  if (bj == 256)
    return launch_bf16<WG, 256>(x, g, idx, dw, db, E, M, n_in, n_rb, d_in_b,
                                bL, bR, stream);
  if (bj == 128)
    return launch_bf16<WG, 128>(x, g, idx, dw, db, E, M, n_in, n_rb, d_in_b,
                                bL, bR, stream);
  return launch_bf16<WG, 64>(x, g, idx, dw, db, E, M, n_in, n_rb, d_in_b, bL,
                             bR, stream);
}

}  // namespace

// E expert junctions of M rows each over one shared pattern block_idx
// (n_rb, d_in_b): x (E, M, n_in), g (E, M, n_rb * bR), dw (E, n_rb, d_in_b,
// bL, bR); E = 1 is the single junction. g is the masked cotangent (no
// activation here). dtype: 0 float32, 1 bfloat16. db (nullable): E * n_rb
// * bR floats.
// Preconditions (checked by the Python wrapper): contiguous tensors on one
// device, 16-byte aligned, bL % 64 == 0, bR % 64 == 0, n_in % bL == 0,
// M >= 1, E >= 1, E * n_rb * d_in_b <= 65535.
// Returns cudaGetLastError() after the launch, or 10001 if the driver
// refused a tensor map.
extern "C" int csd_spmm_dw(const void* x, const void* g, const int* block_idx,
                           void* dw, float* db, int E, int M, int n_in,
                           int n_rb, int d_in_b, int bL, int bR, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bf16_wg(bL) == 2
               ? launch_bf16_wg<2>(x, g, block_idx, dw, db, E, M, n_in, n_rb,
                                   d_in_b, bL, bR, s)
               : launch_bf16_wg<1>(x, g, block_idx, dw, db, E, M, n_in, n_rb,
                                   d_in_b, bL, bR, s);
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const plan::Dims d = dw_dims(0, E, n_rb, d_in_b, bL, bR);
  int rc = configure(csd_spmm_dw_f32_kernel, d.smem, &configured_f32);
  if (rc != 0) return rc;
  csd_spmm_dw_f32_kernel<<<d.grid, d.threads, d.smem, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), block_idx,
      static_cast<float*>(dw), db, M, n_in, n_rb * bR, d_in_b, bL, bR);
  return static_cast<int>(cudaGetLastError());
}

// The launch csd_spmm_dw makes for these arguments, from the host code it
// launches with: six ints (grid x, y, z, threads, dynamic shared memory bytes,
// cluster) written to out. Returns the launch count (1), or -1 for an unknown
// dtype.
extern "C" int csd_spmm_dw_plan(int E, int n_rb, int d_in_b, int bL, int bR,
                                int dtype, int* out) {
  if (dtype != 0 && dtype != 1) return -1;
  plan::put(out, 0, dw_dims(dtype, E, n_rb, d_in_b, bL, bR));
  return 1;
}
