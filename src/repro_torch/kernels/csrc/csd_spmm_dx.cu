// csd_spmm_dx — backward-data (BP, paper eq. (3b)) of the block-sparse
// junction for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/csd_spmm.py:csd_spmm_dx (Pallas body
// _dx_kernel), in its 4-D and its expert-batched (5-D) form:
//   dx[e, m, lb] = sum_g g[e, m, out_idx[lb, g]]
//                        @ w[e, out_idx[lb, g], out_slot[lb, g]]^T
// over the pattern's scatter form (each left block lb feeds d_out_b right
// blocks), shared by all E experts, with f32 accumulation and dx in the
// dtype of g. g is the cotangent with the fused activation's derivative
// already folded in: the caller masks dy once per backward
// (csd_mask_cotangent.cu) and hands the same g to dx and dw. The 4-D form
// is E = 1.
//
// What bounds it on the card: in training M is batch x sequence (4096 for
// gemma3-4b at 2 x 2048). Each left block's K = d_out_b * bR is 5120 for
// the up/gate junctions and 2048 for down, so the work is 2 * M * n_in * K
// operations (about 107 and 172 GFLOP) against ~100 MB of g, w and dx: far
// above the bf16 ridge point, bound by operations, ~108 us (up/gate) and
// ~174 us (down) at 989 TFLOP/s. The expert junctions of
// granite-moe-1b-a400m in training (32 experts of C = 1280 rows, 128 x 256
// blocks at density 0.5 / 0.75) are smaller products, about 21 and 32
// GFLOP against ~140 MB: bound by bytes.
//
// What the design does about it. bf16: a TN GEMM over gathered right
// blocks on the tensor cores' wgmma path. A tile is 128 rows by BN columns
// of dx inside one left block (BN the widest of 256, 128 and 64 that
// divides bL: wider tiles read fewer bytes per product); its CTA loops over
// the left block's d_out_b slots and over bR in 64-wide steps, so nothing
// is accumulated across CTAs: no atomics, and the result repeats bit for
// bit. Both operands are K-major as they lie in memory (g rows, and the
// rows of the w block, whose k runs along bR), so no transpose is made.
// The CTAs are persistent, one per SM, each taking every gridDim.x-th tile.
// Warpgroup 0 is the producer: one thread walks the tiles and the pattern
// and keeps a ring of 4 (g, w) stages in flight through TMA, each
// completing on an mbarrier, running on into the next tile while the last
// one is stored. Warpgroups 1 and 2 each run wgmma m64nBNk16 on 64 of the
// 128 rows, f32 accumulators in registers, with one group of products in
// flight while the next stage is waited for, and store their dx rows
// straight from the registers. The tensor maps are 3-D (k, rows, expert),
// so the expert is a coordinate, one body serves E = 1 and E > 1, and rows
// past each expert's M read as zeros; the store skips them. f32 (not on the
// main path): the CUDA cores, one 64 x 64 tile per CTA fed by a 3-stage
// cp.async ring.
#include "csd_spmm_common.cuh"
#include "hopper.cuh"

namespace {

using csd::cp_async16;
using csd::cp_async_commit;
using csd::cp_async_wait;
using csd::store;

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kBM = 128;       // dx rows per tile (two consumer warpgroups)
constexpr int kBK = 64;        // reduction step: one 128-byte swizzled row
constexpr int kThreads = 384;  // producer warpgroup + two consumers

// The ring of a BN-column tile: kRingStages (g, w) stages.
template <int BN>
struct DxRing {
  static constexpr int A_BYTES = kBM * kBK * 2;  // g tile
  static constexpr int B_BYTES = BN * kBK * 2;   // w tile
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = hopper::kRingStages;
  // + 1024 to align the ring, + the full and empty barriers
  static constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8;
};

// Persistent: CTA b takes tiles b, b + gridDim.x, ... of the E x
// n_col_tiles x m_tiles tiles (rows fastest), and the producer runs on into
// the next tile's stages while the consumers store the last one.
template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    csd_spmm_dx_wgmma_kernel(const __grid_constant__ CUtensorMap tm_g,
                             const __grid_constant__ CUtensorMap tm_w,
                             const int* __restrict__ oidx,
                             const int* __restrict__ oslot,
                             __nv_bfloat16* __restrict__ dx, int M, int n_in,
                             int d_in_b, int bL, int bR, int d_out_b,
                             int n_tiles) {
  using R = DxRing<BN>;
  constexpr int S = R::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t bars = ring + S * R::STAGE;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };

  const int n_col_tiles = n_in / BN;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int steps_per_slot = bR / kBK;
  const int n_steps = d_out_b * steps_per_slot;  // per tile
  const int wg = threadIdx.x / 128;
  // tile -> (first column, first row, expert), rows fastest: the CTAs at
  // work share the w columns of a few left blocks, read once into the L2
  auto decode = [&](int tile, int& col0, int& m0, int& ex) {
    m0 = (tile % m_tiles) * kBM;
    const int rest = tile / m_tiles;
    col0 = (rest % n_col_tiles) * BN;
    ex = rest / n_col_tiles;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 256);  // every consumer thread
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    hopper::regs_producer();
    if (threadIdx.x == 0) {
      int it = 0;  // stages issued so far, over all tiles of this CTA
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        int col0, m0, ex;
        decode(tile, col0, m0, ex);
        const int lb = col0 / bL;
        const int n0 = col0 - lb * bL;  // column offset in the left block
        for (int t = 0; t < n_steps; ++t, ++it) {
          const int s = it % S;
          hopper::mbar_wait(empty(s), ((it / S) & 1) ^ 1);
          const int g = t / steps_per_slot;
          const int k0 = (t - g * steps_per_slot) * kBK;
          const int rb = __ldg(oidx + lb * d_out_b + g);
          const int f = __ldg(oslot + lb * d_out_b + g);
          const uint32_t a = ring + s * R::STAGE;
          hopper::mbar_expect_tx(full(s), R::STAGE);
          hopper::tma_load_3d(a, &tm_g, full(s), rb * bR + k0, m0, ex);
          hopper::tma_load_3d(a + R::A_BYTES, &tm_w, full(s), k0,
                              (rb * d_in_b + f) * bL + n0, ex);
        }
      }
    }
    return;
  }

  hopper::regs_consumer();
  const int c = wg - 1;  // rows [64 c, 64 c + 64) of each tile
  const int tid = threadIdx.x % 128;
  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int t = 0; t < n_steps; ++t, ++it) {
      const int s = it % S;
      hopper::mbar_wait(full(s), (it / S) & 1);
      const uint32_t a = ring + s * R::STAGE + c * 64 * 128;
      const uint32_t b = ring + s * R::STAGE + R::A_BYTES;
      const uint64_t da = hopper::make_desc(a, 16, 1024);
      const uint64_t db = hopper::make_desc(b, 16, 1024);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)  // 32 bytes along k per step
        hopper::wgmma<BN, 0, 0>(acc, da + 2 * kk, db + 2 * kk);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the previous stage's products are done
      if (t > 0) hopper::mbar_arrive(empty((it - 1) % S));
    }
    hopper::wgmma_wait<0>();
    hopper::mbar_arrive(empty((it - 1) % S));

    int col0, m0, ex;
    decode(tile, col0, m0, ex);
    __nv_bfloat16* out = dx + static_cast<size_t>(ex) * M * n_in + col0;
#pragma unroll
    for (int h = 0; h < 4; h += 2) {
      const int m = m0 + c * 64 + hopper::frag_row(tid, h);
      if (m >= M) continue;
      __nv_bfloat16* row = out + static_cast<size_t>(m) * n_in;
#pragma unroll
      for (int q = 0; q < BN / 8; ++q)
        *reinterpret_cast<__nv_bfloat162*>(row + hopper::frag_col(tid, q)) =
            __floats2bfloat162_rn(acc[4 * q + h], acc[4 * q + h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// f32: the CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 128;
constexpr int kF32BN = 64;  // dx columns per CTA
constexpr int kF32BM = 64;  // dx rows per CTA

struct F32Tile {
  static constexpr int BK = 32;
  static constexpr int AS = BK + 4;  // g rows (kF32BM x BK), padded
  static constexpr int WS = BK + 4;  // w rows: [n][k], kF32BN x BK, padded
  static constexpr int STAGES = 3;
  static constexpr int SMEM = STAGES * (kF32BM * AS + kF32BN * WS) * 4;
};

__global__ void __launch_bounds__(kF32Threads)
    csd_spmm_dx_f32_kernel(const float* __restrict__ dy,
                           const float* __restrict__ w,
                           const int* __restrict__ oidx,
                           const int* __restrict__ oslot,
                           float* __restrict__ dx, int M, int n_out, int n_in,
                           int d_in_b, int bL, int bR, int d_out_b) {
  constexpr int BK = F32Tile::BK, AS = F32Tile::AS, WS = F32Tile::WS;
  constexpr int S = F32Tile::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  float* dys = reinterpret_cast<float*>(smem);
  float* ws = dys + S * kF32BM * AS;

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kF32BN;
  const int lb = col0 / bL;
  const int n0 = col0 - lb * bL;
  const int m0 = blockIdx.y * kF32BM;
  const int ex = blockIdx.z;
  dy += static_cast<size_t>(ex) * M * n_out;
  w += static_cast<size_t>(ex) * n_out * d_in_b * bL;
  dx += static_cast<size_t>(ex) * M * n_in;
  const int steps_per_slot = bR / BK;
  const int n_steps = d_out_b * steps_per_slot;

  auto load_stage = [&](int t) {
    if (t >= n_steps) return;
    const int stage = t % S;
    const int g = t / steps_per_slot;
    const int k0 = (t - g * steps_per_slot) * BK;
    const int rb = __ldg(oidx + lb * d_out_b + g);
    const int f = __ldg(oslot + lb * d_out_b + g);
    constexpr int AC = BK / 4;  // chunks per row
    const size_t col = static_cast<size_t>(rb) * bR + k0;
    float* ddst = dys + stage * kF32BM * AS;
    for (int c = tid; c < kF32BM * AC; c += kF32Threads) {
      const int r = c / AC, cc = c - r * AC;
      const int m = m0 + r;
      const bool ok = m < M;
      cp_async16(ddst + r * AS + cc * 4,
                 dy + static_cast<size_t>(ok ? m : 0) * n_out + col + cc * 4,
                 ok);
    }
    // w[rb, f] rows n0 .. n0 + 63, columns k0 .. k0 + BK: B[k][n] = w[n][k]
    const float* wsrc =
        w + ((static_cast<size_t>(rb) * d_in_b + f) * bL + n0) * bR + k0;
    float* wdst = ws + stage * kF32BN * WS;
    for (int c = tid; c < kF32BN * AC; c += kF32Threads) {
      const int r = c / AC, cc = c - r * AC;
      cp_async16(wdst + r * WS + cc * 4,
                 wsrc + static_cast<size_t>(r) * bR + cc * 4, true);
    }
  };

  for (int s = 0; s < S - 1; ++s) {
    load_stage(s);
    cp_async_commit();
  }
  // 16 threads across 64 columns (4 each), 8 across rows
  constexpr int TM = kF32BM / 8;
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
    const float* at = dys + stage * kF32BM * AS;
    const float* wt = ws + stage * kF32BN * WS;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = wt[(tx * 4 + j) * WS + kk];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a = at[(ty * TM + i) * AS + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a, b[j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      store(acc[i][j],
            dx + static_cast<size_t>(m) * n_in + col0 + tx * 4 + j);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// dx columns per tile of the bf16 kernel: the widest of 256, 128 and 64
// that divides the left block.
int bf16_bn(int bL) { return bL % 256 == 0 ? 256 : bL % 128 == 0 ? 128 : 64; }

int bf16_tiles(int E, int M, int n_in, int bL) {
  return E * ((M + kBM - 1) / kBM) * (n_in / bf16_bn(bL));
}

int bf16_smem(int bn) {
  return bn == 256 ? DxRing<256>::SMEM
                   : bn == 128 ? DxRing<128>::SMEM : DxRing<64>::SMEM;
}

// bf16: n_ctas persistent CTAs (the caller's choice, at most the tile
// count); f32: one CTA per 64 x 64 tile.
plan::Dims dx_dims(int dtype, int E, int M, int n_in, int bL, int n_ctas) {
  if (dtype == 0)
    return {dim3(n_in / kF32BN, (M + kF32BM - 1) / kF32BM, E), kF32Threads,
            static_cast<size_t>(F32Tile::SMEM)};
  return {dim3(n_ctas), kThreads, static_cast<size_t>(bf16_smem(bf16_bn(bL)))};
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
bool configured_bf16[3] = {false, false, false};  // BN 64, 128, 256

template <int BN>
int launch_bf16(const void* g, const void* w, const int* oidx,
                const int* oslot, void* dx, int E, int M, int n_rb,
                int d_in_b, int bL, int bR, int n_lb, int d_out_b, int n_ctas,
                cudaStream_t stream) {
  const int n_in = n_lb * bL, n_out = n_rb * bR;
  const plan::Dims d = dx_dims(1, E, M, n_in, bL, n_ctas);
  int rc = configure(csd_spmm_dx_wgmma_kernel<BN>, d.smem,
                     &configured_bf16[BN == 256 ? 2 : BN / 128]);
  if (rc != 0) return rc;
  CUtensorMap tm_g, tm_w;
  if (!hopper::encode_3d(&tm_g, g, n_out, M, E, kBM) ||
      !hopper::encode_3d(&tm_w, w, bR,
                         static_cast<uint64_t>(n_rb) * d_in_b * bL, E, BN))
    return hopper::kEncodeFailed;
  csd_spmm_dx_wgmma_kernel<BN><<<d.grid, d.threads, d.smem, stream>>>(
      tm_g, tm_w, oidx, oslot, static_cast<__nv_bfloat16*>(dx), M, n_in,
      d_in_b, bL, bR, d_out_b, bf16_tiles(E, M, n_in, bL));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// E expert junctions of M rows each over one shared scatter pattern: g (E,
// M, n_rb * bR), w (E, n_rb, d_in_b, bL, bR), dx (E, M, n_lb * bL); E = 1 is
// the single junction. g is the masked cotangent (no activation here).
// dtype: 0 float32, 1 bfloat16. n_ctas: the bf16 kernel's persistent CTAs,
// 1 <= n_ctas <= its tile count (ignored for float32).
// Preconditions (checked by the Python wrapper): contiguous tensors on one
// device, 16-byte aligned, bL % 64 == 0, bR % 64 == 0, M >= 1, 1 <= E <=
// 65535, ceil(M / 64) <= 65535, out_idx/out_slot (n_lb, d_out_b) int32
// with n_lb * d_out_b == n_rb * d_in_b.
// Returns cudaGetLastError() after the launch, or 10001 if the driver
// refused a tensor map.
extern "C" int csd_spmm_dx(const void* g, const void* w, const int* out_idx,
                           const int* out_slot, void* dx, int E, int M,
                           int n_rb, int d_in_b, int bL, int bR, int n_lb,
                           int d_out_b, int dtype, int n_ctas, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const int bn = bf16_bn(bL);
    if (bn == 256)
      return launch_bf16<256>(g, w, out_idx, out_slot, dx, E, M, n_rb,
                              d_in_b, bL, bR, n_lb, d_out_b, n_ctas, s);
    if (bn == 128)
      return launch_bf16<128>(g, w, out_idx, out_slot, dx, E, M, n_rb,
                              d_in_b, bL, bR, n_lb, d_out_b, n_ctas, s);
    return launch_bf16<64>(g, w, out_idx, out_slot, dx, E, M, n_rb, d_in_b,
                           bL, bR, n_lb, d_out_b, n_ctas, s);
  }
  if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int n_in = n_lb * bL;
  const plan::Dims d = dx_dims(0, E, M, n_in, bL, 0);
  int rc = configure(csd_spmm_dx_f32_kernel, d.smem, &configured_f32);
  if (rc != 0) return rc;
  csd_spmm_dx_f32_kernel<<<d.grid, d.threads, d.smem, s>>>(
      static_cast<const float*>(g), static_cast<const float*>(w), out_idx,
      out_slot, static_cast<float*>(dx), M, n_rb * bR, n_in, d_in_b, bL, bR,
      d_out_b);
  return static_cast<int>(cudaGetLastError());
}

// The launch csd_spmm_dx makes for these arguments, from the host code it
// launches with: six ints (grid x, y, z, threads, dynamic shared memory bytes,
// cluster) written to out. Returns the launch count (1), or -1 for an unknown
// dtype.
extern "C" int csd_spmm_dx_plan(int E, int M, int n_lb, int bL, int dtype,
                                int n_ctas, int* out) {
  if (dtype != 0 && dtype != 1) return -1;
  plan::put(out, 0, dx_dims(dtype, E, M, n_lb * bL, bL, n_ctas));
  return 1;
}
