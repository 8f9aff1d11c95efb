// csd_spmm_fwd — forward block-sparse junction for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/csd_spmm.py:csd_spmm_fwd (Pallas
// body _fwd_kernel): y = act(sum_f x[:, blk(block_idx[rb, f])] @ w[rb, f] + b)
// with w laid out (n_rb, d_in_b, bL, bR), f32 accumulation and the output in
// the dtype of x; and _csd_spmm_fwd_batched (body _fwd_kernel_batched), the
// same for E expert junctions at once: x (E, M, n_in), w (E, n_rb, d_in_b,
// bL, bR), bias (E, n_rb * bR), y (E, M, n_rb * bR), every expert reading
// the one shared block_idx. The single junction is the case E = 1.
//
// What bounds it on the card. In decode M is the number of serving slots
// (a handful of rows), so the kernel is bound by the bytes of the weight
// slab it has to stream once: for gemma3-4b in bf16 26.2 MB per up/gate
// junction and 41.9 MB per down junction, about 7.8 us and 12.5 us at
// 3.35 TB/s; the MoE decode step of granite-moe-1b-a400m (32 experts of
// C = 4 rows) 16.8 MB per up/gate call and 25.2 MB per down call. In
// training M is batch x sequence (4096 for gemma3-4b at 2 x 2048), and the
// work, 2 * M * (weights of the slab) operations (107 GFLOP for an
// up/gate junction, 172 for down), is far above the bf16 ridge point:
// bound by operations, ~109 us and ~174 us at 989 TFLOP/s. The expert
// junctions of granite-moe-1b-a400m in training (32 experts of C = 1280
// rows, 128 x 256 blocks) are smaller products, 21 and 32 GFLOP against
// ~140 MB: bound by bytes.
//
// What the design does about it: two bodies. The caller's plan
// (launch.fwd_tile_n) picks one and passes it as tile_n: the wgmma body
// and its tile width, or 0 for the grid body.
//
// bf16 at the training shapes, the expert-batched decode and most of
// prefill: csd_spmm_fwd_wgmma_kernel, a GEMM over gathered left blocks on
// the tensor cores' wgmma path. A tile is 128 rows of one expert by BN
// columns of one right block (BN 256, 128 or 64, dividing bR: 256 at every
// training shape, narrower at a few hundred rows); its CTA loops over the
// right block's d_in_b fan-in slots and over bL in 64-wide steps, so the
// fan-in never leaves the CTA: no split partial sums, no second pass, no
// atomics, and the result repeats bit for bit. x is K-major as it lies
// in memory (a 3-D tensor map (n_in, M, E), boxes of 64 k x 128 rows;
// rows past each expert's M read as zeros), w is MN-major (a block
// is bL x bR with bR contiguous: a 3-D map (bR, n_rb d_in_b bL, E), BN / 64
// boxes of 64 n x 64 k side by side) and wgmma reads it through its
// transpose bit, so no transposed copy of the slab is made. The CTAs are
// persistent, one per SM, CTA b taking tiles b, b + gridDim.x, ... with the
// rows fastest, so the CTAs at work share one right block's weights in the
// L2; a last round that would keep at most half the CTAs busy runs its
// tiles as BN / 2-wide halves on twice as many CTAs (gemma3-4b's down
// junction: 320 tiles on 132 SMs). Warpgroup 0 is the producer: one thread reads each slot's block_idx
// entry and keeps a ring of (x, w) stages in flight through TMA (3 of the
// 256-wide tiles, 4 of narrower ones), each completing on an mbarrier,
// running on into the next tile while the last one is stored. Warpgroups 1
// and 2 each run wgmma m64nBNk16 on 64 of the 128 rows (scale-d 0 on a
// tile's first step), f32 accumulators in registers, one group of
// products in flight while the next stage is waited for, and finish their
// rows from the registers: bias, relu or tanh-gelu with csd::emit's
// arithmetic, y and (save_preact) z from the same f32 value as bf16 into
// swizzled staging tiles in shared memory, which one thread stores with
// TMA (the rows past M fall outside the tensor map and are skipped) while
// the consumers go on to the next tile. (Storing y and z from the
// registers instead, as bf16 pairs that spread each warp's store over 8
// rows, took a third longer at gemma3-4b's gate junction, whose y and z
// are 84 MB each: PERF.md, section 6.)
//
// f32, the single junction's decode (M <= 16) and shapes whose few
// 128-row tiles would leave most SMs idle on a deep fan-in (gemma3-4b's
// down junction below 128 rows): csd_spmm_fwd_kernel in csd_spmm_fwd.cuh
// (which sparselint's race-broken copy shares). Each CTA
// owns one (BM x 64) output tile, BM = 16 for M <= 16 else 64, and loops
// over the fan-in slots itself, tiles of x and w streaming through a
// cp.async ring (6 stages for decode-sized M, 3 otherwise) into WMMA
// fragments (bf16) or the CUDA cores (f32). When the output tiles alone
// are too few to fill the card (gemma3's down junction has 40 in decode),
// the fan-in slots are split over gridDim.z CTAs that write f32 partial
// sums, and a second small kernel adds them in a fixed order. Experts are
// folded into gridDim.y; the ragged M edge is masked with zero-filled
// loads and guarded stores; the epilogue (csd::emit) adds the bias, applies
// the activation and stores y and, with save_preact, z.
#include "csd_spmm_fwd.cuh"
#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// bf16 at the training shapes: wgmma fed by TMA
// ---------------------------------------------------------------------------

constexpr int kBM = 128;            // rows per tile (two consumer warpgroups)
constexpr int kBK = 64;             // reduction step: one 128-byte row
constexpr int kThreads = 384;       // producer warpgroup + two consumers
constexpr int kBox = 64 * kBK * 2;  // one 64 x 64 bf16 box, bytes

// The shared memory of a BN-column tile: a ring of (x, w) stages, then
// each consumer's staging tiles of its 64 rows of y and z (BN / 64
// swizzled 64 x 64 boxes each, what the TMA stores read), then the ring's
// full and empty barriers. BN 256: 3 stages and one staging tile per
// consumer (z, then y once the TMA unit has read z); narrower tiles: 4
// stages and one staging tile each for y and z.
template <int BN>
struct FwdRing {
  static constexpr int A_BYTES = kBM * kBK * 2;  // x tile
  static constexpr int B_BYTES = BN * kBK * 2;   // w tile: BN / 64 boxes
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = BN == 256 ? 3 : hopper::kRingStages;
  static constexpr int OUT_BUFS = BN == 256 ? 1 : 2;
  static constexpr int OUT_TILE = 64 * BN * 2;
  static constexpr int OUT_BYTES = 2 * OUT_BUFS * OUT_TILE;
  // + 1024 to align the ring, + the full and empty barriers
  static constexpr int SMEM = STAGES * STAGE + OUT_BYTES + 1024 +
                              2 * STAGES * 8;
};

// How many of n_tiles tiles of width bn n_ctas persistent CTAs run whole:
// all, unless the last round's tiles would keep at most half the CTAs
// busy; then those are run as two halves of bn / 2 columns each (not at
// bn 64), so that the last round takes about half as long.
__host__ __device__ inline int fwd_full_tiles(int n_tiles, int n_ctas,
                                              int bn) {
  const int rest = n_tiles % n_ctas;
  return bn > 64 && rest > 0 && 2 * rest <= n_ctas ? n_tiles - rest
                                                   : n_tiles;
}

// Persistent: CTA b takes units b, b + gridDim.x, ... of the E x
// n_col_tiles x m_tiles tiles (rows fastest), a unit being a whole tile or,
// where the last round's tiles would keep at most half the CTAs busy, one
// BN / 2-column half of such a tile (fwd_units). ACT: 0 none, 1 relu, 2
// gelu. tm_z is a map of y where there is no z (has_z 0).
template <int BN, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
    csd_spmm_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                              const __grid_constant__ CUtensorMap tm_w,
                              const __grid_constant__ CUtensorMap tm_y,
                              const __grid_constant__ CUtensorMap tm_z,
                              const int* __restrict__ idx,
                              const __nv_bfloat16* __restrict__ bias,
                              int has_z, int M, int n_out, int d_in_b,
                              int bL, int bR, int n_tiles) {
  using R = FwdRing<BN>;
  constexpr int S = R::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t outs = ring + S * R::STAGE;
  const uint32_t bars = outs + R::OUT_BYTES;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };

  const int n_col_tiles = n_out / BN;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int steps_per_slot = bL / kBK;
  const int n_steps = d_in_b * steps_per_slot;  // per unit
  const int wg = threadIdx.x / 128;
  const int n_full = fwd_full_tiles(n_tiles, gridDim.x, BN);
  const int n_units = n_full + 2 * (n_tiles - n_full);
  // unit -> (first column, first row, expert) and whether it is a half
  // tile; tiles rows fastest, the halves of one tile adjacent
  auto decode = [&](int u, int& col0, int& m0, int& ex, bool& half) {
    half = u >= n_full;
    const int tile = half ? n_full + (u - n_full) / 2 : u;
    m0 = (tile % m_tiles) * kBM;
    const int rest = tile / m_tiles;
    col0 = (rest % n_col_tiles) * BN + (half ? (u - n_full) % 2 : 0) * BN / 2;
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
      int it = 0;  // stages issued so far, over all units of this CTA
      for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
        int col0, m0, ex;
        bool half;
        decode(u, col0, m0, ex, half);
        const int boxes = (half ? BN / 2 : BN) / 64;
        const int rb = col0 / bR;
        const int n0 = col0 - rb * bR;  // column offset in the right block
        for (int f = 0; f < d_in_b; ++f) {
          const int lb = __ldg(idx + rb * d_in_b + f);  // once per slot
          const int wrow = (rb * d_in_b + f) * bL;       // block's first row
          for (int k0 = 0; k0 < bL; k0 += kBK, ++it) {
            const int s = it % S;
            hopper::mbar_wait(empty(s), ((it / S) & 1) ^ 1);
            const uint32_t a = ring + s * R::STAGE;
            hopper::mbar_expect_tx(full(s), R::A_BYTES + boxes * kBox);
            hopper::tma_load_3d(a, &tm_x, full(s), lb * bL + k0, m0, ex);
            for (int c = 0; c < boxes; ++c)
              hopper::tma_load_3d(a + R::A_BYTES + c * kBox, &tm_w, full(s),
                                  n0 + 64 * c, wrow + k0, ex);
          }
        }
      }
    }
    return;
  }

  hopper::regs_consumer();
  const int c = wg - 1;  // rows [64 c, 64 c + 64) of each tile
  const int tid = threadIdx.x % 128;
  const uint32_t staging = outs + c * R::OUT_BUFS * R::OUT_TILE;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int it = 0;
  // one unit of W columns (BN, or BN / 2 for a half tile): the products
  // into the first W / 2 accumulators, then the epilogue
  auto unit = [&](auto width, int col0, int m0, int ex) {
    constexpr int W = decltype(width)::value;
    float(&d)[W / 2] = reinterpret_cast<float(&)[W / 2]>(acc);
    for (int t = 0; t < n_steps; ++t, ++it) {
      const int s = it % S;
      hopper::mbar_wait(full(s), (it / S) & 1);
      const uint32_t a = ring + s * R::STAGE + c * 64 * 128;
      const uint32_t b = ring + s * R::STAGE + R::A_BYTES;
      // x K-major; w MN-major: lbo steps from one 64-column box to the
      // next, sbo over 8 rows of k
      const uint64_t da = hopper::make_desc(a, 16, 1024);
      const uint64_t db = hopper::make_desc(b, kBox, 1024);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)  // 16 k per product
        hopper::wgmma<W, 0, 1>(d, da + 2 * kk, db + 128 * kk,
                               t > 0 || kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the previous stage's products are done
      if (t > 0) hopper::mbar_arrive(empty((it - 1) % S));
    }
    hopper::wgmma_wait<0>();
    hopper::mbar_arrive(empty((it - 1) % S));

    // The epilogue, with csd::emit's arithmetic: z = acc + bias, y =
    // act(z), each written as bf16 pairs into a staging tile (chunk
    // (col % 64) / 8 of row r at chunk ^ (r % 8): the 128-byte swizzle of
    // the tensor maps, and no bank conflict between the 8 rows a store
    // instruction spans), then stored by one thread with TMA, which skips
    // the rows past M.
    const __nv_bfloat16* brow =
        bias == nullptr ? nullptr
                        : bias + static_cast<size_t>(ex) * n_out + col0;
    const int row0 = m0 + c * 64;  // this consumer's first row
    auto stage = [&](uint32_t buf, bool pre) {
      unsigned char* base = smem_raw + (buf - raw);
#pragma unroll
      for (int h = 0; h < 4; h += 2) {
        const int r = hopper::frag_row(tid, h);
#pragma unroll
        for (int q = 0; q < W / 8; ++q) {
          const int col = hopper::frag_col(tid, q);
          float z0 = d[4 * q + h], z1 = d[4 * q + h + 1];
          if (brow != nullptr) {
            const float2 bb = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(brow + col));
            z0 += bb.x;
            z1 += bb.y;
          }
          if (!pre) {
            z0 = csd::activate(z0, ACT);
            z1 = csd::activate(z1, ACT);
          }
          *reinterpret_cast<__nv_bfloat162*>(
              base + (q / 8) * kBox + r * 128 + (((q % 8) ^ (r % 8)) << 4) +
              (col % 8) * 2) = __floats2bfloat162_rn(z0, z1);
        }
      }
    };
    // the staging tile in `buf` to global memory through `map`
    auto store = [&](uint32_t buf, const CUtensorMap* map) {
      hopper::fence_proxy_async();
      hopper::named_barrier(1 + c, 128);
      if (tid == 0 && row0 < M) {
#pragma unroll
        for (int b = 0; b < W / 64; ++b)
          hopper::tma_store_3d(map, buf + b * kBox, col0 + 64 * b, row0, ex);
        hopper::bulk_commit();
      }
    };
    // wait until the TMA unit has read this consumer's staging tiles
    auto drained = [&]() {
      if (tid == 0) hopper::bulk_wait_read<0>();
      hopper::named_barrier(1 + c, 128);
    };
    drained();  // the last unit's stores
    if (has_z) {
      stage(staging, true);
      store(staging, &tm_z);
      if (R::OUT_BUFS == 1) drained();
    }
    const uint32_t ybuf = staging + (R::OUT_BUFS - 1) * R::OUT_TILE;
    stage(ybuf, false);
    store(ybuf, &tm_y);
  };
  for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
    int col0, m0, ex;
    bool half;
    decode(u, col0, m0, ex, half);
    if constexpr (BN > 64) {
      if (half) {
        unit(std::integral_constant<int, BN / 2>{}, col0, m0, ex);
        continue;
      }
    }
    unit(std::integral_constant<int, BN>{}, col0, m0, ex);
  }
  if (tid == 0) hopper::bulk_wait<0>();  // every store written
}

// ---------------------------------------------------------------------------
// which body, and the launchers
// ---------------------------------------------------------------------------

// 128 x bn tiles of every expert.
long long wgmma_tiles(int E, int M, int n_rb, int bR, int bn) {
  return static_cast<long long>(E) * ((M + kBM - 1) / kBM) *
         (static_cast<long long>(n_rb) * bR / bn);
}

// Whether tile_n names a body the kernels have for these arguments: 0 the
// grid body, or in bf16 a wgmma tile width that divides bR.
bool body_taken(int dtype, int bR, int tile_n) {
  return tile_n == 0 ||
         (dtype == 1 && (tile_n == 64 || tile_n == 128 || tile_n == 256) &&
          bR % tile_n == 0);
}

int ring_smem(int bn) {
  return bn == 256 ? FwdRing<256>::SMEM
                   : bn == 128 ? FwdRing<128>::SMEM : FwdRing<64>::SMEM;
}

// The wgmma body's launch: min(tiles, n_sm) persistent CTAs.
plan::Dims wgmma_dims(int E, int M, int n_rb, int bR, int bn, int n_sm) {
  const long long tiles = wgmma_tiles(E, M, n_rb, bR, bn);
  return {dim3(static_cast<unsigned>(tiles < n_sm ? tiles : n_sm)), kThreads,
          static_cast<size_t>(ring_smem(bn))};
}

bool configured_wgmma[3][3] = {};  // [BN 64, 128, 256][act]

template <int BN, int ACT>
int launch_wgmma(const void* x, const void* w, const int* idx,
                 const void* bias, void* y, void* z, int E, int M, int n_in,
                 int n_rb, int d_in_b, int bL, int bR, int n_sm,
                 cudaStream_t stream) {
  const plan::Dims d = wgmma_dims(E, M, n_rb, bR, BN, n_sm);
  bool& done = configured_wgmma[BN == 256 ? 2 : BN / 128][ACT];
  if (!done) {
    cudaError_t e = cudaFuncSetAttribute(
        csd_spmm_fwd_wgmma_kernel<BN, ACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(d.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    done = true;
  }
  CUtensorMap tm_x, tm_w, tm_y, tm_z;
  const int n_out = n_rb * bR;
  if (!hopper::encode_3d(&tm_x, x, n_in, M, E, kBM) ||
      !hopper::encode_3d(&tm_w, w, bR,
                         static_cast<uint64_t>(n_rb) * d_in_b * bL, E, 64) ||
      !hopper::encode_3d(&tm_y, y, n_out, M, E, 64) ||
      !hopper::encode_3d(&tm_z, z != nullptr ? z : y, n_out, M, E, 64))
    return hopper::kEncodeFailed;
  csd_spmm_fwd_wgmma_kernel<BN, ACT><<<d.grid, d.threads, d.smem, stream>>>(
      tm_x, tm_w, tm_y, tm_z, idx, static_cast<const __nv_bfloat16*>(bias),
      z != nullptr, M, n_out, d_in_b, bL, bR,
      static_cast<int>(wgmma_tiles(E, M, n_rb, bR, BN)));
  return static_cast<int>(cudaGetLastError());
}

template <int BN>
int launch_wgmma_act(const void* x, const void* w, const int* idx,
                     const void* bias, void* y, void* z, int E, int M,
                     int n_in, int n_rb, int d_in_b, int bL, int bR,
                     int n_sm, int act, cudaStream_t stream) {
  if (act == 1)
    return launch_wgmma<BN, 1>(x, w, idx, bias, y, z, E, M, n_in, n_rb,
                               d_in_b, bL, bR, n_sm, stream);
  if (act == 2)
    return launch_wgmma<BN, 2>(x, w, idx, bias, y, z, E, M, n_in, n_rb,
                               d_in_b, bL, bR, n_sm, stream);
  return launch_wgmma<BN, 0>(x, w, idx, bias, y, z, E, M, n_in, n_rb,
                             d_in_b, bL, bR, n_sm, stream);
}

template <typename T, int BM>
int launch_grid(const void* x, const void* w, const int* idx,
                const void* bias, void* y, void* z, float* partial, int E,
                int M, int n_in, int n_rb, int d_in_b, int bL, int bR,
                int n_splits, int act, cudaStream_t stream) {
  const int e = csd_fwd::launch_splits<T, BM>(
      x, w, idx, bias, y, z, n_splits > 1 ? partial : nullptr, E, M, n_in,
      n_rb, d_in_b, bL, bR, n_splits, act, stream);
  if (e != 0 || n_splits == 1) return e;
  const plan::Dims d = csd::reduce_dims(static_cast<size_t>(E) * M * n_rb *
                                        bR);
  csd::reduce_splits_kernel<T><<<d.grid, d.threads, d.smem, stream>>>(
      partial, static_cast<const T*>(bias), static_cast<T*>(y),
      static_cast<T*>(z), E, M, n_rb * bR, n_splits, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BM>
int grid_plan(int E, int M, int n_rb, int bR, int n_splits, int* out) {
  plan::put(out, 0, csd_fwd::split_dims<T, BM>(E, M, n_rb, bR, n_splits));
  if (n_splits == 1) return 1;
  plan::put(out, 1, csd::reduce_dims(static_cast<size_t>(E) * M * n_rb * bR));
  return 2;
}

}  // namespace

// E expert junctions of M rows each over one shared pattern idx (n_rb,
// d_in_b): x (E, M, n_in), w (E, n_rb, d_in_b, bL, bR), bias (E, n_rb * bR)
// or null, y and z (E, M, n_rb * bR); E = 1 is the single junction.
// dtype: 0 float32, 1 bfloat16. act: 0 none, 1 relu, 2 gelu (tanh).
// tile_n: the body launch.fwd_plan chose, 0 the grid body, 64/128/256 the
// wgmma body at that tile width; n_sm: the SMs its persistent CTAs may
// fill. n_splits (grid body only; 1
// with the wgmma body): how many CTAs share one output tile's fan-in slots
// (1 = no second pass); every split must own at least one slot, and
// `partial` must then hold n_splits * E * M * n_rb * bR floats. z
// (nullable): where to write the pre-activation x @ W + b, in the dtype of
// x.
// Preconditions (checked by the Python wrapper): contiguous tensors on one
// device, 16-byte aligned, bL % 64 == 0, bR % 64 == 0, M >= 1, E >= 1, and
// for the grid body E * ceil(M / BM) <= 65535 (BM = 16 for M <= 16, else
// 64). Returns cudaGetLastError() after the launches, 10001 if the driver
// refused a tensor map, or cudaErrorInvalidValue for arguments the kernels
// do not take.
extern "C" int csd_spmm_fwd(const void* x, const void* w, const int* idx,
                            const void* bias, void* y, void* z,
                            float* partial, int E, int M, int n_in,
                            int n_rb, int d_in_b, int bL, int bR,
                            int n_splits, int n_sm, int tile_n, int dtype,
                            int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bn = tile_n;
  if (!body_taken(dtype, bR, bn) || (bn > 0 && n_splits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bn == 256)
    return launch_wgmma_act<256>(x, w, idx, bias, y, z, E, M, n_in, n_rb,
                                 d_in_b, bL, bR, n_sm, act, s);
  if (bn == 128)
    return launch_wgmma_act<128>(x, w, idx, bias, y, z, E, M, n_in, n_rb,
                                 d_in_b, bL, bR, n_sm, act, s);
  if (bn == 64)
    return launch_wgmma_act<64>(x, w, idx, bias, y, z, E, M, n_in, n_rb,
                                d_in_b, bL, bR, n_sm, act, s);
  const bool small = M <= 16;
  if (dtype == 0)
    return small ? launch_grid<float, 16>(x, w, idx, bias, y, z, partial, E,
                                          M, n_in, n_rb, d_in_b, bL, bR,
                                          n_splits, act, s)
                 : launch_grid<float, 64>(x, w, idx, bias, y, z, partial, E,
                                          M, n_in, n_rb, d_in_b, bL, bR,
                                          n_splits, act, s);
  if (dtype == 1)
    return small ? launch_grid<__nv_bfloat16, 16>(x, w, idx, bias, y, z,
                                                  partial, E, M, n_in, n_rb,
                                                  d_in_b, bL, bR, n_splits,
                                                  act, s)
                 : launch_grid<__nv_bfloat16, 64>(x, w, idx, bias, y, z,
                                                  partial, E, M, n_in, n_rb,
                                                  d_in_b, bL, bR, n_splits,
                                                  act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launches csd_spmm_fwd makes for these arguments, from the host code
// it launches with: five ints each (grid x, y, z, threads, dynamic shared
// memory bytes) written to out (room for 2). Returns the launch count, or
// -1 for arguments csd_spmm_fwd refuses.
extern "C" int csd_spmm_fwd_plan(int E, int M, int n_rb, int bR,
                                 int n_splits, int n_sm, int tile_n,
                                 int dtype, int* out) {
  if (!body_taken(dtype, bR, tile_n) || (tile_n > 0 && n_splits != 1))
    return -1;
  if (tile_n > 0) {
    plan::put(out, 0, wgmma_dims(E, M, n_rb, bR, tile_n, n_sm));
    return 1;
  }
  const bool small = M <= 16;
  if (dtype == 0)
    return small ? grid_plan<float, 16>(E, M, n_rb, bR, n_splits, out)
                 : grid_plan<float, 64>(E, M, n_rb, bR, n_splits, out);
  if (dtype == 1)
    return small ? grid_plan<__nv_bfloat16, 16>(E, M, n_rb, bR, n_splits, out)
                 : grid_plan<__nv_bfloat16, 64>(E, M, n_rb, bR, n_splits,
                                                out);
  return -1;
}
