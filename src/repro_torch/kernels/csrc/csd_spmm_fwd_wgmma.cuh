// The forward junction's wgmma body, shared by csd_spmm_fwd.cu (bf16
// weights: TPU kernels #1 and #3) and csd_spmm_fwd_quant.cu (int8 weights
// with one f32 scale per block: #4 and #5), each library instantiating it
// for its weight type W.
//
// A GEMM over gathered left blocks on the tensor cores' wgmma path. A tile
// is 128 rows of one expert by BN columns of one right block (BN 256, 128
// or 64 dividing bR; int8 at most 128); its CTA loops over the right
// block's d_in_b fan-in slots and over bL in 64-wide steps, so the fan-in
// never leaves the CTA: no split partial sums, no second pass, no atomics,
// and the result repeats bit for bit. x is K-major as it lies in memory (a
// 3-D tensor map (n_in, M, E), boxes of 64 k x 128 rows; rows past each
// expert's M read as zeros), w is MN-major (a block is bL x bR with bR
// contiguous: a 3-D map (bR, n_rb d_in_b bL, E), BN / 64 boxes of 64 n x 64
// k side by side) and wgmma reads it through its transpose bit, so no
// transposed copy of the slab is made. The CTAs are persistent, one per SM,
// CTA b taking tiles b, b + gridDim.x, ... with the rows fastest, so the
// CTAs at work share one right block's weights in the L2; a last round
// that would keep at most half the CTAs busy runs its tiles as BN / 2-wide
// halves on twice as many CTAs (gemma3-4b's down junction: 320 tiles on
// 132 SMs). Warpgroup 0 is the producer: one thread reads each slot's
// block_idx entry and keeps a ring of (x, w) stages in flight through TMA
// (3 of the 256-wide tiles, 4 of narrower ones), each completing on an
// mbarrier, running on into the next tile while the last one is stored.
// Warpgroups 1 and 2 each run wgmma m64nBNk16 on 64 of the 128 rows
// (scale-d 0 on a tile's first step), f32 accumulators in registers, one
// group of products in flight while the next stage is waited for, and
// finish their rows from the registers: bias, relu or tanh-gelu with
// csd::emit's arithmetic, y and (save_preact) z from the same f32 value as
// bf16 into swizzled staging tiles in shared memory, which one thread
// stores with TMA (the rows past M fall outside the tensor map and are
// skipped) while the consumers go on to the next tile.
//
// int8 weights: the producer loads the w boxes as int8 (64 x 64 bytes
// each, unswizzled, half the bytes of bf16). Every stage, the 256 consumer
// threads widen the arrived int8 tile exactly (hopper::s8x2_to_bf16x2) into a
// 128-byte-swizzled bf16 tile, the layout wgmma reads MN-major, then meet
// on a named barrier of the two consumers (never the whole CTA) and
// multiply. Three widened tiles rotate: the one written at step t was last
// read by step t - 3's products, which both consumers have waited for
// before they reached step t - 1's barrier. Each slot's products go to a
// second register accumulator (scale-d 0 on the slot's first step), which
// is scaled by the slot's f32 scale at the slot's end and added to the
// running sum, in the slots' order, as the plain version does; the scale
// is never folded into the weights (bf16(q * s) would round). (Widening in
// the producer warpgroup's three idle warps instead, into a ring of its
// own, ran slower: 96 threads held to 40 registers widen too slowly.)
#pragma once

#include <type_traits>

#include "csd_spmm_common.cuh"
#include "hopper.cuh"

namespace fwd_wgmma {
namespace {  // internal linkage: every library keeps its own copies

constexpr int kBM = 128;            // rows per tile (two consumer warpgroups)
constexpr int kBK = 64;             // reduction step: one 128-byte row
constexpr int kThreads = 384;       // producer warpgroup + two consumers
constexpr int kBox = 64 * kBK * 2;  // one 64 x 64 bf16 box, bytes
constexpr int kQBox = 64 * kBK;     // one 64 x 64 int8 box, bytes
constexpr int kWiden = 3;           // widened bf16 tiles of the int8 body

template <typename W>
__host__ __device__ constexpr bool is_int8() {
  return std::is_same<W, int8_t>::value;
}

// The shared memory of a BN-column tile: a ring of (x, w) stages, (int8)
// the widened bf16 tiles, then each consumer's staging tiles of its 64 rows
// of y and z (BN / 64 swizzled 64 x 64 boxes each, what the TMA stores
// read), then the ring's full and empty barriers. BN 256: 3 stages and one
// staging tile per consumer (z, then y once the TMA unit has read z);
// narrower tiles: 4 stages and one staging tile each for y and z.
template <int BN, typename W>
struct FwdRing {
  static constexpr int A_BYTES = kBM * kBK * 2;  // x tile
  static constexpr int W_BOX = is_int8<W>() ? kQBox : kBox;
  static constexpr int B_BYTES = BN / 64 * W_BOX;  // w tile
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int STAGES = BN == 256 ? 3 : hopper::kRingStages;
  static constexpr int WIDE = BN / 64 * kBox;  // one widened tile
  static constexpr int WIDE_BYTES = is_int8<W>() ? kWiden * WIDE : 0;
  static constexpr int OUT_BUFS = BN == 256 ? 1 : 2;
  static constexpr int OUT_TILE = 64 * BN * 2;
  static constexpr int OUT_BYTES = 2 * OUT_BUFS * OUT_TILE;
  // + 1024 to align the ring, + the full and empty barriers
  static constexpr int SMEM = STAGES * STAGE + WIDE_BYTES + OUT_BYTES +
                              1024 + 2 * STAGES * 8;
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
// gelu. tm_z is a map of y where there is no z (has_z 0). scale: the int8
// slab's (E, n_rb, d_in_b) block scales (W int8 only).
template <typename W, int BN, int ACT>
__global__ void __launch_bounds__(kThreads, 1)
    csd_spmm_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x,
                              const __grid_constant__ CUtensorMap tm_w,
                              const __grid_constant__ CUtensorMap tm_y,
                              const __grid_constant__ CUtensorMap tm_z,
                              const int* __restrict__ idx,
                              const __nv_bfloat16* __restrict__ bias,
                              const float* __restrict__ scale, int has_z,
                              int M, int n_out, int d_in_b, int bL, int bR,
                              int n_tiles) {
  constexpr bool Q = is_int8<W>();
  using R = FwdRing<BN, W>;
  constexpr int S = R::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t wide = ring + S * R::STAGE;
  const uint32_t outs = wide + R::WIDE_BYTES;
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
            hopper::mbar_expect_tx(full(s), R::A_BYTES + boxes * R::W_BOX);
            hopper::tma_load_3d(a, &tm_x, full(s), lb * bL + k0, m0, ex);
            for (int c = 0; c < boxes; ++c)
              hopper::tma_load_3d(a + R::A_BYTES + c * R::W_BOX, &tm_w,
                                  full(s), n0 + 64 * c, wrow + k0, ex);
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
  float part[Q ? BN / 2 : 1];  // int8: the current slot's products
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  int it = 0;
  // The int8 tile at `src` (W / 64 boxes of 64 k rows x 64 bytes) as bf16
  // into the widened tile `dst` (W / 64 swizzled 64 x 64 boxes): each
  // consumer thread widens 16 weights of one row per pass, box b, row k,
  // bytes [16 c4, 16 c4 + 16) into bf16 chunks 2 c4 and 2 c4 + 1 of row k
  auto widen = [&](auto width, uint32_t src, uint32_t dst) {
    constexpr int Wd = decltype(width)::value;
    const unsigned char* in = smem_raw + (src - raw);
    unsigned char* out = smem_raw + (dst - raw);
#pragma unroll
    for (unsigned q = threadIdx.x - 128; q < Wd / 64 * 256; q += 256) {
      const unsigned b = q / 256, k = (q / 4) % 64, c4 = q % 4;
      const uint4 v =
          *reinterpret_cast<const uint4*>(in + b * kQBox + k * 64 + c4 * 16);
      const uint32_t u[4] = {v.x, v.y, v.z, v.w};
      uint32_t h[8];  // bytes 0 and 1, then 2 and 3, of each word
#pragma unroll
      for (int i = 0; i < 8; ++i)
        h[i] = hopper::s8x2_to_bf16x2(
            __byte_perm(u[i / 2], 0u, i % 2 ? 0x3302u : 0x1100u));
      unsigned char* row = out + b * kBox + k * 128;
      *reinterpret_cast<uint4*>(row + (((2 * c4) ^ (k % 8)) << 4)) =
          make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(row + (((2 * c4 + 1) ^ (k % 8)) << 4)) =
          make_uint4(h[4], h[5], h[6], h[7]);
    }
  };
  // one unit of W columns (BN, or BN / 2 for a half tile): the products
  // into the first W / 2 accumulators, then the epilogue
  auto unit = [&](auto width, int col0, int m0, int ex) {
    constexpr int Wd = decltype(width)::value;
    float(&d)[Wd / 2] = reinterpret_cast<float(&)[Wd / 2]>(acc);
    const int rb = col0 / bR;
    const float* srow =
        Q ? scale + (static_cast<size_t>(ex) * (n_out / bR) + rb) * d_in_b
          : nullptr;
    if constexpr (Q) {
#pragma unroll
      for (int i = 0; i < Wd / 2; ++i) d[i] = 0.f;
    }
    for (int t = 0; t < n_steps; ++t, ++it) {
      const int s = it % S;
      hopper::mbar_wait(full(s), (it / S) & 1);
      const uint32_t a = ring + s * R::STAGE + c * 64 * 128;
      uint32_t b = ring + s * R::STAGE + R::A_BYTES;
      if constexpr (Q) {  // the widened tile instead
        const uint32_t wb = wide + (it % kWiden) * R::WIDE;
        widen(width, b, wb);
        hopper::fence_proxy_async();  // the widened tile to wgmma
        hopper::named_barrier(3, 256);
        b = wb;
      }
      // x K-major; w MN-major: lbo steps from one 64-column box to the
      // next, sbo over 8 rows of k
      const uint64_t da = hopper::make_desc(a, 16, 1024);
      const uint64_t db = hopper::make_desc(b, kBox, 1024);
      const int kstep = Q ? t % steps_per_slot : t;
      if constexpr (Q) {
        float(&p)[Wd / 2] = reinterpret_cast<float(&)[Wd / 2]>(part);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)  // 16 k per product
          hopper::wgmma<Wd, 0, 1>(p, da + 2 * kk, db + 128 * kk,
                                  kstep > 0 || kk > 0);
      } else {
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)  // 16 k per product
          hopper::wgmma<Wd, 0, 1>(d, da + 2 * kk, db + 128 * kk,
                                  kstep > 0 || kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // the previous stage's products are done
      if (t > 0) hopper::mbar_arrive(empty((it - 1) % S));
      if constexpr (Q) {
        if (kstep == steps_per_slot - 1) {  // the slot's end: scale, add
          hopper::wgmma_wait<0>();
          float(&p)[Wd / 2] = reinterpret_cast<float(&)[Wd / 2]>(part);
          const float sc = __ldg(srow + t / steps_per_slot);
#pragma unroll
          for (int i = 0; i < Wd / 2; ++i) d[i] += p[i] * sc;
        }
      }
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
        for (int q = 0; q < Wd / 8; ++q) {
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
        for (int b = 0; b < Wd / 64; ++b)
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
// the launch
// ---------------------------------------------------------------------------

// 128 x bn tiles of every expert.
long long wgmma_tiles(int E, int M, int n_rb, int bR, int bn) {
  return static_cast<long long>(E) * ((M + kBM - 1) / kBM) *
         (static_cast<long long>(n_rb) * bR / bn);
}

template <typename W>
int ring_smem(int bn) {
  return bn == 256 ? FwdRing<256, W>::SMEM
                   : bn == 128 ? FwdRing<128, W>::SMEM
                               : FwdRing<64, W>::SMEM;
}

// The wgmma body's launch: min(tiles, n_sm) persistent CTAs.
template <typename W>
plan::Dims wgmma_dims(int E, int M, int n_rb, int bR, int bn, int n_sm) {
  const long long tiles = wgmma_tiles(E, M, n_rb, bR, bn);
  return {dim3(static_cast<unsigned>(tiles < n_sm ? tiles : n_sm)), kThreads,
          static_cast<size_t>(ring_smem<W>(bn))};
}

template <typename W, int BN, int ACT>
int launch_wgmma(const void* x, const void* w, const float* scale,
                 const int* idx, const void* bias, void* y, void* z, int E,
                 int M, int n_in, int n_rb, int d_in_b, int bL, int bR,
                 int n_sm, cudaStream_t stream) {
  const plan::Dims d = wgmma_dims<W>(E, M, n_rb, bR, BN, n_sm);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        csd_spmm_fwd_wgmma_kernel<W, BN, ACT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(d.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  CUtensorMap tm_x, tm_w, tm_y, tm_z;
  const int n_out = n_rb * bR;
  const uint64_t w_rows = static_cast<uint64_t>(n_rb) * d_in_b * bL;
  const bool w_ok = is_int8<W>()
                        ? hopper::encode_3d_s8(&tm_w, w, bR, w_rows, E, 64,
                                               64)
                        : hopper::encode_3d(&tm_w, w, bR, w_rows, E, 64);
  if (!hopper::encode_3d(&tm_x, x, n_in, M, E, kBM) || !w_ok ||
      !hopper::encode_3d(&tm_y, y, n_out, M, E, 64) ||
      !hopper::encode_3d(&tm_z, z != nullptr ? z : y, n_out, M, E, 64))
    return hopper::kEncodeFailed;
  csd_spmm_fwd_wgmma_kernel<W, BN, ACT><<<d.grid, d.threads, d.smem,
                                          stream>>>(
      tm_x, tm_w, tm_y, tm_z, idx, static_cast<const __nv_bfloat16*>(bias),
      scale, z != nullptr, M, n_out, d_in_b, bL, bR,
      static_cast<int>(wgmma_tiles(E, M, n_rb, bR, BN)));
  return static_cast<int>(cudaGetLastError());
}

template <typename W, int BN>
int launch_wgmma_act(const void* x, const void* w, const float* scale,
                     const int* idx, const void* bias, void* y, void* z,
                     int E, int M, int n_in, int n_rb, int d_in_b, int bL,
                     int bR, int n_sm, int act, cudaStream_t stream) {
  if (act == 1)
    return launch_wgmma<W, BN, 1>(x, w, scale, idx, bias, y, z, E, M, n_in,
                                  n_rb, d_in_b, bL, bR, n_sm, stream);
  if (act == 2)
    return launch_wgmma<W, BN, 2>(x, w, scale, idx, bias, y, z, E, M, n_in,
                                  n_rb, d_in_b, bL, bR, n_sm, stream);
  return launch_wgmma<W, BN, 0>(x, w, scale, idx, bias, y, z, E, M, n_in,
                                n_rb, d_in_b, bL, bR, n_sm, stream);
}

}  // namespace
}  // namespace fwd_wgmma
