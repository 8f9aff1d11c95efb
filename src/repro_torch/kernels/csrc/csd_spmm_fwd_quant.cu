// csd_spmm_fwd_quant — int8-weight forward block-sparse junction for Hopper
// (sm_90a), inference only.
//
// Replaces the TPU kernel repro/kernels/csd_spmm.py:_csd_spmm_fwd_quant
// (Pallas body _fwd_kernel_quant): y = act(sum_f (x[:, blk(block_idx[rb, f])]
// @ q[rb, f]) * s[rb, f] + b), with the slab q int8 (n_rb, d_in_b, bL, bR),
// one f32 scale s per (bL x bR) block (n_rb, d_in_b), each slot's partial
// sum in f32 scaled before it is accumulated, and the output in the dtype
// of x; and _csd_spmm_fwd_quant_batched (body _fwd_kernel_quant_batched),
// the same for E expert junctions over one shared block_idx: x (E, M,
// n_in), q (E, n_rb, d_in_b, bL, bR), s (E, n_rb, d_in_b), bias (E, n_rb *
// bR), y (E, M, n_rb * bR). The single junction is the case E = 1.
//
// What bounds it on the card: in decode (M = a handful of serving slots)
// the bytes of the int8 slab, streamed once: for gemma3-4b 13.1 MB per
// up/gate junction and 21.0 MB per down junction, 3.9 us and 6.3 us at
// 3.35 TB/s, half the bf16 slab's time; for the 32 experts of
// granite-moe-1b-a400m's MoE decode step 8.4 MB per up/gate call and 12.6
// MB per down call, 2.5 us and 3.8 us. In prefill (hundreds of rows) the
// products approach the tensor cores' rate.
//
// What the design does about it: three bodies; the caller's plan
// (launch.quant_body) picks one and passes it as `body`.
//
// 1. bf16 x with few rows per expert (every decode call, small prefill
//    chunks): csd_spmm_fwd_quant_stream_kernel, which streams the weights
//    once, in one launch. A CTA owns 128 output columns of one right block
//    of one expert, for all of the expert's rows (16, 32 or 64 as a
//    template), over its share of the fan-in slots.
//    - Copies: warp 0 keeps a ring of stages in flight, each one TMA load
//      of a 64 x 128-byte int8 weight box (128-byte swizzle) and one of
//      the 64 columns of x the slot gathers (rows past M read as zeros),
//      completing on the stage's full mbarrier; each of the four consumer
//      warps arrives once on its empty mbarrier when it has read it. No
//      CTA-wide barrier per stage, and the copying never stalls the
//      arithmetic (threads that issue cp.async do). (Eight consumer warps, each
//      column group's stage split over two k halves, ran slower: the
//      fatter CTAs fit two to an SM where these fit three, and fewer
//      clusters are resident at once.)
//    - Conversion in registers: a consumer thread reads four 32-bit words
//      of weights per 16-deep k step, rows 2t, 2t + 1, 2t + 8, 2t + 9 of
//      the columns 4g .. 4g + 3 of its warp's 32 (lane 4 g + t), and widens
//      them exactly (hopper::s8x2_to_bf16x2, after a byte permute): byte j
//      of the four words is the B fragment of mma.sync m16n8k16 j of the
//      warp, whose eight columns are 4 n + j (n < 8). The output columns
//      are so permuted inside each group of 32, and come back in order in
//      the epilogue: a thread's accumulators of the four products are
//      columns 8 t .. 8 t + 7 of rows g and g + 8, stored as 16 bytes. The
//      swizzle makes every such read conflict-free.
//    - Products: mma.sync m16n8k16 in bf16 with f32 accumulators, x as A
//      (up to 16 rows a product), the widened weights as B; each slot's
//      products go to a second accumulator, scaled by the slot's scale at
//      the slot's end and added to the running sum in slot order (the
//      scale is never folded into the weights: bf16(q * s) would round).
//    - Filling the card in one launch: where the column tiles alone are
//      too few (gemma3-4b's down junction has 20), the fan-in slots are
//      split over the CTAs of a thread-block cluster (up to 8, along
//      gridDim.x). Each rank leaves its f32 sums in its shared memory;
//      after a cluster barrier rank 0 adds the other ranks' sums in rank
//      order through distributed shared memory and runs the epilogue (bias,
//      activation, cast); a second barrier keeps the ranks' shared memory
//      alive until it has read. No partial buffer in device memory, no
//      second launch, no atomics: reruns are bit-identical.
// 2. bf16 x with more rows: csd_spmm_fwd_wgmma_kernel of
//    csd_spmm_fwd_wgmma.cuh instantiated for int8 weights (persistent
//    128 x 64 or 128 x 128 tiles on wgmma fed by TMA; the int8 tiles
//    widened into swizzled bf16 tiles by the consumers, a second
//    accumulator per slot), described there.
// 3. f32 x (not on a serving path): csd_spmm_fwd_quant_kernel, the grid
//    schedule of csd_spmm_fwd.cuh: one CTA per (BM x 64) output tile
//    looping over its fan-in slots in 32-deep steps through a cp.async
//    ring, the slots split over gridDim.z CTAs with an ordered f32 second
//    pass when the tiles alone are too few, four int8 weights converted to
//    f32 in registers per CUDA-core step, a second accumulator per slot.
#include "csd_spmm_common.cuh"
#include "csd_spmm_fwd_wgmma.cuh"
#include "hopper.cuh"

namespace {

using Bf16 = __nv_bfloat16;
using csd::cp_async16;
using csd::cp_async_commit;
using csd::cp_async_wait;
using csd::emit;

// ---------------------------------------------------------------------------
// body 1: the weight-streaming decode body
// ---------------------------------------------------------------------------

constexpr int kSThreads = 160;  // warp 0 copies; warps 1-4 multiply
constexpr int kSBN = 128;       // output columns per CTA (one TMA box row)
constexpr int kSBK = 64;        // fan-in rows per stage
constexpr int kMaxCluster = 8;  // the portable cluster size

// The stream body's shared memory: a ring of stages, each the x box (16 MT
// rows of 64 bf16, 128-byte swizzle) and the weight box (64 rows of 128
// int8, 128-byte swizzle), 1024-byte aligned; then the full and empty
// barriers. After the loop the ring holds each rank's f32 sums for the
// cluster's reduction (16 MT floats per consumer thread).
template <int MT>
struct StreamRing {
  static constexpr int X_BYTES = 16 * MT * 128;
  static constexpr int W_BYTES = kSBK * kSBN;
  static constexpr int STAGE = X_BYTES + W_BYTES;
  static constexpr int STAGES = MT == 4 ? 4 : 6;
  static constexpr int RED = 128 * 16 * MT * 4;
  static_assert(RED <= STAGES * STAGE, "the sums must fit in the ring");
  // + 1024 to align the ring, + the full and empty barriers
  static constexpr int SMEM = STAGES * STAGE + 1024 + 2 * STAGES * 8;
};

__device__ __forceinline__ uint32_t lds32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// CTA (rank, column tile, expert). MT: 16-row tiles of x (M <= 16 MT).
template <int MT>
__global__ void __launch_bounds__(kSThreads)
    csd_spmm_fwd_quant_stream_kernel(const __grid_constant__ CUtensorMap tm_x,
                                     const __grid_constant__ CUtensorMap tm_w,
                                     const float* __restrict__ scale,
                                     const int* __restrict__ idx,
                                     const Bf16* __restrict__ bias,
                                     Bf16* __restrict__ y, int M, int n_out,
                                     int d_in_b, int bL, int bR, int act) {
  using R = StreamRing<MT>;
  constexpr int S = R::STAGES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023) & ~1023u;
  const uint32_t bars = ring + S * R::STAGE;
  unsigned char* ring_p = smem_raw + (ring - raw);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (S + s); };

  const int cs = gridDim.x;  // the cluster: every CTA of one tile
  const int rank = blockIdx.x;
  const int col0 = blockIdx.y * kSBN;
  const int ex = blockIdx.z;
  const int rb = col0 / bR;
  const int n0 = col0 - rb * bR;  // column offset in the right block
  const int per = (d_in_b + cs - 1) / cs;
  const int f0 = rank * per;  // this rank's fan-in slots [f0, f0 + n_slots)
  const int n_slots = max(0, min(d_in_b - f0, per));
  const int steps_per_slot = bL / kSBK;
  const int n_steps = n_slots * steps_per_slot;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // the first slot's left block (the producer's) and the bias (rank 0's
  // consumers), read before the barriers are set up, so that their
  // latency is not paid on the way to the first copy and the epilogue
  const int cg = warp - 1;  // consumer warp: columns [32 cg, 32 cg + 32)
  const int g = lane / 4, tq = lane % 4;
  const int col = col0 + 32 * cg + 8 * tq;  // a consumer's 8 columns
  int lb = threadIdx.x == 0 && n_steps > 0
               ? __ldg(idx + rb * d_in_b + f0) : 0;
  float bv[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) bv[i] = 0.f;
  if (bias != nullptr && warp > 0 && rank == 0) {
    const uint4 b = *reinterpret_cast<const uint4*>(
        bias + static_cast<size_t>(ex) * n_out + col);
    const Bf16* be = reinterpret_cast<const Bf16*>(&b);
#pragma unroll
    for (int i = 0; i < 8; ++i) bv[i] = __bfloat162float(be[i]);
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 4);  // every consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // the consumers' sums: [tile mt][product j][fragment element]
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

  if (warp == 0) {
    if (lane == 0) {
      const size_t wrow0 =
          (static_cast<size_t>(rb) * d_in_b + f0) * static_cast<size_t>(bL);
      for (int t = 0; t < n_steps; ++t) {
        const int s = t % S;
        const int fl = t / steps_per_slot;
        const int k0 = (t - fl * steps_per_slot) * kSBK;
        if (k0 == 0 && fl > 0) lb = __ldg(idx + rb * d_in_b + f0 + fl);
        hopper::mbar_wait(empty(s), ((t / S) & 1) ^ 1);
        const uint32_t a = ring + s * R::STAGE;
        hopper::mbar_expect_tx(full(s), R::STAGE);
        hopper::tma_load_3d(a, &tm_x, full(s), lb * bL + k0, 0, ex);
        hopper::tma_load_3d(a + R::X_BYTES, &tm_w, full(s), n0,
                            static_cast<int>(wrow0 + fl * bL + k0), ex);
      }
    }
    __syncwarp();
  } else {
    const float* srow =
        scale + (static_cast<size_t>(ex) * (n_out / bR) + rb) * d_in_b + f0;
    // This thread's byte offsets in a stage's swizzled boxes, the same for
    // every stage (a row's chunk c sits at chunk c ^ (row % 8)). x: rows g
    // (+ 8, + 16 mt: the same swizzle), bytes 4 t of chunk c. Weights: rows
    // 2t and 2t + 1 (+ 8, + 16 k: the same swizzle), bytes 4 (g % 4) of
    // the chunk 2 cg + g / 4 that holds columns 32 cg + 4 g .. + 3.
    const int x_off = g * 128 + 4 * tq;
    int x_chunk[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) x_chunk[c] = (c ^ g) << 4;
    const int wc = 2 * cg + (g >> 2);
    int w_off[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = 2 * tq + r;
      w_off[r] = row * 128 + ((wc ^ row) << 4) + 4 * (g & 3);
    }
    float part[MT][4][4];
    float sc = 0.f;  // the slot's scale, read at its first step
    for (int t = 0; t < n_steps; ++t) {
      const int s = t % S;
      const int kstep = t % steps_per_slot;
      if (kstep == 0) {
        sc = __ldg(srow + t / steps_per_slot);  // used at the slot's end
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[mt][j][e] = 0.f;
      }
      hopper::mbar_wait(full(s), (t / S) & 1);
      const unsigned char* xs = ring_p + s * R::STAGE + x_off;
      const unsigned char* ws = ring_p + s * R::STAGE + R::X_BYTES;
#pragma unroll
      for (int ks = 0; ks < kSBK / 16; ++ks) {
        uint32_t a[MT][4];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {  // rows 16 mt + g and + 8
          const unsigned char* r0 = xs + 16 * mt * 128;
          a[mt][0] = lds32(r0 + x_chunk[2 * ks]);
          a[mt][1] = lds32(r0 + 8 * 128 + x_chunk[2 * ks]);
          a[mt][2] = lds32(r0 + x_chunk[2 * ks + 1]);
          a[mt][3] = lds32(r0 + 8 * 128 + x_chunk[2 * ks + 1]);
        }
        // rows 2t, 2t + 1, 2t + 8, 2t + 9 of this k step
        const unsigned char* wk = ws + 16 * ks * 128;
        const uint32_t w0 = lds32(wk + w_off[0]);
        const uint32_t w1 = lds32(wk + w_off[1]);
        const uint32_t w2 = lds32(wk + 8 * 128 + w_off[0]);
        const uint32_t w3 = lds32(wk + 8 * 128 + w_off[1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // byte j of the upper row's word to byte 0, of the lower's to 2
          const uint32_t sel = 0x1100u * (j + 4) + 0x11u * j;
          const uint32_t b0 = hopper::s8x2_to_bf16x2(__byte_perm(w0, w1, sel));
          const uint32_t b1 = hopper::s8x2_to_bf16x2(__byte_perm(w2, w3, sel));
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            hopper::mma_m16n8k16(part[mt][j], a[mt], b0, b1);
        }
      }
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty(s));  // the stage is read
      if (kstep == steps_per_slot - 1) {  // the slot's end: scale, add
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][j][e] += part[mt][j][e] * sc;
      }
    }
  }

  // The cluster's ranks add up: ranks 1.. leave their sums in their ring
  // (float4 i of consumer thread c at (i * 128 + c) * 16 bytes), rank 0
  // adds them in rank order.
  const int ct = threadIdx.x - 32;  // consumer thread, 0..127
  if (cs > 1) {
    __syncthreads();  // every stage read: the ring is free
    if (warp > 0 && rank > 0) {
      float4* red = reinterpret_cast<float4*>(ring_p);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          red[(4 * mt + j) * 128 + ct] = make_float4(
              acc[mt][j][0], acc[mt][j][1], acc[mt][j][2], acc[mt][j][3]);
    }
    hopper::cluster_sync();
    if (warp > 0 && rank == 0) {
      for (int r = 1; r < cs; ++r) {
        const uint32_t peer = hopper::map_to_rank(ring, r);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 v =
                hopper::ld_cluster_f4(peer + ((4 * mt + j) * 128 + ct) * 16);
            acc[mt][j][0] += v.x;
            acc[mt][j][1] += v.y;
            acc[mt][j][2] += v.z;
            acc[mt][j][3] += v.w;
          }
      }
    }
    hopper::cluster_sync();  // the ranks' sums stay until rank 0 has read
  }
  if (warp == 0 || rank > 0) return;

  // The epilogue, with csd::emit's arithmetic: rows g and g + 8 of each
  // 16-row tile, columns 8 t .. 8 t + 7 of the warp's 32 (product j holds
  // columns 4 n + j: fragment elements 0 and 2 are n = 2 t, 1 and 3 n =
  // 2 t + 1), stored as 16 bytes.
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 16 * mt + g + 8 * h;
      if (r >= M) continue;
      uint32_t o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float z0 = acc[mt][(2 * i) % 4][2 * h + (2 * i) / 4];
        float z1 = acc[mt][(2 * i + 1) % 4][2 * h + (2 * i + 1) / 4];
        z0 = csd::activate(z0 + bv[2 * i], act);
        z1 = csd::activate(z1 + bv[2 * i + 1], act);
        const __nv_bfloat162 p = __floats2bfloat162_rn(z0, z1);
        o[i] = *reinterpret_cast<const uint32_t*>(&p);
      }
      *reinterpret_cast<uint4*>(
          y + (static_cast<size_t>(ex) * M + r) * n_out + col) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
}

// The stream body's launch: (cluster, column tiles, experts) CTAs, each
// cluster the ranks of one tile.
template <int MT>
plan::Dims stream_dims(int E, int n_rb, int bR, int cluster) {
  plan::Dims d{dim3(cluster, n_rb * bR / kSBN, E), kSThreads,
               static_cast<size_t>(StreamRing<MT>::SMEM)};
  d.cluster = cluster;
  return d;
}

template <int MT>
int launch_stream(const void* x, const void* w, const float* scale,
                  const int* idx, const void* bias, void* y, int E, int M,
                  int n_in, int n_rb, int d_in_b, int bL, int bR,
                  int cluster, int act, cudaStream_t stream) {
  const plan::Dims d = stream_dims<MT>(E, n_rb, bR, cluster);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        csd_spmm_fwd_quant_stream_kernel<MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(d.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  CUtensorMap tm_x, tm_w;
  if (!hopper::encode_3d(&tm_x, x, n_in, M, E, 16 * MT) ||
      !hopper::encode_3d_s8(&tm_w, w, bR,
                            static_cast<uint64_t>(n_rb) * d_in_b * bL, E,
                            kSBN, kSBK))
    return hopper::kEncodeFailed;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = d.grid;
  cfg.blockDim = dim3(d.threads);
  cfg.dynamicSmemBytes = d.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(
      &cfg, csd_spmm_fwd_quant_stream_kernel<MT>, tm_x, tm_w, scale, idx,
      static_cast<const Bf16*>(bias), static_cast<Bf16*>(y), M, n_rb * bR,
      d_in_b, bL, bR, act);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// body 3: the f32 grid body
// ---------------------------------------------------------------------------

constexpr int kThreads = 128;
constexpr int kBN = 64;
constexpr int kQS = kBN + 16;  // padded int8 row stride, 16-byte rows

template <int BM>
struct QTile {
  static constexpr int BK = 32;
  static constexpr int EPC = 4;               // f32 elements per 16 bytes
  static constexpr int XS = BK + EPC;         // padded x row stride
  static constexpr int STAGES = BM == 16 ? 6 : 3;
  static constexpr int X_BYTES = BM * XS * 4;
  static constexpr int Q_BYTES = BK * kQS;
  static constexpr int SMEM = STAGES * (X_BYTES + Q_BYTES);
};

template <int BM>
__global__ void __launch_bounds__(kThreads)
    csd_spmm_fwd_quant_kernel(const float* __restrict__ x,
                              const int8_t* __restrict__ w,
                              const float* __restrict__ scale,
                              const int* __restrict__ idx,
                              const float* __restrict__ bias,
                              float* __restrict__ y,
                              float* __restrict__ partial, int E, int M,
                              int n_in, int d_in_b, int bL, int bR,
                              int n_out, int slots_per_split, int act) {
  using TL = QTile<BM>;
  constexpr int BK = TL::BK, EPC = TL::EPC, XS = TL::XS;
  constexpr int S = TL::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  int8_t* qs = reinterpret_cast<int8_t*>(smem + S * TL::X_BYTES);

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kBN;  // first output column of the tile
  const int rb = col0 / bR;
  const int n0 = col0 - rb * bR;  // column offset inside the right block
  const int m_tiles = (M + BM - 1) / BM;
  const int ex = blockIdx.y / m_tiles;  // this CTA's expert
  const int m0 = (blockIdx.y - ex * m_tiles) * BM;
  const int row0 = ex * M;  // the expert's first row of y and partial
  x += static_cast<size_t>(ex) * M * n_in;
  w += static_cast<size_t>(ex) * n_out * d_in_b * bL;
  scale += static_cast<size_t>(ex) * (n_out / bR) * d_in_b;
  if (bias != nullptr) bias += static_cast<size_t>(ex) * n_out;
  const int f0 = blockIdx.z * slots_per_split;  // this split's fan-in slots
  const int n_slots = min(d_in_b - f0, slots_per_split);
  const int steps_per_slot = bL / BK;
  const int n_steps = max(n_slots, 0) * steps_per_slot;

  auto load_stage = [&](int t) {
    if (t >= n_steps) return;
    const int stage = t % S;
    const int fl = t / steps_per_slot;
    const int f = f0 + fl;
    const int k0 = (t - fl * steps_per_slot) * BK;
    const int lb = __ldg(idx + rb * d_in_b + f);
    const float* xsrc = x + static_cast<size_t>(lb) * bL + k0;
    float* xdst = xs + stage * BM * XS;
    constexpr int XC = BK / EPC;  // chunks per x row
    for (int c = tid; c < BM * XC; c += kThreads) {
      const int r = c / XC, cc = c - r * XC;
      const int m = m0 + r;
      const bool ok = m < M;
      cp_async16(xdst + r * XS + cc * EPC,
                 xsrc + static_cast<size_t>(ok ? m : 0) * n_in + cc * EPC, ok);
    }
    const int8_t* qsrc =
        w + ((static_cast<size_t>(rb) * d_in_b + f) * bL + k0) * bR + n0;
    int8_t* qdst = qs + stage * BK * kQS;
    constexpr int QC = kBN / 16;  // 16-byte chunks per int8 row
    for (int c = tid; c < BK * QC; c += kThreads) {
      const int r = c / QC, cc = c - r * QC;
      cp_async16(qdst + r * kQS + cc * 16,
                 qsrc + static_cast<size_t>(r) * bR + cc * 16, true);
    }
  };

  for (int s = 0; s < S - 1; ++s) {
    load_stage(s);
    cp_async_commit();
  }

  // 16 threads across 64 columns (4 each), 8 across rows
  constexpr int TM = BM / 8;
  const int tx = tid % 16, ty = tid / 16;
  float acc[TM][4], part[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    cp_async_wait<S - 2>();
    __syncthreads();
    load_stage(t + S - 1);
    cp_async_commit();
    const int kstep = t % steps_per_slot;
    if (kstep == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) part[i][j] = 0.f;
    }
    const float* xt = xs + (t % S) * BM * XS;
    const int8_t* qt = qs + (t % S) * BK * kQS;
#pragma unroll 8
    for (int kk = 0; kk < BK; ++kk) {
      const uint32_t b4 =
          *reinterpret_cast<const uint32_t*>(qt + kk * kQS + tx * 4) ^
          0x80808080u;
      const float b0 = hopper::s8_to_f32(b4, 0), b1 = hopper::s8_to_f32(b4, 1);
      const float b2 = hopper::s8_to_f32(b4, 2), b3 = hopper::s8_to_f32(b4, 3);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float a = xt[(ty * TM + i) * XS + kk];
        part[i][0] = fmaf(a, b0, part[i][0]);
        part[i][1] = fmaf(a, b1, part[i][1]);
        part[i][2] = fmaf(a, b2, part[i][2]);
        part[i][3] = fmaf(a, b3, part[i][3]);
      }
    }
    if (kstep == steps_per_slot - 1) {
      const float s = __ldg(scale + rb * d_in_b + f0 + t / steps_per_slot);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += part[i][j] * s;
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      emit(acc[i][j], row0 + m, col0 + tx * 4 + j, E * M, n_out, bias, y,
           static_cast<float*>(nullptr), partial, act);
  }
}

template <int BM>
plan::Dims split_dims(int E, int M, int n_rb, int bR, int n_splits) {
  return {dim3(n_rb * bR / kBN, E * ((M + BM - 1) / BM), n_splits), kThreads,
          static_cast<size_t>(QTile<BM>::SMEM)};
}

template <int BM>
int launch_grid(const void* x, const void* w, const float* scale,
                const int* idx, const void* bias, void* y, float* partial,
                int E, int M, int n_in, int n_rb, int d_in_b, int bL, int bR,
                int n_splits, int act, cudaStream_t stream) {
  const plan::Dims d = split_dims<BM>(E, M, n_rb, bR, n_splits);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        csd_spmm_fwd_quant_kernel<BM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(d.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int n_out = n_rb * bR;
  const int per_split = (d_in_b + n_splits - 1) / n_splits;
  csd_spmm_fwd_quant_kernel<BM><<<d.grid, d.threads, d.smem, stream>>>(
      static_cast<const float*>(x), static_cast<const int8_t*>(w), scale,
      idx, static_cast<const float*>(bias), static_cast<float*>(y),
      n_splits > 1 ? partial : nullptr, E, M, n_in, d_in_b, bL, bR, n_out,
      per_split, act);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return static_cast<int>(e);
  const plan::Dims r = csd::reduce_dims(static_cast<size_t>(E) * M * n_out);
  csd::reduce_splits_kernel<float><<<r.grid, r.threads, r.smem, stream>>>(
      partial, static_cast<const float*>(bias), static_cast<float*>(y),
      static_cast<float*>(nullptr), E, M, n_out, n_splits, act);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
int grid_plan(int E, int M, int n_rb, int bR, int n_splits, int* out) {
  plan::put(out, 0, split_dims<BM>(E, M, n_rb, bR, n_splits));
  if (n_splits == 1) return 1;
  plan::put(out, 1, csd::reduce_dims(static_cast<size_t>(E) * M * n_rb * bR));
  return 2;
}

// ---------------------------------------------------------------------------
// which body
// ---------------------------------------------------------------------------

// body: 0 the f32 grid body, 1 the stream body, 2 the wgmma body.
enum Body { kGrid = 0, kStream = 1, kWgmma = 2 };

// Whether the arguments name a body the kernels have: the grid body in
// f32 (n_splits >= 1); in bf16 the stream body (tile_n 128 dividing bR,
// tile_m 16/32/64 holding M, a cluster of 1-8 CTAs no larger than d_in_b)
// or the wgmma body (tile_n 64 or 128 dividing bR); those two unsplit.
bool body_taken(int body, int dtype, int M, int d_in_b, int bR, int n_splits,
                int tile_m, int tile_n, int cluster) {
  if (body == kGrid) return dtype == 0 && n_splits >= 1;
  if (dtype != 1 || n_splits != 1) return false;
  if (body == kStream)
    return tile_n == kSBN && bR % kSBN == 0 &&
           (tile_m == 16 || tile_m == 32 || tile_m == 64) && M <= tile_m &&
           cluster >= 1 && cluster <= kMaxCluster && cluster <= d_in_b;
  return body == kWgmma && (tile_n == 64 || tile_n == 128) &&
         bR % tile_n == 0;
}

}  // namespace

// E expert junctions of M rows each over one shared pattern idx (n_rb,
// d_in_b); E = 1 is the single junction. x (E, M, n_in), bias (E, n_rb *
// bR) or null and y (E, M, n_rb * bR): dtype 0 float32, 1 bfloat16. w: int8
// (E, n_rb, d_in_b, bL, bR); w_scale: float32 (E, n_rb, d_in_b). act: 0
// none, 1 relu, 2 gelu (tanh). body (launch.quant_body's choice): 0 the
// f32 grid body, with n_splits CTAs sharing one output tile's fan-in
// slots (1 = no second pass; every split must own at least one slot, and
// `partial` must then hold n_splits * E * M * n_rb * bR floats); 1 the
// bf16 stream body, tile_m rows (16, 32 or 64, at least M) by tile_n (128)
// columns a CTA, the fan-in split over a cluster of `cluster` CTAs; 2 the
// bf16 wgmma body, persistent on n_sm SMs, 128 x tile_n (64 or 128) tiles.
// Preconditions (checked by the Python wrapper): contiguous tensors on one
// device, 16-byte aligned, bL % 64 == 0, bR % 64 == 0, M >= 1, E >= 1, and
// for the grid body E * ceil(M / BM) <= 65535 (BM = 16 for M <= 16, else
// 64). Returns cudaGetLastError() after the launches, 10001 if the driver
// refused a tensor map, or cudaErrorInvalidValue for arguments the kernels
// do not take.
extern "C" int csd_spmm_fwd_quant(const void* x, const void* w,
                                  const float* w_scale, const int* idx,
                                  const void* bias, void* y, float* partial,
                                  int E, int M, int n_in, int n_rb,
                                  int d_in_b, int bL, int bR, int n_splits,
                                  int n_sm, int body, int tile_m, int tile_n,
                                  int cluster, int dtype, int act,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!body_taken(body, dtype, M, d_in_b, bR, n_splits, tile_m, tile_n,
                  cluster))
    return static_cast<int>(cudaErrorInvalidValue);
  if (body == kStream) {
    if (tile_m == 16)
      return launch_stream<1>(x, w, w_scale, idx, bias, y, E, M, n_in, n_rb,
                              d_in_b, bL, bR, cluster, act, s);
    if (tile_m == 32)
      return launch_stream<2>(x, w, w_scale, idx, bias, y, E, M, n_in, n_rb,
                              d_in_b, bL, bR, cluster, act, s);
    return launch_stream<4>(x, w, w_scale, idx, bias, y, E, M, n_in, n_rb,
                            d_in_b, bL, bR, cluster, act, s);
  }
  if (body == kWgmma) {
    if (tile_n == 128)
      return fwd_wgmma::launch_wgmma_act<int8_t, 128>(
          x, w, w_scale, idx, bias, y, nullptr, E, M, n_in, n_rb, d_in_b,
          bL, bR, n_sm, act, s);
    return fwd_wgmma::launch_wgmma_act<int8_t, 64>(
        x, w, w_scale, idx, bias, y, nullptr, E, M, n_in, n_rb, d_in_b, bL,
        bR, n_sm, act, s);
  }
  return M <= 16 ? launch_grid<16>(x, w, w_scale, idx, bias, y, partial, E,
                                   M, n_in, n_rb, d_in_b, bL, bR, n_splits,
                                   act, s)
                 : launch_grid<64>(x, w, w_scale, idx, bias, y, partial, E,
                                   M, n_in, n_rb, d_in_b, bL, bR, n_splits,
                                   act, s);
}

// The launches csd_spmm_fwd_quant makes for these arguments, from the host
// code it launches with: six ints each (grid x, y, z, threads, dynamic
// shared memory bytes, cluster) written to out (room for 2). Returns the
// launch count, or -1 for arguments csd_spmm_fwd_quant refuses.
extern "C" int csd_spmm_fwd_quant_plan(int E, int M, int n_rb, int d_in_b,
                                       int bR, int n_splits, int n_sm,
                                       int body, int tile_m, int tile_n,
                                       int cluster, int dtype, int* out) {
  if (!body_taken(body, dtype, M, d_in_b, bR, n_splits, tile_m, tile_n,
                  cluster))
    return -1;
  if (body == kStream) {
    plan::put(out, 0,
              tile_m == 16   ? stream_dims<1>(E, n_rb, bR, cluster)
              : tile_m == 32 ? stream_dims<2>(E, n_rb, bR, cluster)
                             : stream_dims<4>(E, n_rb, bR, cluster));
    return 1;
  }
  if (body == kWgmma) {
    plan::put(out, 0,
              fwd_wgmma::wgmma_dims<int8_t>(E, M, n_rb, bR, tile_n, n_sm));
    return 1;
  }
  return M <= 16 ? grid_plan<16>(E, M, n_rb, bR, n_splits, out)
                 : grid_plan<64>(E, M, n_rb, bR, n_splits, out);
}
