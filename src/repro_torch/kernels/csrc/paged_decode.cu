// paged_decode_attention — one grouped query token over a paged KV cache,
// for Hopper (sm_90a); its pages full width or int8.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:
// paged_decode_attention (Pallas wrapper _paged_decode_pallas, body
// _paged_decode_kernel with quant=False, and with quant=True for int8
// pages with per-token f32 scales): for every (row b, kv head h) the
// G query heads of the group attend to the keys kpos < lengths[b] (and,
// with a window, kpos > lengths[b] - 1 - window) that the row's page table
// maps, with an optional tanh softcap, online softmax in f32, and an empty
// row giving 0.
//
// What bounds it on the card. The arithmetic is about 4 G Dh operations
// per key, far below the ridge point, so the floor is bytes: the K and V
// rows of the visible keys (with int8 pages 8 bytes of scales per key).
// At serving lengths (a few hundred keys a row) that floor is well under a
// microsecond and what the kernel pays is latency: the launch, the chain
// lengths -> page table -> K/V, and each CTA's serial work. At long
// context (thousands of keys a row) it is bytes, and every SM must keep
// enough of them in flight.
//
// What the design does about it:
// - Copies that never stall the arithmetic. A ring of up to 4 stages of
//   K and V tiles (and the int8 scales) in shared memory, each tile whole
//   pages, ~16 KB of K. Warp 0 fills it with one TMA load per mapped page
//   of K and of V (a 4-D tensor map over (Dh, Hkv, page, P), box (Dh, 1,
//   page, 1); the scales with one bulk load each), completing on the
//   stage's full mbarrier; every warp arrives on the stage's empty
//   mbarrier once it has read it. There is no CTA-wide barrier per tile.
//   TMA, because threads that issue cp.async stall once the SM's memory
//   requests are full: from the computing threads that serialises copies
//   and arithmetic, and one copying warp cannot issue fast enough. Pages
//   that are not whole multiples of 8 keys take cp.async from warp 0. The
//   page-table entries of the CTA's range are read once, with q and the
//   row length, before the first copy; a -1 entry is never dereferenced
//   (its rows are masked by a key-visible byte warp 0 writes per row), and
//   pages wholly outside [len - window, len) are never copied.
// - Registers sized to the shape. The split kernel is a template on the
//   group size (G 1, 2, 4, 8; a group of 7 runs the 8 form with its last
//   row masked) and on a head-dim bucket (64, 128, 256): a lane holds 8
//   head dims of the output (and of q, except at bucket 64 and G 8, where
//   q is read from shared memory) for each head.
// - Large groups on tensor cores (paged_decode_mma_kernel). From G0 = 5
//   to 48 query heads a KV head (qwen2-7b's 7, granite-34b's 48), bf16 q
//   over bf16 or int8 pages, the scores are a (G x Dh) . (Dh x keys)
//   product: the group's query rows are the rows of mma.sync m16n8k16
//   tiles (ceil(G / 16) row tiles, the rows past G zero), K and V come
//   from the ring by ldmatrix in TMA's 128-byte swizzle, and one CTA per
//   (split, KV head, row) reads each mapped page of its range once. The
//   CUDA-core form below keeps the groups of 1, 2 and 4 (below SDPA on
//   the card already) and f32 (whose 2e-5 gate bf16 rounding of q or P
//   would break). mma_rule is the rule, launch.paged_form its mirror.
// - Groups above 8 on the CUDA-core form (f32, or a forced form). The
//   grid's y coordinate runs over (KV head, chunk of 8 query heads), and
//   each CTA runs the 8 form on heads [8c, 8c + 8) of its group, the last
//   chunk masked as a group of 7 is. A CTA reads its KV head's pages
//   itself, so the pages are read ceil(G / 8) times, the later reads mostly
//   from L2; the split outputs and the merge index the whole group.
// - Several keys per warp at small Dh. A key takes bucket / 8 lanes (8 at
//   Dh 64, 16 at 128, 32 at 256), so a warp step covers 32 / (bucket / 8)
//   keys, and each dot product is reduced by log2(bucket / 8) shuffles
//   inside its segment of lanes.
// - Softmax per tile, not per key. A tile is one chunk of every warp's
//   key slots (4 slots, 2 from G 4 up): a warp scores its chunk's keys for
//   the G heads, takes one max per head over them and rescales its running
//   output once, then accumulates P.V with each lane owning its head dims.
//   The lane segments' partial sums are added once, at the end.
// - Splits and the merge. launch.split_plan picks the pages per split:
//   one launch, with the epilogue in the kernel, where a row's table is
//   short (the merge launch would cost more on the card and on the host
//   than it saves); contiguous page ranges over gridDim.x CTAs, about two
//   CTAs per SM, where splitting pays. Each split CTA then writes its
//   unnormalised output with its running max and sum, and the merge
//   kernel, one output element a thread, combines the splits in split
//   order with each split's weight and the sum computed once per (row,
//   head). No atomics: a result repeats bit for bit.
//
// Scores are kept in the log2 domain (the CUDA-core form scales q by
// log2(e), the tensor-core form its f32 scores; under a softcap the
// softcapped logit is), so the softmax uses exp2f. Int8 pages: each value
// is float(q8) exactly (a byte permute and an add, not the slower
// conversion instruction), and the reference's dequantization
// float(q8) * scale[token] is folded out of the sums: a key's scale
// multiplies its score, a value's scale its probability (equal up to f32
// rounding, and in the tensor-core form up to P's rounding to bf16).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "plan.cuh"

namespace {

using hopper::bulk_load;
using hopper::fence_barrier_init;
using hopper::mbar_arrive;
using hopper::mbar_arrive_cp_async;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::smem_addr;
using hopper::tma_load_4d;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxStages = 4;     // K/V tiles in the ring
constexpr int kRingBytes = 98304;  // its shared memory at most
constexpr int kMaxG = 8;
constexpr int kMergeChunk = 256;  // x kMaxG: split weights the merge stages
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* out) { *out = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

// A lane's 8 head dims of a K/V row in shared memory, as f32: the first n
// of them (0, 4 or 8; f32 rows may end half way), the rest 0.
template <typename PT>
struct Row8;
template <>
struct Row8<float> {
  __device__ static void load(const float* p, int n, float* out) {
    const float4 a = n >= 4 ? *reinterpret_cast<const float4*>(p)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 b = n >= 8 ? *reinterpret_cast<const float4*>(p + 4)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
    out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
  }
};
template <>
struct Row8<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, int n, float* out) {
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n > 0) v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
  }
};
// int8 -> f32 exactly without the conversion unit (hopper::s8_to_f32).
template <>
struct Row8<int8_t> {
  __device__ static void load(const int8_t* p, int n, float* out) {
    uint2 v = make_uint2(0u, 0u);
    if (n > 0) v = *reinterpret_cast<const uint2*>(p);
    const uint32_t w[2] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = hopper::s8_to_f32(w[i / 4], i % 4);
  }
};

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ constexpr int round128(int n) {
  return (n + 127) / 128 * 128;
}

// The head-dim bucket of a Dh: the register form the split kernel runs.
__host__ __device__ constexpr int bucket(int Dh) {
  return Dh <= 64 ? 64 : Dh <= 128 ? 128 : 256;
}

// Byte offsets of the split kernel's dynamic shared memory: the ring of
// `stages` stages (each a K tile, a V tile and, for int8 pages, their KT
// K and V scales; 128-byte aligned for TMA) at 0, reused after the loop
// for the warps' partial outputs, maxima, sums and merge weights; then the
// scaled q (G rows of the Dh bucket, zero past Dh), the stages' full and
// empty mbarriers, each stage's KT key-visible bytes, and the CTA's
// page-table entries (pps ints).
struct Layout {
  int kv;      // one K (or V) tile
  int stage;   // one ring stage
  int stages;  // stages in the ring: kMaxStages within kRingBytes, >= 1
  int q;       // the scaled q
  int bar;     // the mbarriers
  int ok;      // the key-visible bytes
  int pid;     // the page ids
  int total;
};

template <typename PT>
__host__ __device__ inline Layout layout(int G, int Dh, int KT, int pps) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  Layout y;
  y.kv = KT * Dh * static_cast<int>(sizeof(PT));
  y.stage = round128(2 * y.kv + (kQuant ? 8 * KT : 0));
  const int fit = kRingBytes / y.stage;
  y.stages = fit < 1 ? 1 : fit > kMaxStages ? kMaxStages : fit;
  const int ring = y.stages * y.stage;
  const int merge = 4 * (kWarps * G * Dh + kWarps * G * 2 + G * kWarps +
                         2 * G);
  y.q = round16(ring > merge ? ring : merge);
  y.bar = y.q + 4 * G * bucket(Dh);
  y.ok = y.bar + 16 * kMaxStages;
  y.pid = round16(y.ok + kMaxStages * KT);
  y.total = y.pid + 4 * pps;
  return y;
}

// Registers bound the CTAs an SM holds: 2 at 128 registers a thread (as
// many as the ring lets share an SM); f32 pages and the 8-head form take
// what they need.
template <typename PT, int G>
constexpr int min_ctas() {
  return G <= 4 && !std::is_same<PT, float>::value ? 2 : 1;
}

// Warp slots a warp scores per softmax chunk: a tile (from
// launch.paged_tile) is one chunk of every warp.
template <int G>
__host__ __device__ constexpr int chunk_slots() {
  return G <= 2 ? 4 : 2;
}

// CTA (split, h * n_chunks + c, b): heads [8c, 8c + Gr) of KV head h's
// group of G (n_chunks = ceil(G / 8); for G <= 8 one chunk, c = 0 and
// Gr = G). GF is the group-size form (Gr <= GF), DHB the head-dim bucket
// (Dh <= DHB). Warp 0 also fills the ring:
// before it scores tile t it waits for stage (t - 1) % S to be read, then
// copies tile t + S - 1 there with one TMA load per mapped page of K and
// of V (the int8 scales with one bulk load each) that completes on the
// stage's full barrier. Pages that are not whole multiples of 8 keys
// (their TMA boxes would not be 128-byte aligned) are copied with cp.async
// instead (`tma` false).
template <typename T, typename PT, int GF, int DHB>
__global__ void __launch_bounds__(kThreads, (min_ctas<PT, GF>()))
    paged_decode_kernel(const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const T* __restrict__ q,
                        const PT* __restrict__ k_pages,
                        const PT* __restrict__ v_pages,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ table,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        float* __restrict__ part_o, float* __restrict__ part_ml,
                        int Hkv, int G, int Dh, int page_size, int n_pages,
                        int KT, int pps, int window, float softcap,
                        float scale, bool tma) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int L = DHB / 8;     // lanes per key
  constexpr int KPW = 32 / L;    // keys per warp step
  constexpr int KC = chunk_slots<GF>();
  constexpr int EPV = 16 / static_cast<int>(sizeof(PT));  // per 16 B copy
  // q's 8 dims per head in registers, or read from shared memory per key:
  // at bucket 64, where the lane segments read the same q rows, and for 8
  // heads, whose q would not fit beside the output
  constexpr bool kQRegs = DHB > 64 && GF <= 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_chunks = (G + kMaxG - 1) / kMaxG;
  const int h = blockIdx.y / n_chunks, g0 = (blockIdx.y % n_chunks) * kMaxG;
  const int Gr = min(kMaxG, G - g0);  // the chunk's heads
  const Layout lay = layout<PT>(min(G, kMaxG), Dh, KT, pps);
  const int S = lay.stages;
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  unsigned char* ok_s = smem + lay.ok;
  int* pid_s = reinterpret_cast<int*>(smem + lay.pid);
  const uint32_t full0 = smem_addr(smem + lay.bar);
  const uint32_t empty0 = full0 + 8 * kMaxStages;

  const int split = blockIdx.x, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t bh = static_cast<size_t>(b) * Hkv + h;

  // the barriers; the CTA's page-table entries, q (scaled) and the row
  // length, all requested before any is waited on
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, tma ? 1 : 33);  // cp.async: 32 lanes + 1
      mbar_init(empty0 + 8 * s, kWarps);
    }
    fence_barrier_init();
  }
  const int t0 = split * pps;
  const int n_tab = min(pps, n_pages - t0);
  for (int i = tid; i < n_tab; i += kThreads)
    pid_s[i] = table[static_cast<size_t>(b) * n_pages + t0 + i];
  const float qscale = softcap > 0.f ? scale : scale * kLog2e;
  for (int e = tid; e < Gr * DHB; e += kThreads) {
    const int g = e / DHB, d = e - g * DHB;
    q_s[e] = d < Dh ? to_f32(q[(bh * G + g0 + g) * Dh + d]) * qscale : 0.f;
  }
  const int len = lengths[b];
  __syncthreads();

  const int lo = window >= 0 ? max(0, len - window) : 0;  // first visible
  const int hi = len;                                      // one past last
  const int p_row_end =
      hi > 0 ? min(n_pages, (hi + page_size - 1) / page_size) : 0;
  const int p_first = max(lo / page_size, t0);
  const int p_end = min(p_row_end, t0 + n_tab);
  const int tile_pages = KT / page_size;
  const int n_tiles =
      p_end > p_first ? (p_end - p_first + tile_pages - 1) / tile_pages : 0;

  // warp 0: tile u into stage u % S, once the stage's previous tile is read
  const int rb = Dh * static_cast<int>(sizeof(PT));  // bytes of a row
  auto fill = [&](int u) {
    if (u >= n_tiles) return;
    const int st = u % S;
    mbar_wait(empty0 + 8 * st, ((u / S) & 1) ^ 1);
    unsigned char* base = smem + st * lay.stage;
    float* sc = reinterpret_cast<float*>(base + 2 * lay.kv);
    const uint32_t full = full0 + 8 * st;
    const int p0 = p_first + u * tile_pages;
    for (int r = lane; r < KT; r += 32) {
      const int p = p0 + r / page_size;
      const int kpos = p0 * page_size + r;
      ok_s[st * KT + r] = p < p_end && pid_s[p - t0] >= 0 && kpos >= lo &&
                          kpos < hi;
    }
    if (tma) {
      // lane i: page i of the tile
      const int p = p0 + lane;
      const int pid = lane < tile_pages && p < p_end ? pid_s[p - t0] : -1;
      const int n = __popc(__ballot_sync(kFull, pid >= 0));
      const int page_bytes = page_size * rb;
      __syncwarp();
      if (lane == 0)
        mbar_expect_tx(full, n * (2 * page_bytes + (kQuant ? 8 * page_size
                                                           : 0)));
      __syncwarp();
      if (pid >= 0) {
        tma_load_4d(smem_addr(base + lane * page_bytes), &tm_k, full, 0, h,
                    0, pid);
        tma_load_4d(smem_addr(base + lay.kv + lane * page_bytes), &tm_v,
                    full, 0, h, 0, pid);
        if constexpr (kQuant) {
          const size_t tok = static_cast<size_t>(pid) * page_size;
          bulk_load(smem_addr(sc + lane * page_size), k_scale + tok,
                    4 * page_size, full);
          bulk_load(smem_addr(sc + KT + lane * page_size), v_scale + tok,
                    4 * page_size, full);
        }
      }
    } else {
      // lane i: 16-byte chunk i % cpr of rows i / cpr, + rpp, ..., and
      // chunks i + 32, ... of rows wider than 32 chunks
      const int cpr = rb / 16;
      const int rpp = cpr < 32 ? 32 / cpr : 1;
      const int r0 = cpr < 32 ? lane / cpr : 0;
      const int cc0 = cpr < 32 ? lane - r0 * cpr : lane;
      for (int r = r0; r0 < rpp && r < KT; r += rpp) {
        const int pi = r / page_size, j = r - pi * page_size;
        const int p = p0 + pi;
        const int pid = p < p_end ? pid_s[p - t0] : -1;
        if (pid < 0) continue;
        const size_t tok = static_cast<size_t>(pid) * page_size + j;
        const size_t off = (tok * Hkv + h) * Dh;
        for (int cc = cc0; cc < cpr; cc += 32) {
          cp_async16(base + r * rb + cc * 16, k_pages + off + cc * EPV);
          cp_async16(base + lay.kv + r * rb + cc * 16,
                     v_pages + off + cc * EPV);
        }
      }
      if constexpr (kQuant) {
        for (int r = lane; r < KT; r += 32) {
          const int pi = r / page_size, j = r - pi * page_size;
          const int p = p0 + pi;
          const int pid = p < p_end ? pid_s[p - t0] : -1;
          if (pid < 0) continue;
          const size_t tok = static_cast<size_t>(pid) * page_size + j;
          cp_async4(sc + r, k_scale + tok);
          cp_async4(sc + KT + r, v_scale + tok);
        }
      }
      mbar_arrive_cp_async(full);
      __syncwarp();
      if (lane == 0) mbar_arrive(full);
    }
  };
  if (warp == 0)
    for (int u = 0; u < S - 1; ++u) fill(u);

  // the lane's head dims [d0, d0 + nd) of q and of the output, per head
  const int grp = lane / L, sub = lane % L;  // key of the step, dim chunk
  const int d0 = 8 * sub;
  const int nd = min(8, max(0, Dh - d0));
  float qr[kQRegs ? GF : 1][8], acc[GF][8], m[GF], l[GF];
#pragma unroll
  for (int g = 0; g < GF; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      acc[g][e] = 0.f;
      if constexpr (kQRegs) qr[g][e] = g < Gr ? q_s[g * DHB + d0 + e] : 0.f;
    }
  }

  // warp w takes the slots w, w + kWarps, ... of a tile; slot j is the
  // keys j KPW + grp
  const int n_slots = (KT + KPW - 1) / KPW;
  const int my_slots =
      n_slots > warp ? (n_slots - warp + kWarps - 1) / kWarps : 0;

  for (int t = 0; t < n_tiles; ++t) {
    if (warp == 0) fill(t + S - 1);
    const int st = t % S;
    mbar_wait(full0 + 8 * st, (t / S) & 1);
    const unsigned char* base = smem + st * lay.stage;
    const PT* k_s = reinterpret_cast<const PT*>(base);
    const PT* v_s = reinterpret_cast<const PT*>(base + lay.kv);
    const float* sc = reinterpret_cast<const float*>(base + 2 * lay.kv);
    const unsigned char* ok_t = ok_s + st * KT;

    for (int i0 = 0; i0 < my_slots; i0 += KC) {
      // scores of the chunk's keys for the GF heads
      float s[KC][GF];
      int row[KC];
      bool ok[KC];
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int r = (warp + kWarps * (i0 + k)) * KPW + grp;
        ok[k] = i0 + k < my_slots && r < KT && ok_t[r];
        row[k] = ok[k] ? r : 0;
        float kf[8];
        Row8<PT>::load(k_s + row[k] * Dh + d0, ok[k] ? nd : 0, kf);
#pragma unroll
        for (int g = 0; g < GF; ++g) {
          float qg[8];
          if constexpr (kQRegs) {
#pragma unroll
            for (int e = 0; e < 8; ++e) qg[e] = qr[g][e];
          } else {
            Row8<float>::load(q_s + g * DHB + d0, g < Gr ? 8 : 0, qg);
          }
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qg[e], kf[e], dot);
          s[k][g] = dot;
        }
      }
      // int8 pages: each key's K scale applied once to its score
      if constexpr (kQuant) {
#pragma unroll
        for (int k = 0; k < KC; ++k)
#pragma unroll
          for (int g = 0; g < GF; ++g) s[k][g] *= sc[row[k]];
      }
#pragma unroll
      for (int o = 1; o < L; o <<= 1)
#pragma unroll
        for (int k = 0; k < KC; ++k)
#pragma unroll
          for (int g = 0; g < GF; ++g)
            s[k][g] += __shfl_xor_sync(kFull, s[k][g], o);
#pragma unroll
      for (int k = 0; k < KC; ++k)
#pragma unroll
        for (int g = 0; g < GF; ++g) {
          float v = s[k][g];
          if (softcap > 0.f) v = softcap * tanhf(v / softcap) * kLog2e;
          s[k][g] = ok[k] ? v : kNegInf;
        }

      // one max per head over the chunk and the warp's lane segments,
      // one rescale of the running output; s becomes the probabilities
#pragma unroll
      for (int g = 0; g < GF; ++g) {
        float cm = s[0][g];
#pragma unroll
        for (int k = 1; k < KC; ++k) cm = fmaxf(cm, s[k][g]);
#pragma unroll
        for (int o = L; o < 32; o <<= 1)
          cm = fmaxf(cm, __shfl_xor_sync(kFull, cm, o));
        const float m_new = fmaxf(m[g], cm);
        if (m_new > kNegInf / 2) {  // warp-uniform
          const float corr = exp2f(m[g] - m_new);
          l[g] *= corr;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] *= corr;
          m[g] = m_new;
        }
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          s[k][g] = ok[k] ? exp2f(s[k][g] - m_new) : 0.f;
          l[g] += s[k][g];
        }
      }

      // P.V: each lane its own head dims of its segment's keys (int8
      // pages: each key's V scale applied once to its probabilities)
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (!ok[k]) continue;
        float vf[8];
        Row8<PT>::load(v_s + row[k] * Dh + d0, nd, vf);
        const float vs = kQuant ? sc[KT + row[k]] : 1.f;
#pragma unroll
        for (int g = 0; g < GF; ++g) {
          const float pv = s[k][g] * vs;
#pragma unroll
          for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pv, vf[e], acc[g][e]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);  // the stage is read
  }
  __syncthreads();  // every tile is read: the ring is free for the states

  // add the lane segments' partial sums (all share the warp's max)
#pragma unroll
  for (int o = L; o < 32; o <<= 1)
#pragma unroll
    for (int g = 0; g < GF; ++g) {
      l[g] += __shfl_xor_sync(kFull, l[g], o);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        acc[g][e] += __shfl_xor_sync(kFull, acc[g][e], o);
    }

  // merge the warps: o = sum_w 2^(m_w - M) acc_w, over
  // sum_w 2^(m_w - M) l_w, M the largest m_w
  float* wacc = reinterpret_cast<float*>(smem);  // [warp][g][Dh]
  float* wml = wacc + kWarps * Gr * Dh;          // [warp][g][m, l]
  float* wf = wml + kWarps * Gr * 2;             // [g][warp] weights
  float* wsum = wf + Gr * kWarps;                // [g][M, sum]
#pragma unroll
  for (int g = 0; g < GF; ++g) {
    if (g >= Gr) break;
    if (grp == 0)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < nd) wacc[(warp * Gr + g) * Dh + d0 + e] = acc[g][e];
    if (lane == 0) {
      wml[2 * (warp * Gr + g)] = m[g];
      wml[2 * (warp * Gr + g) + 1] = l[g];
    }
  }
  __syncthreads();
  if (tid < Gr) {
    const int g = tid;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wml[2 * (w * Gr + g)]);
    float lsum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wml[2 * (w * Gr + g)];
      const float f = mw > kNegInf / 2 ? exp2f(mw - mx) : 0.f;
      wf[g * kWarps + w] = f;
      lsum += f * wml[2 * (w * Gr + g) + 1];
    }
    wsum[2 * g] = mx;
    wsum[2 * g + 1] = lsum;
  }
  __syncthreads();
  for (int e = tid; e < Gr * Dh; e += kThreads) {
    const int g = e / Dh, d = e - g * Dh;
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      o = fmaf(wf[g * kWarps + w], wacc[(w * Gr + g) * Dh + d], o);
    const float lsum = wsum[2 * g + 1];
    if (n_splits > 1) {
      const size_t prow = (bh * n_splits + split) * G + g0 + g;
      part_o[prow * Dh + d] = o;
      if (d == 0) {
        part_ml[2 * prow] = wsum[2 * g];
        part_ml[2 * prow + 1] = lsum;
      }
    } else {
      store(o / (lsum == 0.f ? 1.f : lsum),
            out + (bh * G + g0) * Dh + e);
    }
  }
}

// ---------------------------------------------------------------------------
// The tensor-core form: groups of G0 = 5 to 48 query heads, bf16 q over bf16
// or int8 pages (launch.paged_form mirrors mma_rule)
// ---------------------------------------------------------------------------

constexpr int kMmaMinG = 5;            // G0
constexpr int kMmaMaxMT = 3;           // row tiles of 16 query heads
constexpr int kMmaTileKeys = 64;       // keys a tile, at least
constexpr int kMmaStageBytes = 65536;  // K and V of a tile at most (the rule)
constexpr int kMmaRingBytes = 98304;   // the ring, at least 2 stages

__host__ __device__ constexpr int round1024(int n) {
  return (n + 1023) / 1024 * 1024;
}
// Warps of the form: MT row tiles x DS slices of the output's head dims
// (2 from Dh 256, so that a warp holds at most 128 dims of output) x KS
// key slices (4, or 2 where MT x DS > 3).
__host__ __device__ constexpr int mma_ds(int Dh) { return Dh > 128 ? 2 : 1; }
__host__ __device__ constexpr int mma_ks(int mt, int ds) {
  return mt * ds <= 3 ? 4 : 2;
}
__host__ __device__ constexpr int mma_warps(int mt, int ds) {
  return mt * ds * mma_ks(mt, ds);
}
inline bool mma_dh(int Dh, bool quant) {  // whole 128-byte rows of K and V
  return Dh == 128 || Dh == 256 || (Dh == 64 && !quant);
}
// Keys a tile: kMmaTileKeys rounded up to whole pages and 16-key chunks.
inline int mma_tile(int page_size) {
  int a = 16, b = page_size;
  while (b != 0) {
    const int r = a % b;
    a = b;
    b = r;
  }
  const int l = 16 / a * page_size;  // lcm(16, page_size)
  return (kMmaTileKeys + l - 1) / l * l;
}
// The form rule: bf16 q (dtype 1) over bf16 or int8 pages, G0 <= G <= 48,
// whole 128-byte rows, and a tile of K and V within kMmaStageBytes. f32
// stays on the CUDA-core form (bf16 rounding of q or P would break its
// gate), and so do G 1, 2 and 4.
inline bool mma_rule(int G, int Dh, int page_size, int dtype, bool quant) {
  return dtype == 1 && G >= kMmaMinG && G <= 16 * kMmaMaxMT &&
         mma_dh(Dh, quant) &&
         2 * mma_tile(page_size) * Dh * (quant ? 1 : 2) <= kMmaStageBytes;
}
// What the form can run when a caller forces it.
inline bool mma_legal(int G, int Dh, int page_size, int dtype, bool quant,
                      int keys_per_tile) {
  return dtype == 1 && G >= 1 && G <= 16 * kMmaMaxMT && mma_dh(Dh, quant) &&
         keys_per_tile % 16 == 0 && keys_per_tile % page_size == 0;
}

// Byte offsets of the form's dynamic shared memory (after 1024 bytes of
// slack that align the ring for TMA's 128-byte swizzle): the ring of
// `stages` stages (a K tile, a V tile, each KT rows stored as 128-byte
// column blocks in TMA's 128-byte swizzle, and for int8 pages their KT K
// and V scales; 1024-byte stages), reused after the loop for the key
// slices' partial outputs (rows of mma_row_floats), maxima, sums and merge
// weights; then q (16 MT rows of
// Dh bf16, each padded by 16 bytes), the mbarriers, the key-visible bytes
// and the page ids.
struct MmaLayout {
  int kv, stage, stages, q, bar, ok, pid, total;
};

// Floats of a row of the key slices' outputs in shared memory: Dh and a
// padding that puts each pass of the epilogue's 8-byte (bf16 pages) or
// 16-byte (int8) stores on distinct banks.
__host__ __device__ constexpr int mma_row_floats(int Dh, bool quant) {
  return Dh + (quant ? 16 : 8);
}

__host__ __device__ inline MmaLayout mma_layout(int MT, int Dh, int isz,
                                                bool quant, int KT,
                                                int pps) {
  const int ks = mma_ks(MT, mma_ds(Dh)), rows = 16 * MT;
  MmaLayout y;
  y.kv = KT * Dh * isz;
  y.stage = round1024(2 * y.kv + (quant ? 8 * KT : 0));
  const int fit = kMmaRingBytes / y.stage;
  y.stages = fit < 2 ? 2 : fit > kMaxStages ? kMaxStages : fit;
  const int ring = y.stages * y.stage;
  const int merge = 4 * (ks * rows * mma_row_floats(Dh, quant) +
                         ks * rows * 2 + rows * ks + 2 * rows);
  y.q = round16(ring > merge ? ring : merge);
  y.bar = y.q + rows * (2 * Dh + 16);
  y.ok = y.bar + 16 * kMaxStages;
  y.pid = round16(y.ok + kMaxStages * KT);
  y.total = y.pid + 4 * pps + 1024;
  return y;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of 16-byte chunk cc of row r in a tile of KT rows stored as
// 128-byte column blocks in TMA's 128-byte swizzle (chunk c of a block's
// row r at c ^ (r % 8)).
__device__ __forceinline__ uint32_t swz(int r, int cc, int KT) {
  return (cc >> 3) * KT * 128 + r * 128 + (((cc & 7) ^ (r & 7)) << 4);
}

// The head dim of column e (0 or 1) of output tile n in the fragments of
// a lane with t = lane % 4: bf16 pages in order (8 dims a tile); int8
// pages as the transposed int8 V fragments leave them (below).
template <bool kQuant>
__device__ __forceinline__ int out_dim(int n, int e, int t) {
  if constexpr (kQuant)
    return 32 * (n / 4) + 16 * ((n / 2) % 2) + 4 * t + (n % 2) + 2 * e;
  else
    return 8 * n + 2 * t + e;
}

// CTA (split, h, b): every query head of KV head h's group, for row b's
// keys of page-table entries [split pps, (split + 1) pps), on tensor cores.
//
// Scores: S = Q K^T with mma.sync m16n8k16 in bf16, f32 sums; the group's
// query rows are the A rows (16 MT of them, those past G zero), q enters
// unscaled and scale log2(e), or the softcap, is applied to S in f32. The
// B fragments come from the K tile by ldmatrix; TMA's 128-byte swizzle
// makes the 8 rows an ldmatrix reads fall on distinct banks. P.V: P
// rounded to bf16 (as the flash-attention kernels do) is the A operand
// straight from the score fragments, V's B fragments come by
// ldmatrix.trans, O is summed in f32.
//
// Int8 pages, without a conversion pass through shared memory: an int8
// tile is read by ldmatrix as if it held b16 values, and each int8 pair
// becomes an exact bf16 pair (hopper::s8x2_to_bf16x2, bytes 0 and 2). For
// K a lane so holds bytes (4t .. 4t + 3) of a key's 16 dims of a k-step:
// bytes 0/2 are the fragment's k rows 2t/2t+1, bytes 1/3 rows 2t+8/2t+9,
// and q's columns are stored in that order. For V (transposed) a lane
// holds a 2 x 2 block, keys (2t, 2t+1) x dims (2g, 2g+1) of 16: bytes 0/2
// are the B fragment of the tile of even dims, bytes 1/3 of the tile of
// odd dims (out_dim). A key's K scale multiplies its column of S; its V
// scale its column of P before P is rounded.
//
// Warp w is row tile w % MT, dim slice w / MT % DS and key slice w / (MT
// DS): it takes the tile's 16-key chunks ks, ks + KS, ..., keeps its own
// running max and sum per row, and rescales its output once per chunk.
// Warps of one (row tile, key slice) and two dim slices compute the same
// scores. The key slices' outputs are merged once per CTA, in slice order.
// A chunk with no visible key is skipped; over bf16 pages the V values of
// invisible keys are zeroed in the fragments (a tile row no copy wrote may
// hold any bits). Warp 0 fills the ring as in paged_decode_kernel, one TMA
// load per mapped page and 128-byte column block (cp.async where pages
// are not whole multiples of 8 keys).
template <typename PT, int MT, int DH>
__global__ void __launch_bounds__(32 * mma_warps(MT, mma_ds(DH)), 1)
    paged_decode_mma_kernel(const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __nv_bfloat16* __restrict__ q,
                            const PT* __restrict__ k_pages,
                            const PT* __restrict__ v_pages,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ table,
                            const int* __restrict__ lengths,
                            __nv_bfloat16* __restrict__ out,
                            float* __restrict__ part_o,
                            float* __restrict__ part_ml, int Hkv, int G,
                            int page_size, int n_pages, int KT, int pps,
                            int window, float softcap, float scale,
                            bool tma) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int ISZ = static_cast<int>(sizeof(PT));
  constexpr int DS = mma_ds(DH), KS = mma_ks(MT, DS);
  constexpr int NW = MT * DS * KS, kThr = 32 * NW;
  constexpr int DW = DH / DS;       // output dims of a warp
  constexpr int NT = DW / 8;        // its n8 tiles
  constexpr int KSTEPS = DH / 16;   // k16 steps of a score
  constexpr int CPR = DH * ISZ / 16;  // 16-byte chunks of a K/V row
  constexpr int CB = DH * ISZ / 128;  // 128-byte column blocks of a row
  constexpr int QP = 2 * DH + 16;   // bytes of a q row in shared memory
  constexpr int ROWS = 16 * MT;
  constexpr bool kQRegs = DH <= 128;  // q's fragments held in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const MmaLayout lay = mma_layout(MT, DH, ISZ, kQuant, KT, pps);
  const int S = lay.stages;
  unsigned char* q_s = smem + lay.q;
  unsigned char* ok_s = smem + lay.ok;
  int* pid_s = reinterpret_cast<int*>(smem + lay.pid);
  const uint32_t full0 = smem_addr(smem + lay.bar);
  const uint32_t empty0 = full0 + 8 * kMaxStages;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int mt = warp % MT, ds = warp / MT % DS, ks = warp / (MT * DS);
  const size_t bh = static_cast<size_t>(b) * Hkv + h;

  if (tid == 0) {
    if (tma) {  // the tensor maps' descriptors, fetched while q loads
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_k))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&tm_v))
                   : "memory");
    }
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, tma ? 1 : 33);
      mbar_init(empty0 + 8 * s, NW);
    }
    fence_barrier_init();
  }
  const int t0 = split * pps;
  const int n_tab = min(pps, n_pages - t0);
  for (int i = tid; i < n_tab; i += kThr)
    pid_s[i] = table[static_cast<size_t>(b) * n_pages + t0 + i];
  // q unscaled, 16 dims (two 16-byte loads) a thread at a time, rows past
  // G zero; over int8 pages column c of a k-step holds dim
  // 4 ((c % 8) / 2) + 2 (c % 2) + c / 8
  for (int e = tid; e < ROWS * DH / 16; e += kThr) {
    const int r = e / (DH / 16), c = 16 * (e - r * (DH / 16));
    uint4 v[2] = {make_uint4(0u, 0u, 0u, 0u), make_uint4(0u, 0u, 0u, 0u)};
    if (r < G) {
      const uint4* src =
          reinterpret_cast<const uint4*>(q + (bh * G + r) * DH + c);
      v[0] = src[0];
      v[1] = src[1];
      if constexpr (kQuant) {
        const uint16_t* h16 = reinterpret_cast<const uint16_t*>(v);
        uint32_t w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int p = 4 * (i & 3) + (i >> 2);  // column 2 i
          w[i] = static_cast<uint32_t>(h16[p]) |
                 (static_cast<uint32_t>(h16[p + 2]) << 16);
        }
        v[0] = make_uint4(w[0], w[1], w[2], w[3]);
        v[1] = make_uint4(w[4], w[5], w[6], w[7]);
      }
    }
    uint4* dst = reinterpret_cast<uint4*>(q_s + r * QP + 2 * c);
    dst[0] = v[0];
    dst[1] = v[1];
  }
  const int len = lengths[b];
  __syncthreads();

  const int lo = window >= 0 ? max(0, len - window) : 0;
  const int hi = len;
  const int p_row_end =
      hi > 0 ? min(n_pages, (hi + page_size - 1) / page_size) : 0;
  const int p_first = max(lo / page_size, t0);
  const int p_end = min(p_row_end, t0 + n_tab);
  const int tile_pages = KT / page_size;
  const int n_tiles =
      p_end > p_first ? (p_end - p_first + tile_pages - 1) / tile_pages : 0;

  // warp 0: tile u into stage u % S, once the stage's previous tile is
  // read, as paged_decode_kernel fills its ring, but one TMA box per
  // 128-byte column block of a page's rows, and cp.async copies to the
  // swizzled chunks (swz)
  auto fill = [&](int u) {
    if (u >= n_tiles) return;
    const int st = u % S;
    mbar_wait(empty0 + 8 * st, ((u / S) & 1) ^ 1);
    unsigned char* base = smem + st * lay.stage;
    float* sc = reinterpret_cast<float*>(base + 2 * lay.kv);
    const uint32_t full = full0 + 8 * st;
    const int p0 = p_first + u * tile_pages;
    for (int r = lane; r < KT; r += 32) {
      const int p = p0 + r / page_size;
      const int kpos = p0 * page_size + r;
      ok_s[st * KT + r] = p < p_end && pid_s[p - t0] >= 0 && kpos >= lo &&
                          kpos < hi;
    }
    if (tma) {
      int n = 0;
      for (int i0 = 0; i0 < tile_pages; i0 += 32) {
        const int i = i0 + lane, p = p0 + i;
        const bool mapped = i < tile_pages && p < p_end && pid_s[p - t0] >= 0;
        n += __popc(__ballot_sync(kFull, mapped));
      }
      __syncwarp();
      if (lane == 0)
        mbar_expect_tx(full, n * (2 * page_size * DH * ISZ +
                                  (kQuant ? 8 * page_size : 0)));
      __syncwarp();
      for (int i = lane; i < tile_pages; i += 32) {
        const int p = p0 + i;
        const int pid = p < p_end ? pid_s[p - t0] : -1;
        if (pid < 0) continue;
        const uint32_t dst = smem_addr(base) + i * page_size * 128;
#pragma unroll
        for (int j = 0; j < CB; ++j) {
          tma_load_4d(dst + j * KT * 128, &tm_k, full, j * (128 / ISZ), h, 0,
                      pid);
          tma_load_4d(dst + lay.kv + j * KT * 128, &tm_v, full,
                      j * (128 / ISZ), h, 0, pid);
        }
        if constexpr (kQuant) {
          const size_t tok = static_cast<size_t>(pid) * page_size;
          bulk_load(smem_addr(sc + i * page_size), k_scale + tok,
                    4 * page_size, full);
          bulk_load(smem_addr(sc + KT + i * page_size), v_scale + tok,
                    4 * page_size, full);
        }
      }
    } else {
      for (int i = lane; i < KT * CPR; i += 32) {
        const int r = i / CPR, cc = i - r * CPR;
        const int pi = r / page_size, j = r - pi * page_size;
        const int p = p0 + pi;
        const int pid = p < p_end ? pid_s[p - t0] : -1;
        if (pid < 0) continue;
        const size_t off =
            ((static_cast<size_t>(pid) * page_size + j) * Hkv + h) * DH;
        const uint32_t o = swz(r, cc, KT);
        cp_async16(base + o, k_pages + off + cc * (16 / ISZ));
        cp_async16(base + lay.kv + o, v_pages + off + cc * (16 / ISZ));
      }
      if constexpr (kQuant) {
        for (int r = lane; r < KT; r += 32) {
          const int pi = r / page_size, j = r - pi * page_size;
          const int p = p0 + pi;
          const int pid = p < p_end ? pid_s[p - t0] : -1;
          if (pid < 0) continue;
          const size_t tok = static_cast<size_t>(pid) * page_size + j;
          cp_async4(sc + r, k_scale + tok);
          cp_async4(sc + KT + r, v_scale + tok);
        }
      }
      mbar_arrive_cp_async(full);
      __syncwarp();
      if (lane == 0) mbar_arrive(full);
    }
  };
  if (warp == 0)
    for (int u = 0; u < S - 1; ++u) fill(u);

  const int g = lane / 4, t = lane % 4;
  float acc[NT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // lane i: row i % 16 of the row tile, 16-byte chunk i / 16 of a k-step
  const uint32_t q_lane =
      smem_addr(q_s) + (mt * 16 + (lane & 15)) * QP + (lane >> 4) * 16;
  uint32_t qf[kQRegs ? KSTEPS : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int s = 0; s < KSTEPS; ++s) ldsm_x4(qf[s], q_lane + 32 * s);
  }
  const float sl = scale * kLog2e;
  const int n_chunks = KT / 16;
  // ldmatrix rows of a chunk: keys (lane % 8) + 8 (lane / 8 % 2), and for
  // bf16 K keys (lane % 8) + 8 (lane / 16)
  const int key_a = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int key_b = (lane & 7) + 8 * (lane >> 4);

  for (int tt = 0; tt < n_tiles; ++tt) {
    if (warp == 0) fill(tt + S - 1);
    const int st = tt % S;
    mbar_wait(full0 + 8 * st, (tt / S) & 1);
    const uint32_t k_base = smem_addr(smem + st * lay.stage);
    const uint32_t v_base = k_base + lay.kv;
    const float* sc =
        reinterpret_cast<const float*>(smem + st * lay.stage + 2 * lay.kv);
    const unsigned char* ok_t = ok_s + st * KT;

    for (int c = ks; c < n_chunks; c += KS) {
      const int kc = 16 * c;
      // the keys of this lane's score columns: kc + 8 j + 2 t + e
      bool okk[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) okk[j][e] = ok_t[kc + 8 * j + 2 * t + e];
      const bool any = okk[0][0] || okk[0][1] || okk[1][0] || okk[1][1];
      if (!__any_sync(kFull, any)) continue;  // warp-uniform
      const bool whole = __all_sync(
          kFull, okk[0][0] && okk[0][1] && okk[1][0] && okk[1][1]);

      // S = Q K^T over the chunk's 16 keys: two n8 tiles
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      if constexpr (kQuant) {
#pragma unroll
        for (int s2 = 0; s2 < KSTEPS; s2 += 2) {
          // [0] keys kc.. of step s2, [1] keys kc+8.., [2], [3] step s2+1
          uint32_t kf[4];
          ldsm_x4(kf, k_base + swz(kc + key_a, s2 + (lane >> 4), KT));
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            uint32_t a[4];
            if constexpr (kQRegs) {
#pragma unroll
              for (int i = 0; i < 4; ++i) a[i] = qf[s2 + u][i];
            } else {
              ldsm_x4(a, q_lane + 32 * (s2 + u));
            }
            hopper::mma_m16n8k16(s[0], a, hopper::s8x2_to_bf16x2(kf[2 * u]),
                                 hopper::s8x2_to_bf16x2(kf[2 * u] >> 8));
            hopper::mma_m16n8k16(
                s[1], a, hopper::s8x2_to_bf16x2(kf[2 * u + 1]),
                hopper::s8x2_to_bf16x2(kf[2 * u + 1] >> 8));
          }
        }
      } else {
#pragma unroll
        for (int s1 = 0; s1 < KSTEPS; ++s1) {
          // [0], [1] the b0, b1 of keys kc.., [2], [3] of keys kc+8..
          uint32_t kf[4];
          ldsm_x4(kf, k_base + swz(kc + key_b, 2 * s1 + ((lane >> 3) & 1),
                                   KT));
          uint32_t a[4];
          if constexpr (kQRegs) {
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = qf[s1][i];
          } else {
            ldsm_x4(a, q_lane + 32 * s1);
          }
          hopper::mma_m16n8k16(s[0], a, kf[0], kf[1]);
          hopper::mma_m16n8k16(s[1], a, kf[2], kf[3]);
        }
      }

      // to the log2 domain (int8: each key's K scale), invisible keys out;
      // fragment e: row g (e < 2) or g + 8, key kc + 8 j + 2 t + e % 2
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float v = s[j][e];
          if constexpr (kQuant) v *= sc[kc + 8 * j + 2 * t + (e & 1)];
          v = softcap > 0.f ? softcap * tanhf(v * scale / softcap) * kLog2e
                            : v * sl;
          s[j][e] = okk[j][e & 1] ? v : kNegInf;
        }
      // the rows' maxima over the chunk (a row's 16 keys lie in a quad of
      // lanes), one rescale of the running output
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float cm = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]),
                         fmaxf(s[1][2 * r], s[1][2 * r + 1]));
        cm = fmaxf(cm, __shfl_xor_sync(kFull, cm, 1));
        cm = fmaxf(cm, __shfl_xor_sync(kFull, cm, 2));
        const float mn = fmaxf(m[r], cm);
        corr[r] = exp2f(m[r] - mn);
        m[r] = mn;
        l[r] *= corr[r];
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        acc[n][0] *= corr[0];
        acc[n][1] *= corr[0];
        acc[n][2] *= corr[1];
        acc[n][3] *= corr[1];
      }
      // P in f32 into the sums, then (int8: times each key's V scale)
      // rounded to bf16 as the A fragment of P.V
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = okk[j][e & 1];
          float p = ok ? exp2f(s[j][e] - m[e >> 1]) : 0.f;
          l[e >> 1] += p;
          if constexpr (kQuant)
            p = ok ? p * sc[KT + kc + 8 * j + 2 * t + (e & 1)] : 0.f;
          s[j][e] = p;
        }
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                              pack_bf16(s[0][2], s[0][3]),
                              pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};

      // O += P V over the warp's head dims [ds DW, ds DW + DW)
      if constexpr (kQuant) {
#pragma unroll
        for (int n4 = 0; n4 < DW / 32; ++n4) {
          // [0] keys kc.. dims d..d+15, [1] keys kc+8.., [2], [3] d+16..
          const int d = ds * DW + 32 * n4;
          uint32_t vf[4];
          ldsm_x4_t(vf, v_base + swz(kc + key_a, d / 16 + (lane >> 4), KT));
          hopper::mma_m16n8k16(acc[4 * n4], pa,
                               hopper::s8x2_to_bf16x2(vf[0]),
                               hopper::s8x2_to_bf16x2(vf[1]));
          hopper::mma_m16n8k16(acc[4 * n4 + 1], pa,
                               hopper::s8x2_to_bf16x2(vf[0] >> 8),
                               hopper::s8x2_to_bf16x2(vf[1] >> 8));
          hopper::mma_m16n8k16(acc[4 * n4 + 2], pa,
                               hopper::s8x2_to_bf16x2(vf[2]),
                               hopper::s8x2_to_bf16x2(vf[3]));
          hopper::mma_m16n8k16(acc[4 * n4 + 3], pa,
                               hopper::s8x2_to_bf16x2(vf[2] >> 8),
                               hopper::s8x2_to_bf16x2(vf[3] >> 8));
        }
      } else {
        // the V values of keys (2t, 2t+1) and (2t+8, 2t+9), zeroed where
        // invisible
        const uint32_t mk0 = (okk[0][0] ? 0xffffu : 0u) |
                             (okk[0][1] ? 0xffff0000u : 0u);
        const uint32_t mk1 = (okk[1][0] ? 0xffffu : 0u) |
                             (okk[1][1] ? 0xffff0000u : 0u);
#pragma unroll
        for (int n2 = 0; n2 < DW / 16; ++n2) {
          // [0], [1] the b0, b1 of dims d..d+7, [2], [3] of d+8..
          const int d = ds * DW + 16 * n2;
          uint32_t vf[4];
          ldsm_x4_t(vf, v_base + swz(kc + key_a, d / 8 + (lane >> 4), KT));
          if (!whole) {
            vf[0] &= mk0;
            vf[1] &= mk1;
            vf[2] &= mk0;
            vf[3] &= mk1;
          }
          hopper::mma_m16n8k16(acc[2 * n2], pa, vf[0], vf[1]);
          hopper::mma_m16n8k16(acc[2 * n2 + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * st);  // the stage is read
  }
  __syncthreads();  // every tile is read: the ring is free for the states

  // the quad's partial sums; then each warp's output, max and sum into
  // shared memory: wo [ks][row][DHP], wml [ks][row][m, l]. A lane stores
  // its rows' dims in pairs (bf16 pages: tile n's 2t, 2t + 1) or fours
  // (int8: tiles n and n + 1 hold 4t .. 4t + 3); the rows' padding keeps a
  // pass of those stores on distinct banks.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  constexpr int DHP = mma_row_floats(DH, kQuant);
  float* wo = reinterpret_cast<float*>(smem);
  float* wml = wo + KS * ROWS * DHP;
  float* wf = wml + KS * ROWS * 2;  // [row][ks] weights
  float* wsum = wf + ROWS * KS;     // [row][M, sum]
  const int r0 = mt * 16 + g;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    float* row = wo + (ks * ROWS + r0 + 8 * h2) * DHP + ds * DW;
    if constexpr (kQuant) {
#pragma unroll
      for (int n = 0; n < NT; n += 2)
        *reinterpret_cast<float4*>(row + out_dim<true>(n, 0, t)) =
            make_float4(acc[n][2 * h2], acc[n + 1][2 * h2],
                        acc[n][2 * h2 + 1], acc[n + 1][2 * h2 + 1]);
    } else {
#pragma unroll
      for (int n = 0; n < NT; ++n)
        *reinterpret_cast<float2*>(row + out_dim<false>(n, 0, t)) =
            make_float2(acc[n][2 * h2], acc[n][2 * h2 + 1]);
    }
  }
  if (ds == 0 && t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      wml[2 * (ks * ROWS + r0 + 8 * r)] = m[r];
      wml[2 * (ks * ROWS + r0 + 8 * r) + 1] = l[r];
    }
  }
  __syncthreads();
  // merge the key slices: o = sum_k 2^(m_k - M) acc_k, over
  // sum_k 2^(m_k - M) l_k, M the largest m_k, in slice order
  if (tid < ROWS) {
    const int r = tid;
    float mx = kNegInf;
#pragma unroll
    for (int k = 0; k < KS; ++k) mx = fmaxf(mx, wml[2 * (k * ROWS + r)]);
    float lsum = 0.f;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const float mk = wml[2 * (k * ROWS + r)];
      const float f = mk > kNegInf / 2 ? exp2f(mk - mx) : 0.f;
      wf[r * KS + k] = f;
      lsum += f * wml[2 * (k * ROWS + r) + 1];
    }
    wsum[2 * r] = mx;
    wsum[2 * r + 1] = lsum;
  }
  __syncthreads();
  // 8 dims of a row a thread: two 16-byte reads of each slice, one 16-byte
  // store of bf16 (or two of f32 partials)
  for (int e = tid; e < G * (DH / 8); e += kThr) {
    const int r = e / (DH / 8), d = 8 * (e - r * (DH / 8));
    float o[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = 0.f;
#pragma unroll
    for (int k = 0; k < KS; ++k) {
      const float f = wf[r * KS + k];
      const float4* src =
          reinterpret_cast<const float4*>(wo + (k * ROWS + r) * DHP + d);
      const float4 a = src[0], c = src[1];
      const float v[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = fmaf(f, v[i], o[i]);
    }
    const float lsum = wsum[2 * r + 1];
    if (n_splits > 1) {
      const size_t prow = (bh * n_splits + split) * G + r;
      float4* dst = reinterpret_cast<float4*>(part_o + prow * DH + d);
      dst[0] = make_float4(o[0], o[1], o[2], o[3]);
      dst[1] = make_float4(o[4], o[5], o[6], o[7]);
      if (d == 0) {
        part_ml[2 * prow] = wsum[2 * r];
        part_ml[2 * prow + 1] = lsum;
      }
    } else {
      const float inv = lsum == 0.f ? 1.f : lsum;
      uint4 w;
      uint32_t* wp = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wp[i] = pack_bf16(o[2 * i] / inv, o[2 * i + 1] / inv);
      *reinterpret_cast<uint4*>(out + (bh * G + r) * DH + d) = w;
    }
  }
}

// Merges the splits of one (row, head): o = sum_s 2^(m_s - M) acc_s /
// sum_s 2^(m_s - M) l_s with M the largest m_s; an empty row gives 0. CTA
// (h, b, z) owns elements [256 z, 256 z + 256) of the row's G x Dh output,
// one a thread; those elements touch nh heads (at most 8 for G <= 8, up to
// 256 / Dh + 1 above), and warp w finds M, the sum and each split's weight
// for heads w, w + 8, ... of them, once; the weights of as many splits as
// the shared buffer holds for nh heads are staged at a time, and the
// threads add the splits in order.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_merge_kernel(const float* __restrict__ part_o,
                              const float* __restrict__ part_ml,
                              T* __restrict__ out, int Hkv, int G, int Dh,
                              int n_splits) {
  __shared__ float w_s[kMaxG * kMergeChunk];
  __shared__ float mx_s[kThreads + 1], inv_s[kThreads + 1];
  const size_t bh = static_cast<size_t>(blockIdx.y) * Hkv + blockIdx.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int GD = G * Dh;
  const int e0 = blockIdx.z * kThreads, e = e0 + tid;
  const int g_lo = e0 / Dh;
  const int nh = min(G, (e0 + kThreads - 1) / Dh + 1) - g_lo;
  const int chunk = kMaxG * kMergeChunk / nh;  // splits staged per round
  const float* ml = part_ml + 2 * bh * n_splits * G;
  const float* po = part_o + bh * n_splits * GD;

  for (int gi = warp; gi < nh; gi += kWarps) {
    const int gw = g_lo + gi;
    float mx = kNegInf;
    for (int s = lane; s < n_splits; s += 32)
      mx = fmaxf(mx, ml[2 * (s * G + gw)]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    float lsum = 0.f;
    for (int s = lane; s < n_splits; s += 32) {
      const float m = ml[2 * (s * G + gw)];
      if (m > kNegInf / 2) lsum += exp2f(m - mx) * ml[2 * (s * G + gw) + 1];
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      lsum += __shfl_xor_sync(kFull, lsum, o);
    if (lane == 0) {
      mx_s[gi] = mx;
      inv_s[gi] = lsum == 0.f ? 0.f : 1.f / lsum;
    }
  }

  float o = 0.f;
  for (int c0 = 0; c0 < n_splits; c0 += chunk) {
    const int nc = min(chunk, n_splits - c0);
    __syncthreads();  // the maxima are written; the last round consumed
    for (int gi = warp; gi < nh; gi += kWarps)
      for (int s = lane; s < nc; s += 32) {
        const float m = ml[2 * ((c0 + s) * G + g_lo + gi)];
        w_s[gi * chunk + s] = m > kNegInf / 2 ? exp2f(m - mx_s[gi]) : 0.f;
      }
    __syncthreads();
    if (e < GD) {
      const float* w = w_s + (e / Dh - g_lo) * chunk;
      for (int s = 0; s < nc; ++s)
        o = fmaf(w[s], po[static_cast<size_t>(c0 + s) * GD + e], o);
    }
  }
  if (e < GD) store(o * inv_s[e / Dh - g_lo], out + bh * GD + e);
}

template <typename PT>
plan::Dims split_dims(int B, int Hkv, int G, int Dh, int n_pages,
                      int keys_per_tile, int pages_per_split) {
  const int n_splits = (n_pages + pages_per_split - 1) / pages_per_split;
  const int n_chunks = (G + kMaxG - 1) / kMaxG;  // of 8 query heads
  return {dim3(n_splits, Hkv * n_chunks, B), kThreads,
          static_cast<size_t>(layout<PT>(G < kMaxG ? G : kMaxG, Dh,
                                         keys_per_tile, pages_per_split)
                                  .total)};
}

// The tensor-core form's split launch: CTA (split, h, b) for the whole group.
template <typename PT>
plan::Dims mma_dims(int B, int Hkv, int G, int Dh, int n_pages,
                    int keys_per_tile, int pages_per_split) {
  const int n_splits = (n_pages + pages_per_split - 1) / pages_per_split;
  const int mt = (G + 15) / 16;
  return {dim3(n_splits, Hkv, B), 32 * mma_warps(mt, mma_ds(Dh)),
          static_cast<size_t>(
              mma_layout(mt, Dh, static_cast<int>(sizeof(PT)),
                         std::is_same<PT, int8_t>::value, keys_per_tile,
                         pages_per_split)
                  .total)};
}

inline plan::Dims merge_dims(int B, int Hkv, int G, int Dh) {
  return {dim3(Hkv, B, (G * Dh + kThreads - 1) / kThreads), kThreads, 0};
}

struct Args {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const float* k_scale;
  const float* v_scale;
  const int* table;
  const int* lengths;
  void* out;
  float* part_o;
  float* part_ml;
  int B, Hkv, G, Dh, page_size, n_pages, n_pool, keys_per_tile,
      pages_per_split, window;
  float softcap, scale;
  int form;  // -1: by mma_rule; 0: the CUDA-core form; 1: the tensor-core
};

// 1 where the tensor-core form runs (forced by `form`, or by the rule), 0
// where the CUDA-core form does, -1 where a forced tensor-core form cannot
// take the arguments.
inline int form_of(int form, int G, int Dh, int page_size, int dtype,
                   bool quant, int keys_per_tile) {
  if (form < 0) return mma_rule(G, Dh, page_size, dtype, quant) ? 1 : 0;
  if (form == 0) return 0;
  return mma_legal(G, Dh, page_size, dtype, quant, keys_per_tile) ? 1 : -1;
}

template <typename PT>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<PT, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<PT, int8_t>::value ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                           : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// The pages (P, page, Hkv, Dh) as a 4-D map (Dh innermost, Hkv, page, P)
// whose box is one page of one head: (Dh, 1, page, 1), rows of Dh
// elements in shared memory as the kernel reads them. False where a TMA
// box cannot hold the page (not whole multiples of 8 keys, so not 128-byte
// aligned in the ring, or past 256 keys) or the driver refuses the map.
template <typename PT>
bool page_map(CUtensorMap* map, const void* pages, const Args& a) {
  if (a.page_size % 8 != 0 || a.page_size > 256 || a.n_pool < 1)
    return false;
  hopper::EncodeTiled fn = hopper::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t e = sizeof(PT), dh = a.Dh, hkv = a.Hkv,
                   ps = a.page_size;
  const cuuint64_t dims[4] = {dh, hkv, ps, static_cast<cuuint64_t>(a.n_pool)};
  const cuuint64_t strides[3] = {dh * e, dh * hkv * e, dh * hkv * ps * e};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(a.Dh), 1,
                             static_cast<cuuint32_t>(a.page_size), 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return fn(map, map_type<PT>(), 4, const_cast<void*>(pages), dims, strides,
            box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same map for the tensor-core form: boxes (128 bytes of Dh, 1, page,
// 1) in TMA's 128-byte swizzle, one per 128-byte column block of a row.
template <typename PT>
bool page_map_mma(CUtensorMap* map, const void* pages, const Args& a) {
  if (a.page_size % 8 != 0 || a.page_size > 256 || a.n_pool < 1)
    return false;
  hopper::EncodeTiled fn = hopper::encoder();
  if (fn == nullptr) return false;
  const cuuint64_t e = sizeof(PT), dh = a.Dh, hkv = a.Hkv,
                   ps = a.page_size;
  const cuuint64_t dims[4] = {dh, hkv, ps, static_cast<cuuint64_t>(a.n_pool)};
  const cuuint64_t strides[3] = {dh * e, dh * hkv * e, dh * hkv * ps * e};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / sizeof(PT)), 1,
                             static_cast<cuuint32_t>(a.page_size), 1};
  const cuuint32_t one[4] = {1, 1, 1, 1};
  return fn(map, map_type<PT>(), 4, const_cast<void*>(pages), dims, strides,
            box, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Raises the kernel's dynamic shared-memory limit to `bytes` once it is
// needed (`configured`: the kernel's limit so far, 0 before its first
// launch).
template <typename K>
cudaError_t opt_in(K kernel, size_t bytes, size_t& configured) {
  if (configured == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    configured = 48 * 1024;  // the default dynamic limit
  }
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
    configured = bytes;
  }
  return cudaSuccess;
}

template <typename PT, int MT, int DH>
int launch_mma(const Args& a, const plan::Dims& d, cudaStream_t stream) {
  auto kernel = paged_decode_mma_kernel<PT, MT, DH>;
  static size_t configured = 0;  // per form
  const cudaError_t err = opt_in(kernel, d.smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tk{}, tv{};
  const bool tma = page_map_mma<PT>(&tk, a.k_pages, a) &&
                   page_map_mma<PT>(&tv, a.v_pages, a);
  kernel<<<d.grid, d.threads, d.smem, stream>>>(
      tk, tv, static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const PT*>(a.k_pages), static_cast<const PT*>(a.v_pages),
      a.k_scale, a.v_scale, a.table, a.lengths,
      static_cast<__nv_bfloat16*>(a.out), a.part_o, a.part_ml, a.Hkv, a.G,
      a.page_size, a.n_pages, a.keys_per_tile, a.pages_per_split, a.window,
      a.softcap, a.scale, tma);
  return static_cast<int>(cudaGetLastError());
}

template <typename PT, int DH>
int mma_by_rows(const Args& a, const plan::Dims& d, cudaStream_t s) {
  switch ((a.G + 15) / 16) {
    case 1: return launch_mma<PT, 1, DH>(a, d, s);
    case 2: return launch_mma<PT, 2, DH>(a, d, s);
    default: return launch_mma<PT, 3, DH>(a, d, s);
  }
}

template <typename PT>
int launch_mma_form(const Args& a, const plan::Dims& d, cudaStream_t s) {
  if constexpr (!std::is_same<PT, int8_t>::value)
    if (a.Dh == 64) return mma_by_rows<PT, 64>(a, d, s);
  return a.Dh == 128 ? mma_by_rows<PT, 128>(a, d, s)
                     : mma_by_rows<PT, 256>(a, d, s);
}

template <typename T, typename PT, int G, int DHB>
int launch_split(const Args& a, const plan::Dims& d, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, PT, G, DHB>;
  static size_t configured = 0;  // per form: the opt-in set so far
  const cudaError_t err = opt_in(kernel, d.smem, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap tk{}, tv{};
  const bool tma = page_map<PT>(&tk, a.k_pages, a) &&
                   page_map<PT>(&tv, a.v_pages, a);
  kernel<<<d.grid, d.threads, d.smem, stream>>>(
      tk, tv, static_cast<const T*>(a.q), static_cast<const PT*>(a.k_pages),
      static_cast<const PT*>(a.v_pages), a.k_scale, a.v_scale, a.table,
      a.lengths, static_cast<T*>(a.out), a.part_o, a.part_ml, a.Hkv, a.G,
      a.Dh, a.page_size, a.n_pages, a.keys_per_tile, a.pages_per_split,
      a.window, a.softcap, a.scale, tma);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename PT, int G>
int by_bucket(const Args& a, const plan::Dims& d, cudaStream_t s) {
  switch (bucket(a.Dh)) {
    case 64: return launch_split<T, PT, G, 64>(a, d, s);
    case 128: return launch_split<T, PT, G, 128>(a, d, s);
    default: return launch_split<T, PT, G, 256>(a, d, s);
  }
}

// The split launch of either form (`mma` 1: the tensor-core form).
template <typename PT>
plan::Dims form_dims(const Args& a, int mma) {
  return mma ? mma_dims<PT>(a.B, a.Hkv, a.G, a.Dh, a.n_pages,
                            a.keys_per_tile, a.pages_per_split)
             : split_dims<PT>(a.B, a.Hkv, a.G, a.Dh, a.n_pages,
                              a.keys_per_tile, a.pages_per_split);
}

// The rule (form_of, mma_rule): bf16 q over bf16 or int8 pages with a group
// of G0 = 5 to 48 heads runs the tensor-core form, one CTA per (split, KV
// head, row) for the whole group; anything else the CUDA-core form, whose
// groups above 8 run the 8 form over chunks of 8 heads.
template <typename T, typename PT>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int dtype = std::is_same<T, float>::value ? 0 : 1;
  const int mma = form_of(a.form, a.G, a.Dh, a.page_size, dtype,
                          std::is_same<PT, int8_t>::value, a.keys_per_tile);
  if (mma < 0) return static_cast<int>(cudaErrorInvalidValue);
  const plan::Dims d = form_dims<PT>(a, mma);
  int e = 0;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (mma) e = launch_mma_form<PT>(a, d, stream);
  }
  if (!mma)
    e = a.G <= 1   ? by_bucket<T, PT, 1>(a, d, stream)
        : a.G <= 2 ? by_bucket<T, PT, 2>(a, d, stream)
        : a.G <= 4 ? by_bucket<T, PT, 4>(a, d, stream)
                   : by_bucket<T, PT, 8>(a, d, stream);
  if (e != 0 || d.grid.x == 1) return e;
  const plan::Dims m = merge_dims(a.B, a.Hkv, a.G, a.Dh);
  paged_decode_merge_kernel<T><<<m.grid, m.threads, m.smem, stream>>>(
      a.part_o, a.part_ml, static_cast<T*>(a.out), a.Hkv, a.G, a.Dh,
      static_cast<int>(d.grid.x));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, pages and out share it). The pages are
// (n_pool, page_size, Hkv, Dh). window < 0 means no window; softcap <= 0
// means no softcap. form: -1 the rule (form_of), 0 the CUDA-core form, 1 the
// tensor-core form. keys_per_tile is a multiple of page_size (and of 16 for
// the tensor-core form); pages_per_split a multiple of keys_per_tile /
// page_size (both from launch.split_plan or launch.mma_split_plan). With
// n_splits = ceil(n_pages / pages_per_split) > 1, part_o holds
// B*Hkv*n_splits*G*Dh floats and part_ml twice B*Hkv*n_splits*G.
// Preconditions (checked by the Python wrapper): contiguous tensors,
// 16-byte aligned, G >= 1, Dh <= 256, Dh * sizeof(dtype) % 16 == 0,
// table entries in [-1, n_pool).
// Returns cudaGetLastError() after the launches.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages, const int* table,
    const int* lengths, void* out, float* part_o, float* part_ml, int B,
    int Hkv, int G, int Dh, int page_size, int n_pages, int n_pool,
    int keys_per_tile, int pages_per_split, int window, int form,
    float softcap, float scale, int dtype, void* stream) {
  const Args a{q,       k_pages,       v_pages,   nullptr, nullptr,
               table,   lengths,       out,       part_o,  part_ml,
               B,       Hkv,           G,         Dh,      page_size,
               n_pages, n_pool,        keys_per_tile, pages_per_split,
               window,  softcap,       scale,     form};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, float>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same over int8 pages (n_pool, page, Hkv, Dh) with per-token float32
// scales k_scale, v_scale (n_pool, page); dtype is that of q and out.
// Further precondition: Dh % 16 == 0.
extern "C" int paged_decode_attention_quant(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, const int* table,
    const int* lengths, void* out, float* part_o, float* part_ml, int B,
    int Hkv, int G, int Dh, int page_size, int n_pages, int n_pool,
    int keys_per_tile, int pages_per_split, int window, int form,
    float softcap, float scale, int dtype, void* stream) {
  const Args a{q,       k_pages,       v_pages,   k_scale, v_scale,
               table,   lengths,       out,       part_o,  part_ml,
               B,       Hkv,           G,         Dh,      page_size,
               n_pages, n_pool,        keys_per_tile, pages_per_split,
               window,  softcap,       scale,     form};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, int8_t>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16, int8_t>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launches paged_decode_attention (quant 0) or
// paged_decode_attention_quant (quant 1) makes for these arguments, from the
// host code it launches with: six ints each (grid x, y, z, threads, dynamic
// shared memory bytes, cluster) written to out (room for 2). Returns the
// launch count, or -1 where a forced tensor-core form cannot take them.
extern "C" int paged_decode_attention_plan(int B, int Hkv, int G, int Dh,
                                           int page_size, int n_pages,
                                           int keys_per_tile,
                                           int pages_per_split, int dtype,
                                           int quant, int form, int* out) {
  Args a{};
  a.B = B, a.Hkv = Hkv, a.G = G, a.Dh = Dh, a.page_size = page_size;
  a.n_pages = n_pages, a.keys_per_tile = keys_per_tile;
  a.pages_per_split = pages_per_split;
  const int mma = form_of(form, G, Dh, page_size, dtype, quant != 0,
                          keys_per_tile);
  if (mma < 0) return -1;
  const plan::Dims d = quant ? form_dims<int8_t>(a, mma)
                       : dtype == 0 ? form_dims<float>(a, mma)
                                    : form_dims<__nv_bfloat16>(a, mma);
  plan::put(out, 0, d);
  if (d.grid.x == 1) return 1;
  plan::put(out, 1, merge_dims(B, Hkv, G, Dh));
  return 2;
}
