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
// - Groups above 8 (granite-34b's 48 query heads over one KV head). The
//   grid's y coordinate runs over (KV head, chunk of 8 query heads), and
//   each CTA runs the 8 form on heads [8c, 8c + 8) of its group, the last
//   chunk masked as a group of 7 is. A CTA reads its KV head's pages
//   itself, so the pages are read ceil(G / 8) times, the later reads mostly
//   from L2; the split outputs and the merge index the whole group. No
//   tensor cores here: at G 48 the scores are a (48 x Dh) . (Dh x keys)
//   product an mma tile could take, which is later work.
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
// Scores are kept in the log2 domain (q is scaled by log2(e), or the
// softcapped logit is), so the softmax uses exp2f. Int8 pages: each value
// is float(q8) exactly (a byte permute and an add, not the slower
// conversion instruction), and the reference's dequantization
// float(q8) * scale[token] is folded out of the sums: a key's scale
// multiplies its score, a value's scale its probability (equal up to f32
// rounding).
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
};

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

template <typename T, typename PT, int G, int DHB>
int launch_split(const Args& a, const plan::Dims& d, cudaStream_t stream) {
  auto kernel = paged_decode_kernel<T, PT, G, DHB>;
  static size_t configured = 0;  // per form: the opt-in set so far
  if (configured == 0) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = 48 * 1024;  // the default dynamic limit
  }
  if (d.smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(d.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = d.smem;
  }
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

template <typename T, typename PT>
int launch(const Args& a, cudaStream_t stream) {
  const plan::Dims d = split_dims<PT>(a.B, a.Hkv, a.G, a.Dh, a.n_pages,
                                      a.keys_per_tile, a.pages_per_split);
  // groups above 8 run the 8 form over chunks of 8 heads
  const int e = a.G <= 1   ? by_bucket<T, PT, 1>(a, d, stream)
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
// means no softcap. keys_per_tile is a multiple of page_size;
// pages_per_split a multiple of keys_per_tile / page_size (both from
// launch.split_plan). With n_splits = ceil(n_pages / pages_per_split) > 1,
// part_o holds B*Hkv*n_splits*G*Dh floats and part_ml twice
// B*Hkv*n_splits*G.
// Preconditions (checked by the Python wrapper): contiguous tensors,
// 16-byte aligned, G >= 1, Dh <= 256, Dh * sizeof(dtype) % 16 == 0,
// table entries in [-1, n_pool).
// Returns cudaGetLastError() after the launches.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages, const int* table,
    const int* lengths, void* out, float* part_o, float* part_ml, int B,
    int Hkv, int G, int Dh, int page_size, int n_pages, int n_pool,
    int keys_per_tile, int pages_per_split, int window, float softcap,
    float scale, int dtype, void* stream) {
  const Args a{q,       k_pages,       v_pages,   nullptr, nullptr,
               table,   lengths,       out,       part_o,  part_ml,
               B,       Hkv,           G,         Dh,      page_size,
               n_pages, n_pool,        keys_per_tile, pages_per_split,
               window,  softcap,       scale};
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
    int keys_per_tile, int pages_per_split, int window, float softcap,
    float scale, int dtype, void* stream) {
  const Args a{q,       k_pages,       v_pages,   k_scale, v_scale,
               table,   lengths,       out,       part_o,  part_ml,
               B,       Hkv,           G,         Dh,      page_size,
               n_pages, n_pool,        keys_per_tile, pages_per_split,
               window,  softcap,       scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, int8_t>(a, s);
  if (dtype == 1) return launch<__nv_bfloat16, int8_t>(a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launches paged_decode_attention (quant 0) or
// paged_decode_attention_quant (quant 1) makes for these arguments, from the
// host code it launches with: six ints each (grid x, y, z, threads, dynamic
// shared memory bytes, cluster) written to out (room for 2). Returns the
// launch count.
extern "C" int paged_decode_attention_plan(int B, int Hkv, int G, int Dh,
                                           int page_size, int n_pages,
                                           int keys_per_tile,
                                           int pages_per_split, int dtype,
                                           int quant, int* out) {
  (void)page_size;
  const plan::Dims d =
      quant ? split_dims<int8_t>(B, Hkv, G, Dh, n_pages, keys_per_tile,
                                 pages_per_split)
      : dtype == 0 ? split_dims<float>(B, Hkv, G, Dh, n_pages, keys_per_tile,
                                       pages_per_split)
                   : split_dims<__nv_bfloat16>(B, Hkv, G, Dh, n_pages,
                                               keys_per_tile,
                                               pages_per_split);
  plan::put(out, 0, d);
  if (d.grid.x == 1) return 1;
  plan::put(out, 1, merge_dims(B, Hkv, G, Dh));
  return 2;
}
