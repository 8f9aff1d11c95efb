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
// What bounds it on the card: bytes, the K and V pages that the rows'
// visible positions occupy (and with int8 pages 8 bytes of scales per
// key); the arithmetic is about 4 G Dh operations per key, far below the
// ridge point.
//
// What the design does about it: the Pallas grid walks one row's pages in
// sequence; a decode batch has only B x Hkv (row, head) pairs, far fewer
// than the card's 132 SMs, so here the pages of a row are also split into
// contiguous ranges over gridDim.x CTAs. Each CTA reads its range's
// page-table entries itself and copies 64-key tiles of K and V into shared
// memory with cp.async, every copy of a tile in flight at once. It never
// dereferences an entry of -1 (those rows are zero-filled and skipped) and
// skips pages wholly outside [len - window, len), which leaves the result
// unchanged. Inside a tile each warp takes every 8th key and keeps its own
// online softmax for the G query heads in registers (a lane holds 8 head
// dims of q and of the output, so a key costs one 16-byte K and V load per
// lane and one shuffle reduction per head), so no block-wide barrier sits
// between scores and values; the 8 warps' states are merged at the end.
// Each K/V row is read once and shared by all G query heads of the group.
// With more than one split, each CTA writes its unnormalised output with
// its running max and sum, and a second kernel merges the splits in order,
// as the online softmax would have.
//
// Int8 pages (paged_decode_attention_quant) keep that plan. A lane's 8 head
// dims of an int8 K or V row are 8 bytes, read with one 8-byte load (the
// lane-to-dim map of bf16), so a 64-key tile of Dh 256 is 16 KB per page
// kind instead of 32 KB. Each tile's 64 per-token scales are copied beside
// it through the same page-table entries (a -1 entry is never dereferenced,
// for scales as for pages), and each key is dequantized as the reference
// does it, k = float(q8) * k_scale[token] in f32, before the dot product
// with the scaled query; V likewise before it is accumulated.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "plan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* out) { *out = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

// How a lane reads its chunk of a K/V row in shared memory: EPC
// consecutive head dims, converted to f32 (16 bytes of f32 or bf16, 8 bytes
// of int8).
template <typename PT>
struct PageIO;
template <>
struct PageIO<float> {
  static constexpr int EPC = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};
template <>
struct PageIO<__nv_bfloat16> {
  static constexpr int EPC = 8;
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(e[i]);
  }
};
template <>
struct PageIO<int8_t> {
  static constexpr int EPC = 8;
  __device__ static void load(const int8_t* p, float* out) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    const int8_t* e = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = static_cast<float>(e[i]);
  }
};

template <typename PT>
size_t smem_bytes(int G, int Dh, int KT, int tile_pages) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  return 2 * static_cast<size_t>(KT) * Dh * sizeof(PT)  // K, V tiles
         + static_cast<size_t>(G) * Dh * 4              // scaled q
         + static_cast<size_t>(kWarps) * G * Dh * 4     // per-warp outputs
         + static_cast<size_t>(kWarps) * G * 2 * 4      // per-warp max, sum
         + (kQuant ? 2 * static_cast<size_t>(KT) * 4 : 0)  // K, V scales
         + static_cast<size_t>(tile_pages) * 4;         // page ids
}

template <typename T, typename PT>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const T* __restrict__ q,
                        const PT* __restrict__ k_pages,
                        const PT* __restrict__ v_pages,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ table,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        float* __restrict__ part_o, float* __restrict__ part_ml,
                        int Hkv, int G, int Dh, int page_size, int n_pages,
                        int KT, int pages_per_split, int window,
                        float softcap, float scale) {
  constexpr bool kQuant = std::is_same<PT, int8_t>::value;
  constexpr int EPC = PageIO<PT>::EPC;  // head dims per lane chunk
  constexpr int CPL = 256 / EPC / 32;   // chunks per lane at Dh = 256
  constexpr int DPL = CPL * EPC;        // head dims per lane (8)
  constexpr int EPV = 16 / sizeof(PT);  // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile_pages = KT / page_size;
  PT* k_s = reinterpret_cast<PT*>(smem);
  PT* v_s = k_s + KT * Dh;
  float* q_s = reinterpret_cast<float*>(v_s + KT * Dh);
  float* wacc_s = q_s + G * Dh;
  float* wml_s = wacc_s + kWarps * G * Dh;
  float* ks_s = wml_s + kWarps * G * 2;  // per-token scales (int8 pages)
  float* vs_s = ks_s + (kQuant ? KT : 0);
  int* pid_s = reinterpret_cast<int*>(vs_s + (kQuant ? KT : 0));

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_splits = gridDim.x;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int len = lengths[b];
  const int lo = window >= 0 ? max(0, len - window) : 0;  // first visible
  const int hi = len;                                      // one past last
  const int VPR = Dh / EPC;  // lane chunks per K/V row
  const int CPR = Dh / EPV;  // 16-byte copies per K/V row

  const size_t bh = static_cast<size_t>(b) * Hkv + h;
  for (int e = tid; e < G * Dh; e += kThreads)
    q_s[e] = to_f32(q[bh * G * Dh + e]) * scale;
  __syncthreads();

  // each lane owns the head dims of chunks lane, lane + 32, ... of a row;
  // each warp keeps its own online softmax over the keys it visits
  float qr[kMaxG][DPL], acc[kMaxG][DPL], m[kMaxG], l[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j)
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        const int c = lane + 32 * j;
        acc[g][j * EPC + e] = 0.f;
        qr[g][j * EPC + e] = g < G && c < VPR ? q_s[g * Dh + c * EPC + e] : 0.f;
      }
  }

  const int p_row_end =
      hi > 0 ? min(n_pages, (hi + page_size - 1) / page_size) : 0;
  const int p_first = max(lo / page_size, split * pages_per_split);
  const int p_end = min(p_row_end, (split + 1) * pages_per_split);

  for (int p0 = p_first; p0 < p_end; p0 += tile_pages) {
    __syncthreads();  // the previous tile is fully consumed
    if (tid < tile_pages)
      pid_s[tid] = p0 + tid < p_end
                       ? table[static_cast<size_t>(b) * n_pages + p0 + tid]
                       : -1;
    __syncthreads();
    for (int c = tid; c < KT * CPR; c += kThreads) {
      const int r = c / CPR, cc = c - r * CPR;
      const int pid = pid_s[r / page_size], j = r % page_size;
      const size_t off =
          pid >= 0 ? ((static_cast<size_t>(pid) * page_size + j) * Hkv + h) *
                             Dh + cc * EPV
                   : 0;
      cp_async16(k_s + r * Dh + cc * EPV, k_pages + off, pid >= 0);
      cp_async16(v_s + r * Dh + cc * EPV, v_pages + off, pid >= 0);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    if constexpr (kQuant) {
      for (int r = tid; r < KT; r += kThreads) {
        const int pid = pid_s[r / page_size];
        const size_t t = static_cast<size_t>(pid) * page_size + r % page_size;
        ks_s[r] = pid >= 0 ? k_scale[t] : 0.f;
        vs_s[r] = pid >= 0 ? v_scale[t] : 0.f;
      }
    }
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    for (int r = warp; r < KT; r += kWarps) {
      const int kpos = p0 * page_size + r;
      if (pid_s[r / page_size] < 0 || kpos < lo || kpos >= hi) continue;
      float kf[DPL], vf[DPL];
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = lane + 32 * j;
        if (c < VPR) {
          PageIO<PT>::load(k_s + r * Dh + c * EPC, kf + j * EPC);
          PageIO<PT>::load(v_s + r * Dh + c * EPC, vf + j * EPC);
        } else {
#pragma unroll
          for (int e = 0; e < EPC; ++e) kf[j * EPC + e] = vf[j * EPC + e] = 0.f;
        }
      }
      if constexpr (kQuant) {
        const float ks = ks_s[r], vs = vs_s[r];
#pragma unroll
        for (int e = 0; e < DPL; ++e) {
          kf[e] *= ks;
          vf[e] *= vs;
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) dot = fmaf(qr[g][e], kf[e], dot);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, o);
        if (softcap > 0.f) dot = softcap * tanhf(dot / softcap);
        const float m_new = fmaxf(m[g], dot);
        const float corr = m[g] > kNegInf / 2 ? expf(m[g] - m_new) : 0.f;
        const float p = expf(dot - m_new);
        l[g] = l[g] * corr + p;
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          acc[g][e] = fmaf(p, vf[e], acc[g][e] * corr);
        m[g] = m_new;
      }
    }
  }

  // merge the warps' softmax states: o = sum_w e^(m_w - M) acc_w over
  // sum_w e^(m_w - M) l_w, M the largest m_w
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      wml_s[2 * (warp * G + g)] = m[g];
      wml_s[2 * (warp * G + g) + 1] = l[g];
    }
#pragma unroll
    for (int j = 0; j < CPL; ++j)
#pragma unroll
      for (int e = 0; e < EPC; ++e) {
        const int c = lane + 32 * j;
        if (c < VPR) wacc_s[(warp * G + g) * Dh + c * EPC + e] =
            acc[g][j * EPC + e];
      }
  }
  __syncthreads();
  for (int e = tid; e < G * Dh; e += kThreads) {
    const int g = e / Dh;
    float mx = kNegInf;
    for (int w = 0; w < kWarps; ++w)
      mx = fmaxf(mx, wml_s[2 * (w * G + g)]);
    float lsum = 0.f, o = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float mw = wml_s[2 * (w * G + g)];
      if (mw <= kNegInf / 2) continue;
      const float f = expf(mw - mx);
      lsum += f * wml_s[2 * (w * G + g) + 1];
      o += f * wacc_s[(w * G + g) * Dh + e % Dh];
    }
    if (n_splits > 1) {
      const size_t row = (bh * n_splits + split) * G + g;
      part_o[row * Dh + e % Dh] = o;
      if (e % Dh == 0) {
        part_ml[2 * row] = mx;
        part_ml[2 * row + 1] = lsum;
      }
    } else {
      store(o / (lsum == 0.f ? 1.f : lsum), out + bh * G * Dh + e);
    }
  }
}

// Merges the splits of one (row, head): o = sum_s e^(m_s - M) acc_s /
// sum_s e^(m_s - M) l_s with M the largest m_s; an empty row gives 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    paged_decode_merge_kernel(const float* __restrict__ part_o,
                              const float* __restrict__ part_ml,
                              T* __restrict__ out, int Hkv, int G, int Dh,
                              int n_splits) {
  const size_t bh = static_cast<size_t>(blockIdx.y) * Hkv + blockIdx.x;
  for (int g = 0; g < G; ++g) {
    float mx = kNegInf;
    for (int s = 0; s < n_splits; ++s)
      mx = fmaxf(mx, part_ml[2 * ((bh * n_splits + s) * G + g)]);
    float l = 0.f;
    for (int s = 0; s < n_splits; ++s) {
      const size_t row = (bh * n_splits + s) * G + g;
      const float m = part_ml[2 * row];
      if (m > kNegInf / 2) l += expf(m - mx) * part_ml[2 * row + 1];
    }
    const float inv = l == 0.f ? 1.f : 1.f / l;
    for (int d = threadIdx.x; d < Dh; d += kThreads) {
      float o = 0.f;
      for (int s = 0; s < n_splits; ++s) {
        const size_t row = (bh * n_splits + s) * G + g;
        const float m = part_ml[2 * row];
        if (m > kNegInf / 2) o += expf(m - mx) * part_o[row * Dh + d];
      }
      store(o * inv, out + (bh * G + g) * Dh + d);
    }
  }
}

template <typename PT>
plan::Dims split_dims(int B, int Hkv, int G, int Dh, int page_size,
                      int n_pages, int keys_per_tile, int pages_per_split) {
  const int n_splits = (n_pages + pages_per_split - 1) / pages_per_split;
  return {dim3(n_splits, Hkv, B), kThreads,
          smem_bytes<PT>(G, Dh, keys_per_tile, keys_per_tile / page_size)};
}

inline plan::Dims merge_dims(int B, int Hkv) {
  return {dim3(Hkv, B), kThreads, 0};
}

template <typename T, typename PT>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const float* k_scale, const float* v_scale, const int* table,
           const int* lengths, void* out, float* part_o, float* part_ml,
           int B, int Hkv, int G, int Dh, int page_size, int n_pages,
           int keys_per_tile, int pages_per_split, int window, float softcap,
           float scale, cudaStream_t stream) {
  const plan::Dims d = split_dims<PT>(B, Hkv, G, Dh, page_size, n_pages,
                                      keys_per_tile, pages_per_split);
  static size_t configured = 48 * 1024;  // the default dynamic limit
  if (d.smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel<T, PT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(d.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = d.smem;
  }
  const int n_splits = static_cast<int>(d.grid.x);
  paged_decode_kernel<T, PT><<<d.grid, d.threads, d.smem, stream>>>(
      static_cast<const T*>(q), static_cast<const PT*>(k_pages),
      static_cast<const PT*>(v_pages), k_scale, v_scale, table, lengths,
      static_cast<T*>(out), part_o, part_ml, Hkv, G, Dh, page_size, n_pages,
      keys_per_tile, pages_per_split, window, softcap, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return static_cast<int>(e);
  const plan::Dims m = merge_dims(B, Hkv);
  paged_decode_merge_kernel<T><<<m.grid, m.threads, m.smem, stream>>>(
      part_o, part_ml, static_cast<T*>(out), Hkv, G, Dh, n_splits);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (q, pages and out share it). window < 0
// means no window; softcap <= 0 means no softcap. keys_per_tile is a
// multiple of page_size; pages_per_split a multiple of keys_per_tile /
// page_size. With n_splits = ceil(n_pages / pages_per_split) > 1, part_o
// holds B*Hkv*n_splits*G*Dh floats and part_ml twice B*Hkv*n_splits*G.
// Preconditions (checked by the Python wrapper): contiguous tensors,
// 16-byte aligned, G <= 8, Dh <= 256, Dh * sizeof(dtype) % 16 == 0,
// table entries in [-1, pool pages).
// Returns cudaGetLastError() after the launches.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pages, const void* v_pages, const int* table,
    const int* lengths, void* out, float* part_o, float* part_ml, int B,
    int Hkv, int G, int Dh, int page_size, int n_pages, int keys_per_tile,
    int pages_per_split, int window, float softcap, float scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float>(q, k_pages, v_pages, nullptr, nullptr, table,
                                lengths, out, part_o, part_ml, B, Hkv, G, Dh,
                                page_size, n_pages, keys_per_tile,
                                pages_per_split, window, softcap, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pages, v_pages, nullptr, nullptr, table, lengths, out, part_o,
        part_ml, B, Hkv, G, Dh, page_size, n_pages, keys_per_tile,
        pages_per_split, window, softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The same over int8 pages (P, page, Hkv, Dh) with per-token float32
// scales k_scale, v_scale (P, page); dtype is that of q and out. Further
// precondition: Dh % 16 == 0.
extern "C" int paged_decode_attention_quant(
    const void* q, const void* k_pages, const void* v_pages,
    const float* k_scale, const float* v_scale, const int* table,
    const int* lengths, void* out, float* part_o, float* part_ml, int B,
    int Hkv, int G, int Dh, int page_size, int n_pages, int keys_per_tile,
    int pages_per_split, int window, float softcap, float scale, int dtype,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, int8_t>(q, k_pages, v_pages, k_scale, v_scale, table,
                                 lengths, out, part_o, part_ml, B, Hkv, G, Dh,
                                 page_size, n_pages, keys_per_tile,
                                 pages_per_split, window, softcap, scale, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t>(
        q, k_pages, v_pages, k_scale, v_scale, table, lengths, out, part_o,
        part_ml, B, Hkv, G, Dh, page_size, n_pages, keys_per_tile,
        pages_per_split, window, softcap, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launches paged_decode_attention (quant 0) or
// paged_decode_attention_quant (quant 1) makes for these arguments, from
// the host code it launches with: five ints each (grid x, y, z, threads,
// dynamic shared memory bytes) written to out (room for 2). Returns the
// launch count.
extern "C" int paged_decode_attention_plan(int B, int Hkv, int G, int Dh,
                                           int page_size, int n_pages,
                                           int keys_per_tile,
                                           int pages_per_split, int dtype,
                                           int quant, int* out) {
  const plan::Dims d =
      quant ? split_dims<int8_t>(B, Hkv, G, Dh, page_size, n_pages,
                                 keys_per_tile, pages_per_split)
      : dtype == 0 ? split_dims<float>(B, Hkv, G, Dh, page_size, n_pages,
                                       keys_per_tile, pages_per_split)
                   : split_dims<__nv_bfloat16>(B, Hkv, G, Dh, page_size,
                                               n_pages, keys_per_tile,
                                               pages_per_split);
  plan::put(out, 0, d);
  if (d.grid.x == 1) return 1;
  plan::put(out, 1, merge_dims(B, Hkv));
  return 2;
}
