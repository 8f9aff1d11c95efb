// flash_attention — full-sequence GQA attention for training, forward and
// backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:flash_attention
// (Pallas body _flash_kernel): for every (batch row b, query head h) the
// queries attend to the keys of KV head h / G under the causal mask
// kpos <= qpos + q_offset, an optional sliding window
// kpos > qpos + q_offset - window and an optional tanh softcap, with an
// online softmax in f32; a row with no visible key gives 0. The forward also
// writes each row's log-sum-exp lse (-1e30 for a row with no visible key).
// The reference has no backward kernel (JAX differentiates its XLA chunked
// attention); the backward here recomputes the probabilities from lse:
//   D = rowsum(dO * O), P = exp(s - lse), dS = P (dO V^T - D),
//   times 1 - tanh^2 under a softcap; dQ = scale dS K, dK = scale dS^T Q,
//   dV = P^T dO, dK and dV summed over the G query heads of a KV head.
//
// What bounds it on the card: operations. A visible (query, key) pair costs
// 4 Dh operations forward (q.k and p.v) and 10 Dh backward (q.k, dO.v,
// dS.K, dS^T.Q and P^T.dO), against 2 Dh bf16 bytes of K and V shared by a
// whole tile of queries. At gemma3-4b's training shapes (B 2, S 2048, Hq 8,
// Dh 256) a global layer's forward is 34 GFLOP against 50 MB: about 35 us
// at the bf16 tensor-core peak and 15 us of bytes. The backward here
// executes 16 Dh per visible pair, not 10: dq and dk/dv each recompute the
// scores (q.k twice more, dO.v once more) because the two launches share
// nothing but D, and dk/dv's two consumers each compute q.k (see
// flash_dkv_wgmma_kernel).
//
// What the design does about it: the Pallas grid walks every KV block and
// masks; here each CTA loops only over the tiles that hold a visible pair
// (causal: up to the tile of its last query; window: from the tile of its
// first query's oldest key), which is what the XLA chunked form does with
// its window span. bf16 (the training path) runs on Hopper's wgmma fed by
// TMA, the scores and probabilities kept in registers (see "bf16: wgmma fed
// by TMA" below); P and dS are rounded to bf16 for their products (one
// rounding, 2^-9 relative, of each: the bf16 limits cover it), all sums in
// f32. f32 inputs take a plan of 64-row CTAs of 8 warps on the CUDA cores
// (32-key tiles, scores through shared memory) in full f32, so that an f32
// step compares with the plain version at f32 summation order. The
// backward is two launches and no atomics: (a) dq (and D) per query tile
// over its visible key tiles; (b) dk/dv per key tile, looping over the G
// query heads of its KV head and their visible query tiles in a fixed
// order inside the CTA. Every sum is taken in one fixed order, so two runs
// agree bit for bit. Ragged edges (S not a multiple of the tile) are
// zero-filled on load, masked and guarded on store.
#include "csd_spmm_common.cuh"
#include "hopper.cuh"

namespace {

using csd::cp_async16;
using csd::cp_async_commit;
using csd::cp_async_wait;
using csd::store;
using csd::to_f32;

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps (f32)
constexpr int kRows = 64;      // rows an f32 CTA owns
constexpr float kNegInf = -1e30f;
constexpr int kMaxSmem = 232448;

struct Params {
  const void* q;     // (B, Sq, Hq, Dh)
  const void* k;     // (B, Skv, Hkv, Dh)
  const void* v;     // (B, Skv, Hkv, Dh)
  const void* o;     // (B, Sq, Hq, Dh): forward output (backward input)
  const void* dout;  // (B, Sq, Hq, Dh)
  void* out;         // forward output
  float* lse;        // (B, Hq, Sq)
  float* delta;      // (B, Hq, Sq): rowsum(dO * O), written by dq
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Skv, Hq, Hkv, Dh, G;
  int causal, window, q_offset;  // window < 0: none
  float softcap, scale;          // softcap 0: none
};

__device__ __forceinline__ bool visible(const Params& p, int qi, int kj) {
  if (qi >= p.Sq || kj >= p.Skv) return false;
  const int qpos = qi + p.q_offset;
  if (p.causal && kj > qpos) return false;
  if (p.window >= 0 && kj <= qpos - p.window) return false;
  return true;
}

__device__ __forceinline__ float logit(const Params& p, float dot) {
  float s = dot * p.scale;
  if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
  return s;
}

// Keys [lo, hi) that some query of [q0, q0 + rows) may see.
__device__ __forceinline__ void key_range(const Params& p, int q0, int rows,
                                          int* lo, int* hi) {
  const int q_last = min(q0 + rows, p.Sq) - 1;
  *lo = 0;
  *hi = p.Skv;
  if (p.causal) *hi = min(*hi, q_last + p.q_offset + 1);
  if (p.window >= 0) *lo = max(*lo, q0 + p.q_offset - p.window + 1);
}

// Queries [lo, hi) that may see some key of [k0, k0 + rows).
__device__ __forceinline__ void query_range(const Params& p, int k0,
                                            int rows, int* lo, int* hi) {
  const int k_last = min(k0 + rows, p.Skv) - 1;
  *lo = 0;
  *hi = p.Sq;
  if (p.causal) *lo = max(*lo, k0 - p.q_offset);
  if (p.window >= 0) *hi = min(*hi, k_last - p.q_offset + p.window);
}

// n_rows rows of Dh elements, row r of src at src + r * stride, starting at
// row0, into dst with row stride ld; rows at or past limit are zero-filled.
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int ld, const T* src,
                                          size_t stride, int row0,
                                          int n_rows, int limit, int Dh) {
  constexpr int E = 16 / sizeof(T);
  const int cpr = Dh / E;
  for (int c = threadIdx.x; c < n_rows * cpr; c += kThreads) {
    const int r = c / cpr;
    const int e = (c - r * cpr) * E;
    const bool ok = row0 + r < limit;
    cp_async16(dst + r * ld + e,
               src + static_cast<size_t>(ok ? row0 + r : 0) * stride + e, ok);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// f32: the engine of the CUDA-core kernels, the products a CTA of 256
// threads needs over tiles in shared memory.
//   scores(out, A, B): out[r][c] = sum_d A[r][d] B[c][d] (f32) for the
//     kRows rows of A and the C rows of B;
//   nn(A, B): acc[r][:] += sum_c A[r][c] B[c][:], A (kRows x C) and B
//     (C x Dh) in the storage type, acc in f32 registers;
//   scale_rows(f): acc[r][:] *= f[r]; store(...): acc (times a row factor
//     and a constant) to global rows.
// ---------------------------------------------------------------------------

template <typename T, int DHMAX>
struct Engine;

// f32 on the CUDA cores. Thread t owns row t / 4 and, of it, the 16-byte
// chunks part + 4 i (part = t % 4) of the head dims.
template <int DHMAX>
struct Engine<float, DHMAX> {
  static constexpr int C = 32;    // streamed tile rows
  static constexpr int kPad = 4;  // row padding of the tiles, elements
  static constexpr int NG = DHMAX / 16;
  float acc[NG][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  __device__ static void scores(float* out, int ldo, const float* A,
                                int lda, const float* B, int ldb, int Dh) {
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
    float s[C / 4];
#pragma unroll
    for (int i = 0; i < C / 4; ++i) s[i] = 0.f;
    const float* a = A + r * lda;
    for (int d = 0; d < Dh; d += 4) {
      const float4 av = *reinterpret_cast<const float4*>(a + d);
#pragma unroll
      for (int i = 0; i < C / 4; ++i) {
        const float4 bv =
            *reinterpret_cast<const float4*>(B + (part + 4 * i) * ldb + d);
        s[i] = fmaf(av.x, bv.x, s[i]);
        s[i] = fmaf(av.y, bv.y, s[i]);
        s[i] = fmaf(av.z, bv.z, s[i]);
        s[i] = fmaf(av.w, bv.w, s[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < C / 4; ++i) out[r * ldo + part + 4 * i] = s[i];
  }

  __device__ void nn(const float* A, int lda, const float* B, int ldb,
                     int Dh) {
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
    const int ng = Dh / 16;
    for (int c = 0; c < C; ++c) {
      const float a = A[r * lda + c];
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        if (i < ng) {
          const float4 b = *reinterpret_cast<const float4*>(
              B + c * ldb + 4 * (part + 4 * i));
          acc[i][0] = fmaf(a, b.x, acc[i][0]);
          acc[i][1] = fmaf(a, b.y, acc[i][1]);
          acc[i][2] = fmaf(a, b.z, acc[i][2]);
          acc[i][3] = fmaf(a, b.w, acc[i][3]);
        }
      }
    }
  }

  __device__ void scale_rows(const float* f) {
    const float x = f[threadIdx.x >> 2];
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= x;
  }

  // rows row0 + r < limit of dst (row r at dst + r * stride), each times
  // f[r] (when given) and mult
  __device__ void store_rows(float* dst, size_t stride, int row0, int limit,
                             const float* f, float mult, int Dh) const {
    const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
    if (row0 + r >= limit) return;
    const float x = (f != nullptr ? f[r] : 1.f) * mult;
    float* row = dst + static_cast<size_t>(row0 + r) * stride;
#pragma unroll
    for (int i = 0; i < NG; ++i) {
      if (i < Dh / 16) {
        *reinterpret_cast<float4*>(row + 4 * (part + 4 * i)) = make_float4(
            acc[i][0] * x, acc[i][1] * x, acc[i][2] * x, acc[i][3] * x);
      }
    }
  }
};

// Shared-memory carve-up, the same on host and device. Tiles of T with rows
// padded by kPad elements; score tiles f32 with rows of C + 4; the
// probability and dS tiles (storage type, rows of C + kPad) alias the f32
// score tiles when T is f32, where each element is rewritten in place by
// the thread that read it. The streamed tiles (and their per-row lse and
// D) have two buffers where both fit, so that the next tile's copy runs
// under the current tile's products, else one.
template <typename T, int DHMAX>
struct Layout {
  typedef Engine<T, DHMAX> E;
  static constexpr int C = E::C;
  static constexpr bool kAlias = std::is_same<T, float>::value;
  int ld, lds, ldp;
  size_t tile_own, tile_stream, scores, probs;
  __host__ __device__ explicit Layout(int Dh)
      : ld(Dh + E::kPad), lds(C + 4), ldp(C + E::kPad) {
    tile_own = static_cast<size_t>(kRows) * ld * sizeof(T);
    tile_stream = static_cast<size_t>(C) * ld * sizeof(T);
    scores = static_cast<size_t>(kRows) * lds * sizeof(float);
    probs = kAlias ? 0 : static_cast<size_t>(kRows) * ldp * sizeof(T);
  }
  // forward: q (own), k, v (streamed), S, P, row factor
  __host__ __device__ size_t fwd_bytes(int stages) const {
    return tile_own + 2 * stages * tile_stream + scores + probs + kRows * 4;
  }
  // dq: q, dO (own), k, v (streamed), S, dP, dS, lse, D
  __host__ __device__ size_t dq_bytes(int stages) const {
    return 2 * tile_own + 2 * stages * tile_stream + 2 * scores + probs +
           2 * kRows * 4;
  }
  // dk/dv: k, v (own), q, dO, lse, D (streamed), S^T, dP^T, P^T, dS^T
  __host__ __device__ size_t dkv_bytes(int stages) const {
    return 2 * tile_own + stages * (2 * tile_stream + 2 * C * 4) +
           2 * scores + 2 * probs;
  }
  __host__ __device__ static int stages_for(size_t two_stage_bytes) {
    return two_stage_bytes <= static_cast<size_t>(kMaxSmem) ? 2 : 1;
  }
  __host__ __device__ int fwd_stages() const {
    return stages_for(fwd_bytes(2));
  }
  __host__ __device__ int dq_stages() const { return stages_for(dq_bytes(2)); }
  __host__ __device__ int dkv_stages() const {
    return stages_for(dkv_bytes(2));
  }
};


// Whether every query of [qa, qb) sees every key of [ka, kb): then the row
// phases skip the per-entry mask.
__device__ __forceinline__ bool all_visible(const Params& p, int qa, int qb,
                                            int ka, int kb) {
  return qb <= p.Sq && kb <= p.Skv &&
         (!p.causal || kb - 1 <= qa + p.q_offset) &&
         (p.window < 0 || ka > qb - 1 + p.q_offset - p.window);
}

// This CTA's query tile along gridDim.x; under a causal mask the last query
// tiles see the most keys and are handed out first, which evens out the
// last wave.
__device__ __forceinline__ int tile_first(bool last_first) {
  return last_first ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
}

// The row phases: thread t works on row t / 4 and, of it, the columns
// t % 4 + 4 j (j < CPT), which keeps the 32 lanes of a warp on 32 banks.

template <typename T, int DHMAX>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  typedef Engine<T, DHMAX> E;
  constexpr int C = E::C;
  constexpr int CPT = C / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dh = p.Dh;
  const Layout<T, DHMAX> L(Dh);
  const int stages = L.fwd_stages();
  T* q_s = reinterpret_cast<T*>(smem);
  unsigned char* stream = smem + L.tile_own;  // per stage: k, v
  float* s_s = reinterpret_cast<float*>(stream + 2 * stages * L.tile_stream);
  unsigned char* after_s = reinterpret_cast<unsigned char*>(s_s) + L.scores;
  T* p_s = Layout<T, DHMAX>::kAlias ? reinterpret_cast<T*>(s_s)
                                    : reinterpret_cast<T*>(after_s);
  float* f_s = reinterpret_cast<float*>(after_s + L.probs);

  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.G;
  const int q0 = tile_first(p.causal) * kRows;
  const size_t q_stride = static_cast<size_t>(p.Hq) * Dh;
  const size_t kv_stride = static_cast<size_t>(p.Hkv) * Dh;
  const size_t kv_base = (static_cast<size_t>(b) * p.Skv * p.Hkv + hk) * Dh;
  const T* kg = static_cast<const T*>(p.k) + kv_base;
  const T* vg = static_cast<const T*>(p.v) + kv_base;
  const size_t q_base = (static_cast<size_t>(b) * p.Sq * p.Hq + h) * Dh;
  auto k_tile = [=](int st) {
    return reinterpret_cast<T*>(stream + 2 * st * L.tile_stream);
  };
  auto v_tile = [=](int st) {
    return reinterpret_cast<T*>(stream + (2 * st + 1) * L.tile_stream);
  };
  auto load_kv = [=](int t, int st) {
    load_rows(k_tile(st), L.ld, kg, kv_stride, t * C, C, p.Skv, Dh);
    load_rows(v_tile(st), L.ld, vg, kv_stride, t * C, C, p.Skv, Dh);
    cp_async_commit();
  };

  load_rows(q_s, L.ld, static_cast<const T*>(p.q) + q_base, q_stride, q0,
            kRows, p.Sq, Dh);
  cp_async_commit();

  E eng;
  eng.zero();
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  float m = kNegInf, l = 0.f;  // row r's running max and sum
  int lo, hi;
  key_range(p, q0, kRows, &lo, &hi);
  const int t_lo = lo / C, t_hi = hi > lo ? (hi + C - 1) / C : t_lo;
  for (int t = t_lo; t < t_hi; ++t) {
    const int st = stages == 2 ? (t - t_lo) & 1 : 0;
    if (stages == 1 || t == t_lo) {
      __syncthreads();  // every thread is done with the buffer
      load_kv(t, st);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (stages == 2 && t + 1 < t_hi) load_kv(t + 1, st ^ 1);
    const int k0 = t * C;
    E::scores(s_s, L.lds, q_s, L.ld, k_tile(st), L.ld, Dh);
    __syncthreads();
    const bool full = all_visible(p, q0, q0 + kRows, k0, k0 + C);
    float sv[CPT];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = part + 4 * j;
      float x = logit(p, s_s[r * L.lds + c]);
      if (!full && !visible(p, q0 + r, k0 + c)) x = kNegInf;
      sv[j] = x;
      tmax = fmaxf(tmax, x);
    }
    const float m_new = fmaxf(m, quad_max(tmax));
    const float corr = m > kNegInf / 2 ? expf(m - m_new) : 0.f;
    const bool live = m_new > kNegInf / 2;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float pe = live ? expf(sv[j] - m_new) : 0.f;
      sum += pe;
      store(pe, p_s + r * L.ldp + part + 4 * j);
    }
    l = corr * l + quad_sum(sum);
    m = m_new;
    if (part == 0) f_s[r] = corr;
    __syncthreads();
    eng.scale_rows(f_s);
    eng.nn(p_s, L.ldp, v_tile(st), L.ld, Dh);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (part == 0) {
    f_s[r] = 1.f / (l == 0.f ? 1.f : l);
    if (q0 + r < p.Sq)
      p.lse[(static_cast<size_t>(b) * p.Hq + h) * p.Sq + q0 + r] =
          l > 0.f ? m + logf(l) : kNegInf;
  }
  __syncthreads();
  eng.store_rows(static_cast<T*>(p.out) + q_base, q_stride, q0, p.Sq, f_s,
                 1.f, Dh);
}

// dS of one (row, column) entry from its raw score: the probability
// recomputed from lse, times (dP - D), times the softcap's derivative
template <typename T>
__device__ __forceinline__ void grad_entry(const Params& p, bool vis,
                                           float raw, float dp, float lse,
                                           float delta, float* prob,
                                           float* ds) {
  const float x = logit(p, raw);
  const float pe = vis ? expf(x - lse) : 0.f;
  float g = pe * (dp - delta);
  if (p.softcap > 0.f) {
    const float th = x / p.softcap;
    g *= 1.f - th * th;
  }
  *prob = pe;
  *ds = g;
}

template <typename T, int DHMAX>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const Params p) {
  typedef Engine<T, DHMAX> E;
  constexpr int C = E::C;
  constexpr int CPT = C / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dh = p.Dh;
  const Layout<T, DHMAX> L(Dh);
  const int stages = L.dq_stages();
  T* q_s = reinterpret_cast<T*>(smem);
  T* do_s = reinterpret_cast<T*>(smem + L.tile_own);
  unsigned char* stream = smem + 2 * L.tile_own;  // per stage: k, v
  float* s_s = reinterpret_cast<float*>(stream + 2 * stages * L.tile_stream);
  float* dp_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(s_s) + L.scores);
  unsigned char* after = reinterpret_cast<unsigned char*>(dp_s) + L.scores;
  T* ds_s = Layout<T, DHMAX>::kAlias ? reinterpret_cast<T*>(dp_s)
                                     : reinterpret_cast<T*>(after);
  float* lse_s = reinterpret_cast<float*>(after + L.probs);
  float* d_s = lse_s + kRows;

  const int h = blockIdx.y, b = blockIdx.z, hk = h / p.G;
  const int q0 = tile_first(p.causal) * kRows;
  const size_t q_stride = static_cast<size_t>(p.Hq) * Dh;
  const size_t kv_stride = static_cast<size_t>(p.Hkv) * Dh;
  const size_t q_base = (static_cast<size_t>(b) * p.Sq * p.Hq + h) * Dh;
  const size_t kv_base = (static_cast<size_t>(b) * p.Skv * p.Hkv + hk) * Dh;
  const T* kg = static_cast<const T*>(p.k) + kv_base;
  const T* vg = static_cast<const T*>(p.v) + kv_base;
  const size_t row_base = (static_cast<size_t>(b) * p.Hq + h) * p.Sq;
  auto k_tile = [=](int st) {
    return reinterpret_cast<T*>(stream + 2 * st * L.tile_stream);
  };
  auto v_tile = [=](int st) {
    return reinterpret_cast<T*>(stream + (2 * st + 1) * L.tile_stream);
  };
  auto load_kv = [=](int t, int st) {
    load_rows(k_tile(st), L.ld, kg, kv_stride, t * C, C, p.Skv, Dh);
    load_rows(v_tile(st), L.ld, vg, kv_stride, t * C, C, p.Skv, Dh);
    cp_async_commit();
  };

  load_rows(q_s, L.ld, static_cast<const T*>(p.q) + q_base, q_stride, q0,
            kRows, p.Sq, Dh);
  load_rows(do_s, L.ld, static_cast<const T*>(p.dout) + q_base, q_stride, q0,
            kRows, p.Sq, Dh);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // D = rowsum(dO * O) of row r, its four threads over interleaved dims
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const bool row_ok = q0 + r < p.Sq;
  float dsum = 0.f;
  if (row_ok) {
    const T* og = static_cast<const T*>(p.o) + q_base +
                  static_cast<size_t>(q0 + r) * q_stride;
    for (int d = part; d < Dh; d += 4)
      dsum = fmaf(to_f32(do_s[r * L.ld + d]), to_f32(og[d]), dsum);
  }
  dsum = quad_sum(dsum);
  if (part == 0) {
    d_s[r] = row_ok ? dsum : 0.f;
    lse_s[r] = row_ok ? p.lse[row_base + q0 + r] : 0.f;
    if (row_ok) p.delta[row_base + q0 + r] = dsum;
  }

  E eng;
  eng.zero();
  int lo, hi;
  key_range(p, q0, kRows, &lo, &hi);
  const int t_lo = lo / C, t_hi = hi > lo ? (hi + C - 1) / C : t_lo;
  for (int t = t_lo; t < t_hi; ++t) {
    const int st = stages == 2 ? (t - t_lo) & 1 : 0;
    if (stages == 1 || t == t_lo) {
      __syncthreads();
      load_kv(t, st);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (stages == 2 && t + 1 < t_hi) load_kv(t + 1, st ^ 1);
    const int k0 = t * C;
    E::scores(s_s, L.lds, q_s, L.ld, k_tile(st), L.ld, Dh);
    E::scores(dp_s, L.lds, do_s, L.ld, v_tile(st), L.ld, Dh);
    __syncthreads();
    const bool full = all_visible(p, q0, q0 + kRows, k0, k0 + C);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = part + 4 * j;
      float pe, ds;
      grad_entry<T>(p, full || visible(p, q0 + r, k0 + c),
                    s_s[r * L.lds + c], dp_s[r * L.lds + c], lse_s[r],
                    d_s[r], &pe, &ds);
      store(ds, ds_s + r * L.ldp + c);
    }
    __syncthreads();
    eng.nn(ds_s, L.ldp, k_tile(st), L.ld, Dh);
  }
  eng.store_rows(static_cast<T*>(p.dq) + q_base, q_stride, q0, p.Sq, nullptr,
                 p.scale, Dh);
}

template <typename T, int DHMAX>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const Params p) {
  typedef Engine<T, DHMAX> E;
  constexpr int C = E::C;
  constexpr int CPT = C / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Dh = p.Dh;
  const Layout<T, DHMAX> L(Dh);
  const int stages = L.dkv_stages();
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = reinterpret_cast<T*>(smem + L.tile_own);
  // per stage: q, dO, lse, D
  unsigned char* stream = smem + 2 * L.tile_own;
  const size_t stage_bytes = 2 * L.tile_stream + 2 * C * 4;
  float* s_s = reinterpret_cast<float*>(stream + stages * stage_bytes);
  float* dp_s = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(s_s) + L.scores);
  unsigned char* after = reinterpret_cast<unsigned char*>(dp_s) + L.scores;
  constexpr bool kAlias = Layout<T, DHMAX>::kAlias;
  T* p_s = kAlias ? reinterpret_cast<T*>(s_s) : reinterpret_cast<T*>(after);
  T* ds_s = kAlias ? reinterpret_cast<T*>(dp_s)
                   : reinterpret_cast<T*>(after + L.probs);

  const int hk = blockIdx.y, b = blockIdx.z;
  // under a causal mask the first key tiles see the most queries and
  // are handed out first already
  const int k0 = blockIdx.x * kRows;
  const size_t q_stride = static_cast<size_t>(p.Hq) * Dh;
  const size_t kv_stride = static_cast<size_t>(p.Hkv) * Dh;
  const size_t kv_base = (static_cast<size_t>(b) * p.Skv * p.Hkv + hk) * Dh;
  auto q_tile = [=](int st) {
    return reinterpret_cast<T*>(stream + st * stage_bytes);
  };
  auto do_tile = [=](int st) {
    return reinterpret_cast<T*>(stream + st * stage_bytes + L.tile_stream);
  };
  auto lse_tile = [=](int st) {
    return reinterpret_cast<float*>(stream + st * stage_bytes +
                                    2 * L.tile_stream);
  };
  int lo, hi;
  query_range(p, k0, kRows, &lo, &hi);
  const int t_lo = lo / C, t_hi = hi > lo ? (hi + C - 1) / C : t_lo;
  const int n_t = t_hi - t_lo;
  // tile i of the walk: query head hk * G + i / n_t, query tile
  // t_lo + i % n_t
  auto load_q = [=](int i, int st) {
    const int h = hk * p.G + i / n_t, q0 = (t_lo + i % n_t) * C;
    const size_t q_base = (static_cast<size_t>(b) * p.Sq * p.Hq + h) * Dh;
    const size_t row_base = (static_cast<size_t>(b) * p.Hq + h) * p.Sq;
    load_rows(q_tile(st), L.ld, static_cast<const T*>(p.q) + q_base,
              q_stride, q0, C, p.Sq, Dh);
    load_rows(do_tile(st), L.ld, static_cast<const T*>(p.dout) + q_base,
              q_stride, q0, C, p.Sq, Dh);
    cp_async_commit();
    float* lse_s = lse_tile(st);
    for (int j = threadIdx.x; j < C; j += kThreads) {
      const bool ok = q0 + j < p.Sq;
      lse_s[j] = ok ? p.lse[row_base + q0 + j] : 0.f;
      lse_s[C + j] = ok ? p.delta[row_base + q0 + j] : 0.f;
    }
  };

  load_rows(k_s, L.ld, static_cast<const T*>(p.k) + kv_base, kv_stride, k0,
            kRows, p.Skv, Dh);
  load_rows(v_s, L.ld, static_cast<const T*>(p.v) + kv_base, kv_stride, k0,
            kRows, p.Skv, Dh);
  cp_async_commit();

  E dk, dv;
  dk.zero();
  dv.zero();
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;  // r: a key row
  const int n_tiles = p.G * n_t;
  for (int i = 0; i < n_tiles; ++i) {
    const int st = stages == 2 ? i & 1 : 0;
    if (stages == 1 || i == 0) {
      __syncthreads();
      load_q(i, st);
    }
    cp_async_wait<0>();
    __syncthreads();
    if (stages == 2 && i + 1 < n_tiles) load_q(i + 1, st ^ 1);
    const int q0 = (t_lo + i % n_t) * C;
    const T* q_s = q_tile(st);
    const T* do_s = do_tile(st);
    const float* lse_s = lse_tile(st);
    E::scores(s_s, L.lds, k_s, L.ld, q_s, L.ld, Dh);
    E::scores(dp_s, L.lds, v_s, L.ld, do_s, L.ld, Dh);
    __syncthreads();
    const bool full = all_visible(p, q0, q0 + C, k0, k0 + kRows);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = part + 4 * j;  // a query of the tile
      float pe, ds;
      grad_entry<T>(p, full || visible(p, q0 + c, k0 + r),
                    s_s[r * L.lds + c], dp_s[r * L.lds + c], lse_s[c],
                    lse_s[C + c], &pe, &ds);
      store(pe, p_s + r * L.ldp + c);
      store(ds, ds_s + r * L.ldp + c);
    }
    __syncthreads();
    dv.nn(p_s, L.ldp, do_s, L.ld, Dh);
    dk.nn(ds_s, L.ldp, q_s, L.ld, Dh);
  }
  cp_async_wait<0>();  // the K/V tiles, where no query tile was visited
  dk.store_rows(static_cast<T*>(p.dk) + kv_base, kv_stride, k0, p.Skv,
                nullptr, p.scale, Dh);
  dv.store_rows(static_cast<T*>(p.dv) + kv_base, kv_stride, k0, p.Skv,
                nullptr, 1.f, Dh);
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA
//
// Each CTA is a producer warpgroup and two consumer warpgroups (384
// threads). Thread 0 of the producer keeps rings of streamed tiles in
// flight through TMA, each tile completing on an mbarrier; the consumers run
// wgmma on 64 rows each with the f32 accumulators in registers. Every
// operand is a tile of (B, S, H, Dh) rows read through a 4-D tensor map
// (Dh, H, S, B), so a tile never reaches into the next batch row: rows past
// S and head dims past Dh read as zeros. A row tile is Dh / 64 boxes of
// rows x 64 bf16 (128-byte swizzle); Dh is taken up to the bucket DH (64,
// 128, 256) by those zeros, which add nothing to a product, and the stores
// skip the head dims past Dh. The scores S (and dP) of a tile are the
// accumulators of one wgmma with both operands K-major in shared memory;
// the row phase (scale, mask, online softmax or the gradient's P and dS)
// acts on them in registers, where each thread holds two rows' fragments
// and a row's four threads are one quad (two __shfl_xor); the products
// P V, dS K, P^T dO and dS^T Q take that fragment, packed to bf16, as
// their A operand straight from registers, with B MN-major (the transpose
// bit) from the same swizzled tiles. No score leaves the registers, and the
// key loop has no __syncthreads: only mbarrier waits.
// ---------------------------------------------------------------------------

constexpr int kHThreads = 384;  // producer warpgroup + two consumers
constexpr int kBox = 128;       // bytes of one swizzled box row (64 bf16)
constexpr int kStages = 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The tiles of the three kernels at head-dim bucket DH, and their dynamic
// shared memory (1024 bytes to align the boxes, then the tiles, then the
// mbarriers). At DH 256 two stages of each ring fit the 227 KiB a CTA
// may opt into only with 64 streamed keys in the forward, and in dq only
// with one stage of V (freed right after dP = dO V^T, so that the next V
// arrives under the rest of the tile's work).
//   forward: 128 query rows (64 per consumer); a ring of FWD_BK rows of K
//     and one of V.
//   dq: 128 query rows of Q and dO; a ring of DQ_BK rows of K (two stages)
//     and one of V (DQ_VSLOTS stages).
//   dk/dv: DKV_ROWS key rows of K and V; per stage DKV_BQ rows of Q and
//     dO and those rows' lse and D (f32).
template <int DH>
struct Tiles {
  static constexpr int NB = DH / 64;  // boxes per row tile
  static constexpr int FWD_BK = DH == 256 ? 64 : 128;
  static constexpr int DQ_BK = 64;
  static constexpr int DQ_VSLOTS = DH == 256 ? 1 : kStages;
  static constexpr int DKV_BQ = 64;
  // dk/dv: each consumer owns 64 keys of 128 (DH <= 128), or both own the
  // same 64 and split the work by output (DH 256)
  static constexpr bool DKV_OWN = DH <= 128;
  static constexpr int DKV_ROWS = DKV_OWN ? 128 : 64;
  // the mbarriers of `rings` rings (Bars)
  static constexpr int bars(int rings) { return 8 * (1 + 2 * kStages * rings); }
  static constexpr int FWD_SMEM =
      1024 + NB * 128 * kBox + kStages * 2 * NB * FWD_BK * kBox + bars(2);
  static constexpr int DQ_SMEM = 1024 + 2 * NB * 128 * kBox +
                                 (kStages + DQ_VSLOTS) * NB * DQ_BK * kBox +
                                 bars(2);
  static constexpr int DKV_SMEM = 1024 + 2 * NB * DKV_ROWS * kBox +
                                  kStages * (2 * NB * DKV_BQ * kBox +
                                             2 * DKV_BQ * 4) +
                                  bars(1);
};

// wgmma descriptor of k step kk (16 elements) of a K-major operand whose
// rows are NB boxes of box_bytes each: box kk / 4, 32 bytes per step
// inside the swizzled row.
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int box_bytes,
                                           int kk) {
  return hopper::make_desc(tile + (kk >> 2) * box_bytes + (kk & 3) * 32, 16,
                           1024);
}

// wgmma descriptor of k step kk of an MN-major B operand: the tile's rows
// run along K (16 per step), its NB boxes of box_bytes along N.
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int box_bytes,
                                            int kk) {
  return hopper::make_desc(tile + kk * 16 * kBox, box_bytes, 1024);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operands of the next product from an m64nN accumulator fragment:
// k step j takes elements 8 j .. 8 j + 7 (hopper::wgmma_rs).
template <int N>
__device__ __forceinline__ void to_a(uint32_t (&a)[N / 16][4],
                                     const float (&d)[N / 2]) {
#pragma unroll
  for (int j = 0; j < N / 16; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[j][i] = pack_bf16(d[8 * j + 2 * i], d[8 * j + 2 * i + 1]);
}

template <int N>
__device__ __forceinline__ void zero(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) d[i] = 0.f;
}

// Rows r0 and r0 + 8 of an m64nN accumulator fragment (N = DH) into rows
// of a (B, S, H, Dh) bf16 tensor, times f[0] and f[1]; rows at or past
// limit and head dims past Dh are skipped.
template <int DH>
__device__ __forceinline__ void store_frag(bf16* dst, const float (&d)[DH / 2],
                                           int r0, int limit, int heads,
                                           int head, int b, int Dh, int tid,
                                           const float (&f)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    if (row >= limit) continue;
    bf16* out = dst + ((static_cast<size_t>(b) * limit + row) * heads + head) *
                          static_cast<size_t>(Dh);
#pragma unroll
    for (int q = 0; q < DH / 8; ++q) {
      const int col = hopper::frag_col(tid, q);
      if (col < Dh)
        *reinterpret_cast<__nv_bfloat162*>(out + col) = __floats2bfloat162_rn(
            d[4 * q + 2 * i] * f[i], d[4 * q + 2 * i + 1] * f[i]);
    }
  }
}

// The barriers behind the tiles: the once-loaded tile's, then, for each
// ring r of streamed tiles, its kStages full and kStages empty ones.
struct Bars {
  uint32_t base;
  __device__ uint32_t own() const { return base; }
  __device__ uint32_t full(int s, int r = 0) const {
    return base + 8 * (1 + 2 * kStages * r + s);
  }
  __device__ uint32_t empty(int s, int r = 0) const {
    return base + 8 * (1 + 2 * kStages * r + kStages + s);
  }
  // full: one arrival with the TMA bytes (and `extra` more); empty: every
  // consumer thread
  __device__ void init(int rings, int extra) const {
    hopper::mbar_init(own(), 1);
    for (int r = 0; r < rings; ++r)
      for (int s = 0; s < kStages; ++s) {
        hopper::mbar_init(full(s, r), 1 + extra);
        hopper::mbar_init(empty(s, r), 256);
      }
    hopper::fence_barrier_init();
  }
};

// A consumer's side of the rings: tile t of the CTA's walk from t_lo sits
// in slot (t - t_lo) % n of a ring of n slots, in phase (t - t_lo) / n.
struct Ring {
  Bars bars;
  int t_lo;
  int slots1 = kStages;  // ring 1's slots; ring 0 has kStages
  __device__ int n(int r) const { return r == 0 ? kStages : slots1; }
  __device__ int slot(int t, int r) const { return (t - t_lo) % n(r); }
  __device__ void wait(int t, int r) const {
    hopper::mbar_wait(bars.full(slot(t, r), r), ((t - t_lo) / n(r)) & 1);
  }
  __device__ void release(int t, int r) const {
    hopper::mbar_arrive(bars.empty(slot(t, r), r));
  }
  // a tile this consumer has no work in: it still takes part in each ring,
  // after the tile has arrived (an early arrival would count towards the
  // slot's previous phase)
  __device__ void pass(int t, int rings) const {
    for (int r = 0; r < rings; ++r) {
      wait(t, r);
      release(t, r);
    }
  }
};

// This CTA's (tile, head, batch row) of a (tiles, heads, batch) grid. The
// CTAs start in the order of their linear index, so it is read with the
// tile slowest and, where last_first, the last tile first: the first wave
// takes the longest tiles of every head and batch row, not every tile of
// the first few.
__device__ __forceinline__ int3 tile_of(bool last_first) {
  const int hb = gridDim.y * gridDim.z;
  const int lin =
      blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  int t = lin / hb;
  const int r = lin - t * hb;
  if (last_first) t = gridDim.x - 1 - t;
  return make_int3(t, r % gridDim.y, r / gridDim.y);
}

// The producer's side of the forward's and dq's rings: K tiles t of [t_lo,
// t_hi) (BK keys of KV head hk, batch row b) into ring 0 of kStages slots,
// V tiles into ring 1 of VS slots, each slot reused once every consumer
// has released it.
template <int NB, int BK, int VS>
__device__ __forceinline__ void produce_kv(const Bars& bars, uint32_t k_ring,
                                           uint32_t v_ring,
                                           const CUtensorMap* tm_k,
                                           const CUtensorMap* tm_v, int hk,
                                           int b, int t_lo, int t_hi) {
  constexpr int TILE = NB * BK * kBox;
  for (int t = t_lo; t < t_hi; ++t) {
    const int it = t - t_lo, s = it % kStages, sv = it % VS;
    hopper::mbar_wait(bars.empty(s, 0), ((it / kStages) & 1) ^ 1);
    hopper::mbar_expect_tx(bars.full(s, 0), TILE);
    for (int i = 0; i < NB; ++i)
      hopper::tma_load_4d(k_ring + s * TILE + i * BK * kBox, tm_k,
                          bars.full(s, 0), 64 * i, hk, t * BK, b);
    hopper::mbar_wait(bars.empty(sv, 1), ((it / VS) & 1) ^ 1);
    hopper::mbar_expect_tx(bars.full(sv, 1), TILE);
    for (int i = 0; i < NB; ++i)
      hopper::tma_load_4d(v_ring + sv * TILE + i * BK * kBox, tm_v,
                          bars.full(sv, 1), 64 * i, hk, t * BK, b);
  }
}

// The tiles [w0, w1) of bk keys, within the CTA's [t_lo, t_hi), that hold
// a key one of the 64 query rows from q0w sees; empty where they see none.
__device__ __forceinline__ void own_tiles(const Params& p, int q0w, int bk,
                                          int t_lo, int t_hi, int* w0,
                                          int* w1) {
  int lo, hi;
  key_range(p, q0w, 64, &lo, &hi);
  if (q0w >= p.Sq || hi <= lo) {
    *w0 = *w1 = t_lo;
    return;
  }
  *w0 = max(t_lo, lo / bk);
  *w1 = max(*w0, min(t_hi, (hi + bk - 1) / bk));
}

// The logit of a raw score in log2 units (times log2 e), and the
// softcap's derivative 1 - tanh^2 (1 without a softcap), with the launch's
// constants folded once.
struct Logit {
  float sl2, s_cap, cap_l2;
  __device__ explicit Logit(const Params& p)
      : sl2(p.scale * kLog2e),
        s_cap(p.softcap > 0.f ? p.scale / p.softcap : 0.f),
        cap_l2(p.softcap * kLog2e) {}
  template <bool kCap>
  __device__ __forceinline__ float get(float dot, float* dcap) const {
    if constexpr (kCap) {
      const float th = tanhf(dot * s_cap);
      *dcap = 1.f - th * th;
      return cap_l2 * th;
    } else {
      *dcap = 1.f;
      return dot * sl2;
    }
  }
};

// visible() without branches, for the row phases' masked tiles.
__device__ __forceinline__ bool seen(const Params& p, int qi, int kj) {
  const int qpos = qi + p.q_offset;
  return (qi < p.Sq) & (kj < p.Skv) & ((p.causal == 0) | (kj <= qpos)) &
         ((p.window < 0) | (kj > qpos - p.window));
}

// f(cap, mask) with both flags as compile-time constants (std::true_type
// or std::false_type): cap where the launch has a softcap, mask where the
// tile holds a pair that is not visible. Each of the four forms of a row
// phase is straight-line code: a branch per element would serialise the
// elements and cost more than the phase's arithmetic.
template <typename F>
__device__ __forceinline__ void with_flags(bool cap, bool mask, F&& f) {
  using Y = std::true_type;
  using N = std::false_type;
  if (cap) {
    if (mask) f(Y{}, Y{});
    else f(Y{}, N{});
  } else {
    if (mask) f(N{}, Y{});
    else f(N{}, N{});
  }
}

// Forward. CTA (x, h, b): query rows [128 t, 128 t + 128) of head h (t from
// x, longest first under a causal mask), looping over the FWD_BK-key tiles
// of KV head h / G that some of its rows see. K and V have rings of their
// own, so that a consumer frees K_t as soon as S_t = Q K_t^T is done and
// the next K arrives under the row phase and P_t V_t. A consumer's tiles
// are those its own 64 rows see; it still takes part in the rings on the
// CTA's other tiles. (Running P V one tile behind, under the next tile's
// row phase, and making the two consumers take turns at the tensor cores
// through named barriers, each ran no faster on an H100.)
template <int DH>
__global__ void __launch_bounds__(kHThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const Params p) {
  using TL = Tiles<DH>;
  constexpr int NB = TL::NB, BK = TL::FWD_BK;
  constexpr int Q_BOX = 128 * kBox, KV_BOX = BK * kBox;
  constexpr int TILE = NB * KV_BOX;  // one K or V tile
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t k_ring = q_s + NB * Q_BOX;
  const uint32_t v_ring = k_ring + kStages * TILE;
  const Bars bars{v_ring + kStages * TILE};

  const int3 tl = tile_of(p.causal);
  const int h = tl.y, b = tl.z, hk = h / p.G, q0 = tl.x * 128;
  int lo, hi;
  key_range(p, q0, 128, &lo, &hi);
  const int t_lo = lo / BK, t_hi = hi > lo ? (hi + BK - 1) / BK : t_lo;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) bars.init(2, 0);
  __syncthreads();

  if (wg == 0) {  // producer
    hopper::regs_producer();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(bars.own(), NB * Q_BOX);
      for (int i = 0; i < NB; ++i)
        hopper::tma_load_4d(q_s + i * Q_BOX, &tm_q, bars.own(), 64 * i, h, q0,
                            b);
      produce_kv<NB, BK, kStages>(bars, k_ring, v_ring, &tm_k, &tm_v, hk, b,
                                  t_lo, t_hi);
    }
    return;
  }

  hopper::regs_consumer();
  const int c = wg - 1, tid = threadIdx.x % 128;
  const int q0w = q0 + 64 * c;                    // this consumer's 64 rows
  const int r0 = q0w + hopper::frag_row(tid, 0);  // its rows r0, r0 + 8
  const int cpart = 2 * (tid % 4);  // column of its first element
  int w0, w1;
  own_tiles(p, q0w, BK, t_lo, t_hi, &w0, &w1);
  const uint32_t qa = q_s + c * 64 * kBox;
  const Logit lg(p);
  const bool cap = p.softcap > 0.f;
  const Ring ring{bars, t_lo};
  float o[DH / 2], sc[BK / 2];
  uint32_t pa[BK / 16][4];
  zero(o);
  // the two rows' running max and this thread's part of their running
  // sums. Without a softcap the row phase keeps the raw scores q.k and
  // folds the scale into the exponent's fma (unit = scale log2 e); with
  // one, the logits in log2 units (unit = 1).
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float unit = cap ? 1.f : lg.sl2;
  hopper::mbar_wait(bars.own(), 0);
  for (int t = t_lo; t < w0; ++t) ring.pass(t, 2);
  // the row phase of tile t: scale, mask, online softmax; S_t becomes P_t
  // in sc, and corr the factor of the rows' earlier sums
  float corr[2];
  auto softmax = [&](int t) {
    const int k0 = t * BK;
    const bool mask = !all_visible(p, q0w, q0w + 64, k0, k0 + BK);
    // two running maxima per row, halving the chain of dependent fmaxf
    float mx[2][2] = {{m[0], m[0]}, {m[1], m[1]}};
    with_flags(cap, mask, [&](auto kc, auto km) {
#pragma unroll
      for (int q = 0; q < BK / 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * q + e];
          if constexpr (decltype(kc)::value) {
            float dcap;
            x = lg.get<true>(x, &dcap);
          }
          if constexpr (decltype(km)::value)
            x = seen(p, r0 + 8 * (e >> 1), k0 + 8 * q + cpart + (e & 1))
                    ? x
                    : kNegInf;
          sc[4 * q + e] = x;
          mx[e >> 1][q & 1] = fmaxf(mx[e >> 1][q & 1], x);
        }
    });
    float base[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = quad_max(fmaxf(mx[i][0], mx[i][1]));
      corr[i] = m[i] > kNegInf / 2 ? ex2((m[i] - m_new) * unit) : 0.f;
      m[i] = m_new;
      l[i] *= corr[i];
      // a row that has seen no key yet holds only kNegInf logits, which
      // give 0 against a base of 0
      base[i] = m_new > kNegInf / 2 ? m_new * unit : 0.f;
    }
#pragma unroll
    for (int q = 0; q < BK / 8; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = ex2(fmaf(sc[4 * q + e], unit, -base[e >> 1]));
        l[e >> 1] += pe;
        sc[4 * q + e] = pe;
      }
  };
  // every mbarrier wait comes before the fence, and no branch lies between
  // a fence and its products, so that the compiler keeps them asynchronous
  for (int t = w0; t < w1; ++t) {
    const uint32_t ks = k_ring + ring.slot(t, 0) * TILE;
    const uint32_t vs = v_ring + ring.slot(t, 1) * TILE;
    ring.wait(t, 0);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)  // S = Q K^T
      hopper::wgmma<BK, 0, 0>(sc, kmajor(qa, Q_BOX, kk),
                              kmajor(ks, KV_BOX, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    ring.release(t, 0);
    softmax(t);
#pragma unroll
    for (int q = 0; q < DH / 8; ++q) {
      o[4 * q] *= corr[0];
      o[4 * q + 1] *= corr[0];
      o[4 * q + 2] *= corr[1];
      o[4 * q + 3] *= corr[1];
    }
    to_a<BK>(pa, sc);
    ring.wait(t, 1);
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)  // O += P V
      hopper::wgmma_rs<DH, 1>(o, pa[j], mnmajor(vs, KV_BOX, j));
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    ring.release(t, 1);
  }
  for (int t = w1; t < t_hi; ++t) ring.pass(t, 2);
  float f[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    f[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
  if (q0w >= p.Sq) return;
  store_frag<DH>(static_cast<bf16*>(p.out), o, r0, p.Sq, p.Hq, h, b, p.Dh,
                 tid, f);
  if (tid % 4 == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (r0 + 8 * i < p.Sq)
        p.lse[(static_cast<size_t>(b) * p.Hq + h) * p.Sq + r0 + 8 * i] =
            l[i] > 0.f ? (m[i] * unit + log2f(l[i])) * kLn2 : kNegInf;
  }
}

// dq (and D). CTA (x, h, b): query rows [128 t, 128 t + 128) of head h, as
// the forward's, looping over the DQ_BK-key tiles they see: S = Q K^T and
// dP = dO V^T, then P = exp(S - lse), dS = P (dP - D) (times 1 - tanh^2
// under a softcap) in registers, and dQ += dS K. V_t is freed when dP_t
// is done, K_t after dS_t K_t. (Running dS K one tile behind, under the
// next tile's row phase, ran slower on an H100.)
template <int DH>
__global__ void __launch_bounds__(kHThreads, 1)
    flash_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do,
                          const Params p) {
  using TL = Tiles<DH>;
  constexpr int NB = TL::NB, BK = TL::DQ_BK;
  constexpr int Q_BOX = 128 * kBox, KV_BOX = BK * kBox;
  constexpr int TILE = NB * KV_BOX;
  constexpr int VS = TL::DQ_VSLOTS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t q_s = (hopper::smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + NB * Q_BOX;
  const uint32_t k_ring = do_s + NB * Q_BOX;
  const uint32_t v_ring = k_ring + kStages * TILE;
  const Bars bars{v_ring + VS * TILE};

  const int3 tl = tile_of(p.causal);
  const int h = tl.y, b = tl.z, hk = h / p.G, q0 = tl.x * 128;
  int lo, hi;
  key_range(p, q0, 128, &lo, &hi);
  const int t_lo = lo / BK, t_hi = hi > lo ? (hi + BK - 1) / BK : t_lo;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) bars.init(2, 0);
  __syncthreads();

  if (wg == 0) {  // producer
    hopper::regs_producer();
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(bars.own(), 2 * NB * Q_BOX);
      for (int i = 0; i < NB; ++i) {
        hopper::tma_load_4d(q_s + i * Q_BOX, &tm_q, bars.own(), 64 * i, h, q0,
                            b);
        hopper::tma_load_4d(do_s + i * Q_BOX, &tm_do, bars.own(), 64 * i, h,
                            q0, b);
      }
      produce_kv<NB, BK, VS>(bars, k_ring, v_ring, &tm_k, &tm_v, hk, b, t_lo,
                             t_hi);
    }
    return;
  }

  hopper::regs_consumer();
  const int c = wg - 1, tid = threadIdx.x % 128;
  const int q0w = q0 + 64 * c;
  const int r0 = q0w + hopper::frag_row(tid, 0);
  const int cpart = 2 * (tid % 4);
  int w0, w1;
  own_tiles(p, q0w, BK, t_lo, t_hi, &w0, &w1);
  const size_t row_base = (static_cast<size_t>(b) * p.Hq + h) * p.Sq;
  // D = rowsum(dO * O) of rows r0 and r0 + 8 from device memory, each
  // quad's four threads over interleaved 8-element chunks, and the rows'
  // lse in log2 units
  float dd[2], lse2[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + 8 * i;
    const bool ok = row < p.Sq;
    float sum = 0.f;
    if (ok) {
      const size_t off =
          ((static_cast<size_t>(b) * p.Sq + row) * p.Hq + h) * p.Dh;
      const bf16* dr = static_cast<const bf16*>(p.dout) + off;
      const bf16* orow = static_cast<const bf16*>(p.o) + off;
      for (int e = 8 * (tid % 4); e < p.Dh; e += 32) {
        const uint4 a = *reinterpret_cast<const uint4*>(dr + e);
        const uint4 bb = *reinterpret_cast<const uint4*>(orow + e);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&bb);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 x = __bfloat1622float2(a2[j]);
          const float2 y = __bfloat1622float2(b2[j]);
          sum = fmaf(x.x, y.x, sum);
          sum = fmaf(x.y, y.y, sum);
        }
      }
    }
    dd[i] = quad_sum(sum);
    lse2[i] = ok ? p.lse[row_base + row] * kLog2e : 0.f;
    if (ok && tid % 4 == 0) p.delta[row_base + row] = dd[i];
  }
  const uint32_t qa = q_s + c * 64 * kBox, da = do_s + c * 64 * kBox;
  const Logit lg(p);
  const bool cap = p.softcap > 0.f;
  const Ring ring{bars, t_lo, VS};
  float dq[DH / 2], sc[BK / 2], dp[BK / 2];
  uint32_t a[BK / 16][4];
  zero(dq);
  hopper::mbar_wait(bars.own(), 0);
  for (int t = t_lo; t < w0; ++t) ring.pass(t, 2);
  // S_t and dP_t (K_t and V_t), then dQ += dS_t K_t: waits before the
  // fence, no branch after it
  auto scores = [&](int t) {
    const uint32_t ks = k_ring + ring.slot(t, 0) * TILE;
    const uint32_t vs = v_ring + ring.slot(t, 1) * TILE;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hopper::wgmma<BK, 0, 0>(sc, kmajor(qa, Q_BOX, kk),
                              kmajor(ks, KV_BOX, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      hopper::wgmma<BK, 0, 0>(dp, kmajor(da, Q_BOX, kk),
                              kmajor(vs, KV_BOX, kk), kk > 0);
    hopper::wgmma_commit();
  };
  auto dsk = [&](int t) {
#pragma unroll
    for (int j = 0; j < BK / 16; ++j)
      hopper::wgmma_rs<DH, 1>(
          dq, a[j], mnmajor(k_ring + ring.slot(t, 0) * TILE, KV_BOX, j));
    hopper::wgmma_commit();
  };
  // the row phase of tile t: dP_t becomes dS_t in dp
  auto grad = [&](int t) {
    const int k0 = t * BK;
    const bool mask = !all_visible(p, q0w, q0w + 64, k0, k0 + BK);
    with_flags(cap, mask, [&](auto kc, auto km) {
#pragma unroll
      for (int q = 0; q < BK / 8; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float dcap;
          const float x = lg.get<decltype(kc)::value>(sc[4 * q + e], &dcap);
          float pe = ex2(x - lse2[i]);
          // a select, not a product: an empty row's lse makes ex2 inf
          if constexpr (decltype(km)::value)
            pe = seen(p, r0 + 8 * i, k0 + 8 * q + cpart + (e & 1)) ? pe
                                                                   : 0.f;
          dp[4 * q + e] = pe * (dp[4 * q + e] - dd[i]) * dcap;
        }
    });
  };
  for (int t = w0; t < w1; ++t) {
    ring.wait(t, 0);
    ring.wait(t, 1);
    hopper::wgmma_fence();
    scores(t);
    hopper::wgmma_wait<0>();
    ring.release(t, 1);
    grad(t);
    to_a<BK>(a, dp);
    hopper::wgmma_fence();
    dsk(t);
    hopper::wgmma_wait<0>();
    ring.release(t, 0);
  }
  for (int t = w1; t < t_hi; ++t) ring.pass(t, 2);
  if (q0w >= p.Sq) return;
  const float f[2] = {p.scale, p.scale};
  store_frag<DH>(static_cast<bf16*>(p.dq), dq, r0, p.Sq, p.Hq, h, b, p.Dh,
                 tid, f);
}

// dk/dv. CTA (x, hk, b): key rows [R x, R x + R) of KV head hk, looping
// over the G query heads of hk and, for each, the DKV_BQ-query tiles that
// see them, in that fixed order. Per tile: S^T = K Q^T and dP^T = V dO^T
// (K-major, from shared memory), P^T = exp(S^T - lse) and dS^T = P^T
// (dP^T - D) in registers, then dV += P^T dO and dK += dS^T Q with P^T and
// dS^T as register operands. How the two consumers share the work depends
// on DH (Tiles::DKV_OWN):
//   DH <= 128: each owns 64 keys of the CTA's R = 128 and does all of the
//     above for them, holding dK and dV (2 x DH / 2 f32 registers a
//     thread); a tile its keys see nothing of it skips.
//   DH 256: dK and dV of 64 keys would take 2 x 128 registers a thread,
//     more than a thread may hold beside S^T and dP^T, so both own the same
//     R = 64 keys and split the work by output: consumer 0 computes S^T,
//     P^T and dV; consumer 1 computes S^T, dP^T, dS^T and dK. Each
//     recomputes S^T, 2 Dh operations per visible pair more than sharing it
//     would, but the two run unsynchronised. (Handing P^T from consumer 0
//     to consumer 1 through shared memory, one barrier a tile, ran 1.16x
//     slower on an H100; exchanging dP^T - D as well, with dK and dV split
//     by head dims, 1.4-1.5x.)
// A second producer warp stages each query tile's lse (log2 units) and D
// beside its Q and dO.
template <int DH>
__global__ void __launch_bounds__(kHThreads, 1)
    flash_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_do,
                           const Params p) {
  using TL = Tiles<DH>;
  constexpr int NB = TL::NB, BQ = TL::DKV_BQ, R = TL::DKV_ROWS;
  constexpr bool kOwn = TL::DKV_OWN;
  constexpr int KV_BOX = R * kBox, Q_BOX = BQ * kBox;
  constexpr int STAGE = 2 * NB * Q_BOX;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_addr(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  const uint32_t v_s = k_s + NB * KV_BOX;
  const uint32_t ring = v_s + NB * KV_BOX;
  const uint32_t rows_at = ring + kStages * STAGE;  // per stage lse, D
  float* rows_s = reinterpret_cast<float*>(smem_raw + (rows_at - raw));
  const Bars bars{rows_at + kStages * 2 * BQ * 4};

  const int3 tl = tile_of(false);  // the first key tiles see the most
  const int hk = tl.y, b = tl.z, k0 = tl.x * R;
  int lo, hi;
  query_range(p, k0, R, &lo, &hi);
  const int t_lo = lo / BQ, t_hi = hi > lo ? (hi + BQ - 1) / BQ : t_lo;
  const int n_t = t_hi - t_lo, n_tiles = p.G * n_t;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) bars.init(1, 32);
  __syncthreads();

  if (wg == 0) {  // producer
    hopper::regs_producer();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      hopper::mbar_expect_tx(bars.own(), 2 * NB * KV_BOX);
      for (int i = 0; i < NB; ++i) {
        hopper::tma_load_4d(k_s + i * KV_BOX, &tm_k, bars.own(), 64 * i, hk,
                            k0, b);
        hopper::tma_load_4d(v_s + i * KV_BOX, &tm_v, bars.own(), 64 * i, hk,
                            k0, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int h = hk * p.G + it / n_t, q0 = (t_lo + it % n_t) * BQ;
        hopper::mbar_wait(bars.empty(s), ((it / kStages) & 1) ^ 1);
        const uint32_t st = ring + s * STAGE;
        hopper::mbar_expect_tx(bars.full(s), STAGE);
        for (int i = 0; i < NB; ++i) {
          hopper::tma_load_4d(st + i * Q_BOX, &tm_q, bars.full(s), 64 * i, h,
                              q0, b);
          hopper::tma_load_4d(st + (NB + i) * Q_BOX, &tm_do, bars.full(s),
                              64 * i, h, q0, b);
        }
      }
    } else if (warp == 1) {
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const int h = hk * p.G + it / n_t, q0 = (t_lo + it % n_t) * BQ;
        const size_t row_base = (static_cast<size_t>(b) * p.Hq + h) * p.Sq;
        hopper::mbar_wait(bars.empty(s), ((it / kStages) & 1) ^ 1);
        float* slot = rows_s + s * 2 * BQ;
        for (int j = lane; j < BQ; j += 32) {
          const bool ok = q0 + j < p.Sq;
          slot[j] = ok ? p.lse[row_base + q0 + j] * kLog2e : 0.f;
          slot[BQ + j] = ok ? p.delta[row_base + q0 + j] : 0.f;
        }
        hopper::mbar_arrive(bars.full(s));
      }
    }
    return;
  }

  hopper::regs_consumer();
  const int c = wg - 1, tid = threadIdx.x % 128;
  const int kw = k0 + (kOwn ? 64 * c : 0);  // this consumer's 64 keys
  const uint32_t ka = k_s + (kOwn ? c * 64 * kBox : 0);
  const uint32_t va = v_s + (kOwn ? c * 64 * kBox : 0);
  const int r0 = kw + hopper::frag_row(tid, 0);  // key rows r0, r0 + 8
  const int cpart = 2 * (tid % 4);
  // the queries [qlo, qhi) that see one of this consumer's keys
  int qlo, qhi;
  query_range(p, kw, 64, &qlo, &qhi);
  const Logit lg(p);
  const bool cap = p.softcap > 0.f;
  hopper::mbar_wait(bars.own(), 0);
  // kDV: dV += P^T dO; kDK: dK += dS^T Q
  auto consume = [&](auto kdv, auto kdk) {
    constexpr bool kDV = decltype(kdv)::value, kDK = decltype(kdk)::value;
    float dv[DH / 2], dk[DH / 2];
    if constexpr (kDV) zero(dv);
    if constexpr (kDK) zero(dk);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const int q0 = (t_lo + it % n_t) * BQ;
      hopper::mbar_wait(bars.full(s), (it / kStages) & 1);
      if (!kOwn || (kw < p.Skv && q0 < qhi && q0 + BQ > qlo)) {
        const uint32_t qs = ring + s * STAGE, dos = qs + NB * Q_BOX;
        const float* slot = rows_s + s * 2 * BQ;
        float sc[BQ / 2], dp[BQ / 2];
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)  // S^T = K Q^T
          hopper::wgmma<BQ, 0, 0>(sc, kmajor(ka, KV_BOX, kk),
                                  kmajor(qs, Q_BOX, kk), kk > 0);
        if constexpr (kDK) {
#pragma unroll
          for (int kk = 0; kk < DH / 16; ++kk)  // dP^T = V dO^T
            hopper::wgmma<BQ, 0, 0>(dp, kmajor(va, KV_BOX, kk),
                                    kmajor(dos, Q_BOX, kk), kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        const bool mask = !all_visible(p, q0, q0 + BQ, kw, kw + 64);
        with_flags(cap, mask, [&](auto kc, auto km) {
#pragma unroll
          for (int q = 0; q < BQ / 8; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int j = 8 * q + cpart + (e & 1);  // query q0 + j
              float dcap;
              const float x =
                  lg.get<decltype(kc)::value>(sc[4 * q + e], &dcap);
              float pe = ex2(x - slot[j]);
              if constexpr (decltype(km)::value)
                pe = seen(p, q0 + j, r0 + 8 * (e >> 1)) ? pe : 0.f;
              if constexpr (kDK)
                dp[4 * q + e] = pe * (dp[4 * q + e] - slot[BQ + j]) * dcap;
              sc[4 * q + e] = pe;
            }
        });
        uint32_t ap[BQ / 16][4], ad[BQ / 16][4];
        if constexpr (kDV) to_a<BQ>(ap, sc);
        if constexpr (kDK) to_a<BQ>(ad, dp);
        hopper::wgmma_fence();
        if constexpr (kDV) {
#pragma unroll
          for (int j = 0; j < BQ / 16; ++j)  // dV += P^T dO
            hopper::wgmma_rs<DH, 1>(dv, ap[j], mnmajor(dos, Q_BOX, j));
        }
        if constexpr (kDK) {
#pragma unroll
          for (int j = 0; j < BQ / 16; ++j)  // dK += dS^T Q
            hopper::wgmma_rs<DH, 1>(dk, ad[j], mnmajor(qs, Q_BOX, j));
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
      }
      hopper::mbar_arrive(bars.empty(s));
    }
    if constexpr (kDV) {
      const float f[2] = {1.f, 1.f};
      store_frag<DH>(static_cast<bf16*>(p.dv), dv, r0, p.Skv, p.Hkv, hk, b,
                     p.Dh, tid, f);
    }
    if constexpr (kDK) {
      const float f[2] = {p.scale, p.scale};
      store_frag<DH>(static_cast<bf16*>(p.dk), dk, r0, p.Skv, p.Hkv, hk, b,
                     p.Dh, tid, f);
    }
  };
  if constexpr (kOwn)
    consume(std::true_type{}, std::true_type{});
  else if (wg == 1)
    consume(std::true_type{}, std::false_type{});
  else
    consume(std::false_type{}, std::true_type{});
}

// The launches of the forward (fwd) or the backward (dq, then dk/dv): f32
// CTAs of 64 rows, bf16 CTAs of 128 query rows (fwd, dq) or DKV_ROWS key
// rows (dk/dv).
template <typename T, int DHMAX>
plan::Dims fwd_dims(const Params& p) {
  if constexpr (std::is_same<T, bf16>::value)
    return {dim3((p.Sq + 127) / 128, p.Hq, p.B), kHThreads,
            static_cast<size_t>(Tiles<DHMAX>::FWD_SMEM)};
  else {
    const Layout<T, DHMAX> L(p.Dh);
    return {dim3((p.Sq + kRows - 1) / kRows, p.Hq, p.B), kThreads,
            L.fwd_bytes(L.fwd_stages())};
  }
}
template <typename T, int DHMAX>
plan::Dims dq_dims(const Params& p) {
  if constexpr (std::is_same<T, bf16>::value)
    return {dim3((p.Sq + 127) / 128, p.Hq, p.B), kHThreads,
            static_cast<size_t>(Tiles<DHMAX>::DQ_SMEM)};
  else {
    const Layout<T, DHMAX> L(p.Dh);
    return {dim3((p.Sq + kRows - 1) / kRows, p.Hq, p.B), kThreads,
            L.dq_bytes(L.dq_stages())};
  }
}
template <typename T, int DHMAX>
plan::Dims dkv_dims(const Params& p) {
  if constexpr (std::is_same<T, bf16>::value)
    return {dim3((p.Skv + Tiles<DHMAX>::DKV_ROWS - 1) / Tiles<DHMAX>::DKV_ROWS,
                 p.Hkv, p.B),
            kHThreads, static_cast<size_t>(Tiles<DHMAX>::DKV_SMEM)};
  else {
    const Layout<T, DHMAX> L(p.Dh);
    return {dim3((p.Skv + kRows - 1) / kRows, p.Hkv, p.B), kThreads,
            L.dkv_bytes(L.dkv_stages())};
  }
}

// Tensor maps of (B, S, H, Dh) bf16 tensors with boxes of `rows` rows.
bool q_map(CUtensorMap* m, const void* t, const Params& p, uint32_t rows) {
  return hopper::encode_4d(m, t, p.Dh, p.Hq, p.Sq, p.B, rows);
}
bool kv_map(CUtensorMap* m, const void* t, const Params& p, uint32_t rows) {
  return hopper::encode_4d(m, t, p.Dh, p.Hkv, p.Skv, p.B, rows);
}

// A launch with the tensor maps (bf16) before the parameters.
template <typename Kern, typename... Maps>
int launch_kernel(Kern kernel, const plan::Dims& d, const Params& p,
                  cudaStream_t stream, const Maps&... maps) {
  if (d.smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(d.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<d.grid, d.threads, d.smem, stream>>>(maps..., p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int DHMAX>
int run_fwd(const Params& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    CUtensorMap tq, tk, tv;
    constexpr int BK = Tiles<DHMAX>::FWD_BK;
    if (!q_map(&tq, p.q, p, 128) || !kv_map(&tk, p.k, p, BK) ||
        !kv_map(&tv, p.v, p, BK))
      return hopper::kEncodeFailed;
    return launch_kernel(flash_fwd_wgmma_kernel<DHMAX>, fwd_dims<T, DHMAX>(p),
                      p, stream, tq, tk, tv);
  } else {
    return launch_kernel(flash_fwd_kernel<T, DHMAX>, fwd_dims<T, DHMAX>(p),
                         p, stream);
  }
}

template <typename T, int DHMAX>
int run_bwd(const Params& p, cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    CUtensorMap tq, tk, tv, tdo;
    constexpr int BK = Tiles<DHMAX>::DQ_BK;
    if (!q_map(&tq, p.q, p, 128) || !q_map(&tdo, p.dout, p, 128) ||
        !kv_map(&tk, p.k, p, BK) || !kv_map(&tv, p.v, p, BK))
      return hopper::kEncodeFailed;
    int rc = launch_kernel(flash_dq_wgmma_kernel<DHMAX>, dq_dims<T, DHMAX>(p),
                        p, stream, tq, tk, tv, tdo);
    if (rc != 0) return rc;
    constexpr int BQ = Tiles<DHMAX>::DKV_BQ;
    if (!q_map(&tq, p.q, p, BQ) || !q_map(&tdo, p.dout, p, BQ) ||
        !kv_map(&tk, p.k, p, Tiles<DHMAX>::DKV_ROWS) ||
        !kv_map(&tv, p.v, p, Tiles<DHMAX>::DKV_ROWS))
      return hopper::kEncodeFailed;
    return launch_kernel(flash_dkv_wgmma_kernel<DHMAX>, dkv_dims<T, DHMAX>(p),
                      p, stream, tq, tk, tv, tdo);
  } else {
    int rc = launch_kernel(flash_dq_kernel<T, DHMAX>, dq_dims<T, DHMAX>(p),
                           p, stream);
    if (rc != 0) return rc;
    return launch_kernel(flash_dkv_kernel<T, DHMAX>, dkv_dims<T, DHMAX>(p),
                         p, stream);
  }
}

template <typename T, int DHMAX>
int plan_of(const Params& p, bool bwd, int* out) {
  if (!bwd) {
    plan::put(out, 0, fwd_dims<T, DHMAX>(p));
    return 1;
  }
  plan::put(out, 0, dq_dims<T, DHMAX>(p));
  plan::put(out, 1, dkv_dims<T, DHMAX>(p));
  return 2;
}

// The head-dim bucket (Dh <= 64, 128, 256) picks the register arrays' size
// (f32) or the tiles' width, Dh zero-filled up to it (bf16).
template <typename T, bool kBwd>
int run(const Params& p, cudaStream_t stream) {
  if (p.Dh <= 64) return kBwd ? run_bwd<T, 64>(p, stream)
                              : run_fwd<T, 64>(p, stream);
  if (p.Dh <= 128) return kBwd ? run_bwd<T, 128>(p, stream)
                               : run_fwd<T, 128>(p, stream);
  return kBwd ? run_bwd<T, 256>(p, stream) : run_fwd<T, 256>(p, stream);
}

template <bool kBwd>
int dispatch(const Params& p, int dtype, void* stream) {
  if (p.Dh <= 0 || p.Dh > 256 || p.Dh % 16 != 0 || p.G <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float, kBwd>(p, s);
  if (dtype == 1) return run<bf16, kBwd>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

Params make_params(int B, int Sq, int Skv, int Hq, int Hkv, int Dh,
                   int causal, int window, int q_offset, float softcap,
                   float scale) {
  Params p = {};
  p.B = B;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.Dh = Dh;
  p.G = Hkv > 0 ? Hq / Hkv : 0;
  p.causal = causal;
  p.window = window;
  p.q_offset = q_offset;
  p.softcap = softcap;
  p.scale = scale;
  return p;
}

}  // namespace

// Forward: q (B, Sq, Hq, Dh), k, v (B, Skv, Hkv, Dh), all of one dtype
// (0 float32, 1 bfloat16), contiguous, 16-byte aligned; out like q and lse
// (B, Hq, Sq) float32. Preconditions: Hq % Hkv == 0, Dh % 16 == 0,
// Dh <= 256, Sq > 0; window -1 for none, softcap 0 for none.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int B, int Sq, int Skv, int Hq, int Hkv,
                                   int Dh, int causal, int window,
                                   int q_offset, float softcap, float scale,
                                   int dtype, void* stream) {
  Params p = make_params(B, Sq, Skv, Hq, Hkv, Dh, causal, window, q_offset,
                         softcap, scale);
  p.q = q;
  p.k = k;
  p.v = v;
  p.out = out;
  p.lse = lse;
  return dispatch<false>(p, dtype, stream);
}

// Backward: the forward's inputs, its output o and lse, and dout like o;
// writes dq like q, dk and dv like k, and delta (B, Hq, Sq) float32
// (rowsum(dout * o), scratch between the two launches). Preconditions as
// the forward's, and Skv > 0.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* o,
                                   const void* dout, const float* lse,
                                   void* dq, void* dk, void* dv, float* delta,
                                   int B, int Sq, int Skv, int Hq, int Hkv,
                                   int Dh, int causal, int window,
                                   int q_offset, float softcap, float scale,
                                   int dtype, void* stream) {
  Params p = make_params(B, Sq, Skv, Hq, Hkv, Dh, causal, window, q_offset,
                         softcap, scale);
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.delta = delta;
  return dispatch<true>(p, dtype, stream);
}

// The launches flash_attention_fwd (backward 0) or flash_attention_bwd
// (backward 1) makes for these shapes, from the host code it launches
// with: six ints each (grid x, y, z, threads, dynamic shared memory bytes,
// cluster) written to out (room for 2). Returns the launch count, or -1
// where the entry point would refuse the shapes or the dtype.
extern "C" int flash_attention_plan(int B, int Sq, int Skv, int Hq, int Hkv,
                                    int Dh, int dtype, int backward,
                                    int* out) {
  const Params p = make_params(B, Sq, Skv, Hq, Hkv, Dh, 1, -1, 0, 0.f, 1.f);
  if (p.Dh <= 0 || p.Dh > 256 || p.Dh % 16 != 0 || p.G <= 0 ||
      (dtype != 0 && dtype != 1))
    return -1;
  const bool bwd = backward != 0;
  if (dtype == 0) {
    if (Dh <= 64) return plan_of<float, 64>(p, bwd, out);
    if (Dh <= 128) return plan_of<float, 128>(p, bwd, out);
    return plan_of<float, 256>(p, bwd, out);
  }
  if (Dh <= 64) return plan_of<bf16, 64>(p, bwd, out);
  if (Dh <= 128) return plan_of<bf16, 128>(p, bwd, out);
  return plan_of<bf16, 256>(p, bwd, out);
}
