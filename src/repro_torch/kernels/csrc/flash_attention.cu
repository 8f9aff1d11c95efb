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
// 4 Dh operations forward (q.k and p.v) and 10 Dh backward (the recomputed
// q.k, dO.v, dS.K, dS^T.Q and P^T.dO), against 2 Dh bf16 bytes of K and V
// shared by a whole tile of queries. At gemma3-4b's training shapes (B 2,
// S 2048, Hq 8, Dh 256) a global layer's forward is 34 GFLOP against
// 50 MB: about 35 us at the bf16 tensor-core peak and 15 us of bytes.
//
// What the design does about it: the Pallas grid walks every KV block and
// masks; here a CTA of 8 warps owns 64 rows (queries in the forward and dq,
// keys in dk/dv) and loops only over the tiles that hold a visible pair
// (causal: up to the tile of the last query; window: from the tile of the
// first query's oldest key), which is what the XLA chunked form does with
// its window span. Per tile: the scores go through the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate) into shared memory; 4
// threads per row apply scale, softcap and mask and keep the online softmax
// (running max and sum in f32); P is rounded to bf16 for the P.V product
// (one bf16 rounding, 2^-9 relative, of each probability: the bf16
// tolerance of 1e-2 of max |plain| covers it) and P.V accumulates in f32
// registers. f32 inputs take the same plan on the CUDA cores (32-key tiles)
// in full f32, so that an f32 step compares with the plain version at f32
// summation order. The backward is two launches and no atomics: (a) dq (and
// D) per query tile over its visible key tiles; (b) dk/dv per key tile,
// looping over the G query heads of its KV head and their visible query
// tiles in a fixed order inside the CTA. Every sum is taken in one fixed
// order, so two runs agree bit for bit. Ragged edges (S not a multiple of
// the tile) are zero-filled on load, masked and guarded on store.
#include "csd_spmm_common.cuh"

namespace {

using csd::cp_async16;
using csd::cp_async_commit;
using csd::cp_async_wait;
using csd::store;
using csd::to_f32;

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kRows = 64;      // rows a CTA owns
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

// Keys [lo, hi) that some query of [q0, q0 + kRows) may see.
__device__ __forceinline__ void key_range(const Params& p, int q0, int* lo,
                                          int* hi) {
  const int q_last = min(q0 + kRows, p.Sq) - 1;
  *lo = 0;
  *hi = p.Skv;
  if (p.causal) *hi = min(*hi, q_last + p.q_offset + 1);
  if (p.window >= 0) *lo = max(*lo, q0 + p.q_offset - p.window + 1);
}

// Queries [lo, hi) that may see some key of [k0, k0 + kRows).
__device__ __forceinline__ void query_range(const Params& p, int k0, int* lo,
                                            int* hi) {
  const int k_last = min(k0 + kRows, p.Skv) - 1;
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
// The two engines: the products a CTA of 256 threads needs over tiles in
// shared memory.
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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 and receives, of matrix i, in r[i] the elements (l / 4, 2 (l % 4)
// + {0, 1}).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// Two 8 x 8 b16 matrices, transposed: lane l (< 16) gives the address of
// row l % 8 of matrix l / 8 and receives, of matrix i, in r[i] the elements
// (2 (l % 4) + {0, 1}, l / 4).
__device__ __forceinline__ void ldsm_x2_trans(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(smem_u32(p)));
}

// d += a b over one m16n8k16 tile: a (16 x 16) and b (16 x 8) bf16, d f32
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of rows [0, 16) and columns [k0, k0 + 16) of a row-major tile:
// matrices (rows 0-7, k0), (rows 8-15, k0), (rows 0-7, k0 + 8),
// (rows 8-15, k0 + 8)
__device__ __forceinline__ void frag_a(uint32_t* a, const bf16* A, int lda,
                                      int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  ldsm_x4(a, A + ((lane & 7) + 8 * (mi & 1)) * lda + k0 + 8 * (mi >> 1));
}

// B fragments (k in [k0, k0 + 16)) of two 8-wide n blocks, B[k][n] = M[n][k]
// for a row-major M whose rows are the n: b[0..1] for rows [0, 8) of M,
// b[2..3] for rows [8, 16)
__device__ __forceinline__ void frag_b_nt2(uint32_t* b, const bf16* M,
                                          int ldm, int k0) {
  const int lane = threadIdx.x & 31, mi = lane >> 3;
  ldsm_x4(b, M + ((lane & 7) + 8 * (mi >> 1)) * ldm + k0 + 8 * (mi & 1));
}

// B fragment (k in [k0, k0 + 16), n in [0, 8)) of a row-major B[k][n]
__device__ __forceinline__ void frag_b_nn(uint32_t* b, const bf16* B,
                                         int ldb, int k0) {
  const int lane = threadIdx.x & 15;
  ldsm_x2_trans(b, B + (k0 + (lane & 7) + 8 * (lane >> 3)) * ldb);
}

// bf16 on the tensor cores. Warp w owns the 16 rows 16 (w % 4) + [0, 16)
// and, of the head dims, the half (w / 4); in it lane l holds rows
// g = l / 4 and g + 8 at dims 8 nb + 2 (l % 4) + {0, 1} (the mma
// accumulator layout).
template <int DHMAX>
struct Engine<bf16, DHMAX> {
  static constexpr int C = 64;
  static constexpr int kPad = 8;
  static constexpr int NB = DHMAX / 16;  // 8-wide blocks in half of Dh
  float acc[NB][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < NB; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  __device__ static void scores(float* out, int ldo, const bf16* A, int lda,
                                const bf16* B, int ldb, int Dh) {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int rg = w & 3, half = w >> 2;
    const bf16* a_rows = A + 16 * rg * lda;
    const bf16* b_rows = B + 32 * half * ldb;
    float c[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) c[i][j] = 0.f;
#pragma unroll 4
    for (int k0 = 0; k0 < Dh; k0 += 16) {
      uint32_t a[4];
      frag_a(a, a_rows, lda, k0);
#pragma unroll
      for (int nb = 0; nb < 4; nb += 2) {
        uint32_t b[4];
        frag_b_nt2(b, b_rows + 8 * nb * ldb, ldb, k0);
        mma16816(c[nb], a, b);
        mma16816(c[nb + 1], a, b + 2);
      }
    }
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      float* o = out + (16 * rg + g) * ldo + 32 * half + 8 * nb + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(c[nb][0], c[nb][1]);
      *reinterpret_cast<float2*>(o + 8 * ldo) =
          make_float2(c[nb][2], c[nb][3]);
    }
  }

  __device__ void nn(const bf16* A, int lda, const bf16* B, int ldb,
                     int Dh) {
    const int w = threadIdx.x >> 5;
    const int rg = w & 3, half = w >> 2;
    const bf16* a_rows = A + 16 * rg * lda;
    const bf16* b_cols = B + half * (Dh / 2);
    const int nbs = Dh / 16;
#pragma unroll 1
    for (int k0 = 0; k0 < C; k0 += 16) {
      uint32_t a[4];
      frag_a(a, a_rows, lda, k0);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (nb < nbs) {
          uint32_t b[2];
          frag_b_nn(b, b_cols + 8 * nb, ldb, k0);
          mma16816(acc[nb], a, b);
        }
      }
    }
  }

  __device__ void scale_rows(const float* f) {
    const int w = threadIdx.x >> 5, g = (threadIdx.x & 31) >> 2;
    const float x0 = f[16 * (w & 3) + g], x8 = f[16 * (w & 3) + g + 8];
#pragma unroll
    for (int i = 0; i < NB; ++i) {
      acc[i][0] *= x0;
      acc[i][1] *= x0;
      acc[i][2] *= x8;
      acc[i][3] *= x8;
    }
  }

  __device__ void store_rows(bf16* dst, size_t stride, int row0, int limit,
                             const float* f, float mult, int Dh) const {
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int col0 = (w >> 2) * (Dh / 2) + 2 * t;
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = 16 * (w & 3) + g + 8 * hr;
      if (row0 + r >= limit) continue;
      const float x = (f != nullptr ? f[r] : 1.f) * mult;
      bf16* row = dst + static_cast<size_t>(row0 + r) * stride + col0;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        if (nb < Dh / 16) {
          *reinterpret_cast<__nv_bfloat162*>(row + 8 * nb) =
              __floats2bfloat162_rn(acc[nb][2 * hr] * x,
                                    acc[nb][2 * hr + 1] * x);
        }
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

// exp in the row phases: f32 keeps expf; bf16 takes the hardware exp2
// (__expf), whose error is far below bf16's rounding of P
template <typename T>
__device__ __forceinline__ float exp_of(float x) {
  return expf(x);
}
template <>
__device__ __forceinline__ float exp_of<bf16>(float x) {
  return __expf(x);
}

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
  key_range(p, q0, &lo, &hi);
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
    const float corr = m > kNegInf / 2 ? exp_of<T>(m - m_new) : 0.f;
    const bool live = m_new > kNegInf / 2;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float pe = live ? exp_of<T>(sv[j] - m_new) : 0.f;
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
  const float pe = vis ? exp_of<T>(x - lse) : 0.f;
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
  key_range(p, q0, &lo, &hi);
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
  query_range(p, k0, &lo, &hi);
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

template <typename Kern>
int launch_kernel(Kern kernel, const plan::Dims& d, const Params& p,
                  cudaStream_t stream) {
  if (d.smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(d.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<d.grid, d.threads, d.smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The launches of the forward (fwd) or the backward (dq, then dk/dv).
template <typename T, int DHMAX>
plan::Dims fwd_dims(const Params& p) {
  const Layout<T, DHMAX> L(p.Dh);
  return {dim3((p.Sq + kRows - 1) / kRows, p.Hq, p.B), kThreads,
          L.fwd_bytes(L.fwd_stages())};
}
template <typename T, int DHMAX>
plan::Dims dq_dims(const Params& p) {
  const Layout<T, DHMAX> L(p.Dh);
  return {dim3((p.Sq + kRows - 1) / kRows, p.Hq, p.B), kThreads,
          L.dq_bytes(L.dq_stages())};
}
template <typename T, int DHMAX>
plan::Dims dkv_dims(const Params& p) {
  const Layout<T, DHMAX> L(p.Dh);
  return {dim3((p.Skv + kRows - 1) / kRows, p.Hkv, p.B), kThreads,
          L.dkv_bytes(L.dkv_stages())};
}

template <typename T, int DHMAX>
int run_fwd(const Params& p, cudaStream_t stream) {
  return launch_kernel(flash_fwd_kernel<T, DHMAX>, fwd_dims<T, DHMAX>(p), p,
                       stream);
}

template <typename T, int DHMAX>
int run_bwd(const Params& p, cudaStream_t stream) {
  int rc = launch_kernel(flash_dq_kernel<T, DHMAX>, dq_dims<T, DHMAX>(p), p,
                         stream);
  if (rc != 0) return rc;
  return launch_kernel(flash_dkv_kernel<T, DHMAX>, dkv_dims<T, DHMAX>(p), p,
                       stream);
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

// The head-dim bucket (Dh <= 64, 128, 256) picks the register arrays' size.
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
// with: five ints each (grid x, y, z, threads, dynamic shared memory bytes)
// written to out (room for 2). Returns the launch count, or -1 where the
// entry point would refuse the shapes or the dtype.
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
