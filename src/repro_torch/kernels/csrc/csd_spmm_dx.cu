// csd_spmm_dx — backward-data (BP, paper eq. (3b)) of the block-sparse
// junction for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/csd_spmm.py:csd_spmm_dx (Pallas body
// _dx_kernel), in its 4-D and its expert-batched (5-D) form:
//   dx[e, m, lb] = sum_g mask(dy)[e, m, out_idx[lb, g]]
//                        @ w[e, out_idx[lb, g], out_slot[lb, g]]^T
// over the pattern's scatter form (each left block lb feeds d_out_b right
// blocks), shared by all E experts, with the activation's derivative folded
// into dy from the saved aux (y for relu, the pre-activation z for gelu),
// f32 accumulation and dx in the dtype of dy. The 4-D form is E = 1.
//
// What bounds it on the card: in training M is batch x sequence (4096 for
// gemma3-4b at 2 x 2048). Each left block's K = d_out_b * bR is 5120 for
// the up/gate junctions and 2048 for down, so the work is 2 * M * n_in * K
// operations (about 107 GFLOP per junction) against ~90-130 MB of dy, aux,
// w and dx: far above the bf16 ridge point. It is bound by operations,
// ~108 us (up/gate) and ~174 us (down) at 989 TFLOP/s. The expert junctions
// of granite-moe-1b-a400m in training (32 experts of C = 1280 rows, 128 x 256
// blocks at density 0.5 / 0.75) are smaller products, about 21 and 32 GFLOP
// against ~140-150 MB, and sit below the bf16 ridge point: bound by bytes.
//
// What the design does about it: the Pallas grid revisits one dx tile
// across the sequential g axis; here each CTA owns one (BM x 64) tile of dx
// (64 columns inside one left block) and loops over the g slots and over bR
// in BK chunks itself, so nothing is accumulated across CTAs: no atomics,
// and the result repeats bit for bit. The w block of slot g is read as the
// column-major B operand straight from its (bL, bR) layout (w^T without a
// copy). Tiles of dy, aux and w stream through a 3-stage cp.async ring;
// each dy tile is masked in shared memory from its aux tile once it lands
// and before the tensor cores read it (bf16 through WMMA fragments, f32 on
// the CUDA cores in full precision), so the masked cotangent never reaches
// device memory. The ragged M edge is zero-filled on load and guarded on
// store. Experts are folded into gridDim.y (expert e owns row tiles
// [e * m_tiles, (e + 1) * m_tiles)); each CTA offsets dy, aux, w and dx by
// its expert's strides and reads the one shared out_idx / out_slot.
#include "csd_spmm_common.cuh"

namespace {

using csd::cp_async16;
using csd::cp_async_commit;
using csd::cp_async_wait;
using csd::mask_tile;
using csd::store;

constexpr int kThreads = 128;
constexpr int kBN = 64;  // dx columns per CTA
constexpr int kBM = 64;  // dx rows per CTA

template <typename T>
struct DxTile {
  static constexpr int BK = std::is_same<T, float>::value ? 32 : 64;
  static constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int AS = BK + EPC;  // dy/aux rows (kBM x BK), padded
  static constexpr int WS = BK + EPC;  // w rows: [n][k], kBN x BK, padded
  static constexpr int STAGES = 3;
  static constexpr int SMEM =
      STAGES * (2 * kBM * AS + kBN * WS) * static_cast<int>(sizeof(T));
};

// kExperts: E > 1, the expert index folded into gridDim.y. The single
// junction (E = 1) is compiled without the expert offsets: with them its
// gelu-masked form ran measurably slower on the card (PERF.md).
template <typename T, bool kExperts>
__global__ void __launch_bounds__(kThreads)
    csd_spmm_dx_kernel(const T* __restrict__ dy, const T* __restrict__ aux,
                       const T* __restrict__ w, const int* __restrict__ oidx,
                       const int* __restrict__ oslot, T* __restrict__ dx,
                       int M, int n_out, int n_in, int d_in_b, int bL,
                       int bR, int d_out_b, int act) {
  using TL = DxTile<T>;
  constexpr int BK = TL::BK, EPC = TL::EPC, AS = TL::AS, WS = TL::WS;
  constexpr int S = TL::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  T* dys = reinterpret_cast<T*>(smem);
  T* auxs = dys + S * kBM * AS;
  T* ws = auxs + S * kBM * AS;

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * kBN;  // first dx column of the tile
  const int lb = col0 / bL;
  const int n0 = col0 - lb * bL;  // column offset inside the left block
  int m0 = blockIdx.y * kBM;
  if constexpr (kExperts) {
    const int m_tiles = (M + kBM - 1) / kBM;
    const int ex = blockIdx.y / m_tiles;  // this CTA's expert
    m0 -= ex * m_tiles * kBM;
    dy += static_cast<size_t>(ex) * M * n_out;
    if (aux != nullptr) aux += static_cast<size_t>(ex) * M * n_out;
    w += static_cast<size_t>(ex) * n_out * d_in_b * bL;
    dx += static_cast<size_t>(ex) * M * n_in;
  }
  const int steps_per_slot = bR / BK;
  const int n_steps = d_out_b * steps_per_slot;

  auto load_stage = [&](int t) {
    if (t >= n_steps) return;
    const int stage = t % S;
    const int g = t / steps_per_slot;
    const int k0 = (t - g * steps_per_slot) * BK;
    const int rb = __ldg(oidx + lb * d_out_b + g);
    const int f = __ldg(oslot + lb * d_out_b + g);
    constexpr int AC = BK / EPC;  // chunks per dy row
    const size_t col = static_cast<size_t>(rb) * bR + k0;
    T* ddst = dys + stage * kBM * AS;
    T* adst = auxs + stage * kBM * AS;
    for (int c = tid; c < kBM * AC; c += kThreads) {
      const int r = c / AC, cc = c - r * AC;
      const int m = m0 + r;
      const bool ok = m < M;
      const size_t off = static_cast<size_t>(ok ? m : 0) * n_out + col +
                         cc * EPC;
      cp_async16(ddst + r * AS + cc * EPC, dy + off, ok);
      if (act != 0) cp_async16(adst + r * AS + cc * EPC, aux + off, ok);
    }
    // w[rb, f] rows n0 .. n0 + 63, columns k0 .. k0 + BK: B[k][n] = w[n][k]
    const T* wsrc =
        w + ((static_cast<size_t>(rb) * d_in_b + f) * bL + n0) * bR + k0;
    T* wdst = ws + stage * kBN * WS;
    for (int c = tid; c < kBN * AC; c += kThreads) {
      const int r = c / AC, cc = c - r * AC;
      cp_async16(wdst + r * WS + cc * EPC,
                 wsrc + static_cast<size_t>(r) * bR + cc * EPC, true);
    }
  };

  // Waits for step t's tiles and masks its dy tile; returns the stage.
  auto arrive = [&](int t) {
    cp_async_wait<S - 2>();
    __syncthreads();
    load_stage(t + S - 1);
    cp_async_commit();
    const int stage = t % S;
    if (act != 0) {
      T* d = dys + stage * kBM * AS;
      const T* a = auxs + stage * kBM * AS;
      mask_tile<T, kBM, BK, AS, kThreads>(d, a, act, tid);
      __syncthreads();
    }
    return stage;
  };

  for (int s = 0; s < S - 1; ++s) {
    load_stage(s);
    cp_async_commit();
  }

  if constexpr (std::is_same<T, float>::value) {
    // CUDA-core path: 16 threads across 64 columns (4 each), 8 across rows
    constexpr int TM = kBM / 8;
    const int tx = tid % 16, ty = tid / 16;
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int t = 0; t < n_steps; ++t) {
      const int stage = arrive(t);
      const T* at = dys + stage * kBM * AS;
      const T* wt = ws + stage * kBN * WS;
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
        store(acc[i][j], dx + static_cast<size_t>(m) * n_in + col0 + tx * 4 +
                             j);
    }
  } else {
    // tensor-core path: warp w owns dx columns [16w, 16w + 16) of the tile
    using namespace nvcuda;
    constexpr int MF = kBM / 16;
    const int warp = tid / 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF];
#pragma unroll
    for (int i = 0; i < MF; ++i) wmma::fill_fragment(acc[i], 0.f);

    for (int t = 0; t < n_steps; ++t) {
      const int stage = arrive(t);
      const T* at = dys + stage * kBM * AS;
      const T* wt = ws + stage * kBN * WS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            bf;
        wmma::load_matrix_sync(bf, wt + warp * 16 * WS + kk, WS);
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              af;
          wmma::load_matrix_sync(af, at + i * 16 * AS + kk, AS);
          wmma::mma_sync(acc[i], af, bf, acc[i]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the stage ring is reused as the epilogue buffer
    constexpr int CS = kBN + 4;
    static_assert(TL::SMEM >= kBM * CS * 4, "epilogue buffer must fit");
    float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < MF; ++i)
      wmma::store_matrix_sync(cs + i * 16 * CS + warp * 16, acc[i], CS,
                              wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < kBM * kBN; e += kThreads) {
      const int r = e / kBN, c = e - r * kBN;
      const int m = m0 + r;
      if (m >= M) continue;
      store(cs[r * CS + c], dx + static_cast<size_t>(m) * n_in + col0 + c);
    }
  }
}

template <typename T>
plan::Dims dx_dims(int E, int M, int n_in) {
  return {dim3(n_in / kBN, E * ((M + kBM - 1) / kBM)), kThreads,
          static_cast<size_t>(DxTile<T>::SMEM)};
}

template <typename T, bool kExperts>
int launch(const void* dy, const void* aux, const void* w, const int* oidx,
           const int* oslot, void* dx, int E, int M, int n_rb, int d_in_b,
           int bL, int bR, int n_lb, int d_out_b, int act,
           cudaStream_t stream) {
  const int n_in = n_lb * bL;
  const plan::Dims d = dx_dims<T>(E, M, n_in);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        csd_spmm_dx_kernel<T, kExperts>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(d.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  csd_spmm_dx_kernel<T, kExperts><<<d.grid, d.threads, d.smem, stream>>>(
      static_cast<const T*>(dy), static_cast<const T*>(aux),
      static_cast<const T*>(w), oidx, oslot, static_cast<T*>(dx), M,
      n_rb * bR, n_in, d_in_b, bL, bR, d_out_b, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// E expert junctions of M rows each over one shared scatter pattern: dy and
// aux (E, M, n_rb * bR), w (E, n_rb, d_in_b, bL, bR), dx (E, M, n_lb * bL);
// E = 1 is the single junction.
// dtype: 0 float32, 1 bfloat16. act: 0 none (aux unused, may be null),
// 1 relu (aux = y), 2 gelu (aux = z).
// Preconditions (checked by the Python wrapper): contiguous tensors on one
// device, 16-byte aligned, bL % 64 == 0, bR % 64 == 0, M >= 1, E >= 1,
// E * ceil(M / 64) <= 65535, out_idx/out_slot (n_lb, d_out_b) int32 with
// n_lb * d_out_b == n_rb * d_in_b.
// Returns cudaGetLastError() after the launch.
extern "C" int csd_spmm_dx(const void* dy, const void* aux, const void* w,
                           const int* out_idx, const int* out_slot, void* dx,
                           int E, int M, int n_rb, int d_in_b, int bL, int bR,
                           int n_lb, int d_out_b, int dtype, int act,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool experts = E > 1;
  if (dtype == 0)
    return experts ? launch<float, true>(dy, aux, w, out_idx, out_slot, dx,
                                         E, M, n_rb, d_in_b, bL, bR, n_lb,
                                         d_out_b, act, s)
                   : launch<float, false>(dy, aux, w, out_idx, out_slot, dx,
                                          E, M, n_rb, d_in_b, bL, bR, n_lb,
                                          d_out_b, act, s);
  if (dtype == 1)
    return experts ? launch<__nv_bfloat16, true>(
                         dy, aux, w, out_idx, out_slot, dx, E, M, n_rb,
                         d_in_b, bL, bR, n_lb, d_out_b, act, s)
                   : launch<__nv_bfloat16, false>(
                         dy, aux, w, out_idx, out_slot, dx, E, M, n_rb,
                         d_in_b, bL, bR, n_lb, d_out_b, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch csd_spmm_dx makes for these arguments, from the host code it
// launches with: five ints (grid x, y, z, threads, dynamic shared memory
// bytes) written to out. Returns the launch count (1), or -1 for an unknown
// dtype.
extern "C" int csd_spmm_dx_plan(int E, int M, int n_lb, int bL, int dtype,
                                int* out) {
  if (dtype == 0)
    plan::put(out, 0, dx_dims<float>(E, M, n_lb * bL));
  else if (dtype == 1)
    plan::put(out, 0, dx_dims<__nv_bfloat16>(E, M, n_lb * bL));
  else
    return -1;
  return 1;
}
