// csd_spmm_fwd.cuh — the forward block-sparse junction kernel for Hopper
// (sm_90a), shared by csd_spmm_fwd.cu (the shipped forward: fan-in splits
// store f32 partial sums, and an ordered second pass adds them) and
// csd_spmm_fwd_injected_alias.cu (sparselint's self-test: every split stores
// straight into y). csd_spmm_fwd.cu says what it computes and why.
#pragma once

#include "csd_spmm_common.cuh"
#include "plan.cuh"

// Internal linkage (the inner anonymous namespace): each library that
// includes this header keeps its own kernel and its own `configured` flag.
// With external linkage the flag would be one STB_GNU_UNIQUE object for the
// whole process, so the first library to launch would skip the other's
// shared-memory opt-in and its launch would fail.
namespace csd_fwd {
namespace {


using csd::cp_async16;
using csd::cp_async_commit;
using csd::cp_async_wait;
using csd::emit;

constexpr int kThreads = 128;
constexpr int kBN = 64;

template <typename T, int BM>
struct Tile {
  static constexpr int BK = std::is_same<T, float>::value ? 32 : 64;
  static constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int XS = BK + EPC;         // padded smem row strides
  static constexpr int WS = kBN + EPC;
  static constexpr int STAGES = BM == 16 ? 6 : 3;
  static constexpr int SMEM =
      STAGES * (BM * XS + BK * WS) * static_cast<int>(sizeof(T));
};

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
    csd_spmm_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const int* __restrict__ idx, const T* __restrict__ bias,
                        T* __restrict__ y, T* __restrict__ zout,
                        float* __restrict__ partial, int E, int M,
                        int n_in, int d_in_b, int bL, int bR, int n_out,
                        int slots_per_split, int act) {
  using TL = Tile<T, BM>;
  constexpr int BK = TL::BK, EPC = TL::EPC, XS = TL::XS, WS = TL::WS;
  constexpr int S = TL::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* ws = xs + S * BM * XS;

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
    const T* xsrc = x + static_cast<size_t>(lb) * bL + k0;
    T* xdst = xs + stage * BM * XS;
    constexpr int XC = BK / EPC;  // chunks per x row
    for (int c = tid; c < BM * XC; c += kThreads) {
      const int r = c / XC, cc = c - r * XC;
      const int m = m0 + r;
      const bool ok = m < M;
      cp_async16(xdst + r * XS + cc * EPC,
                 xsrc + static_cast<size_t>(ok ? m : 0) * n_in + cc * EPC, ok);
    }
    const T* wsrc =
        w + ((static_cast<size_t>(rb) * d_in_b + f) * bL + k0) * bR + n0;
    T* wdst = ws + stage * BK * WS;
    constexpr int WC = kBN / EPC;  // chunks per w row
    for (int c = tid; c < BK * WC; c += kThreads) {
      const int r = c / WC, cc = c - r * WC;
      cp_async16(wdst + r * WS + cc * EPC,
                 wsrc + static_cast<size_t>(r) * bR + cc * EPC, true);
    }
  };

  for (int s = 0; s < S - 1; ++s) {
    load_stage(s);
    cp_async_commit();
  }

  if constexpr (std::is_same<T, float>::value) {
    // CUDA-core path: 16 threads across 64 columns (4 each), 8 across rows
    constexpr int TM = BM / 8;
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
      const T* xt = xs + (t % S) * BM * XS;
      const T* wt = ws + (t % S) * BK * WS;
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(wt + kk * WS + tx * 4);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = xt[(ty * TM + i) * XS + kk];
          acc[i][0] = fmaf(a, b4.x, acc[i][0]);
          acc[i][1] = fmaf(a, b4.y, acc[i][1]);
          acc[i][2] = fmaf(a, b4.z, acc[i][2]);
          acc[i][3] = fmaf(a, b4.w, acc[i][3]);
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
        emit(acc[i][j], row0 + m, col0 + tx * 4 + j, E * M, n_out, bias,
             y, zout, partial, act);
    }
  } else {
    // tensor-core path: warp w owns columns [16w, 16w + 16) of the tile
    using namespace nvcuda;
    constexpr int MF = BM / 16;
    const int warp = tid / 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF];
#pragma unroll
    for (int i = 0; i < MF; ++i) wmma::fill_fragment(acc[i], 0.f);

    for (int t = 0; t < n_steps; ++t) {
      cp_async_wait<S - 2>();
      __syncthreads();
      load_stage(t + S - 1);
      cp_async_commit();
      const T* xt = xs + (t % S) * BM * XS;
      const T* wt = ws + (t % S) * BK * WS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            bf;
        wmma::load_matrix_sync(bf, wt + kk * WS + warp * 16, WS);
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              af;
          wmma::load_matrix_sync(af, xt + i * 16 * XS + kk, XS);
          wmma::mma_sync(acc[i], af, bf, acc[i]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the stage ring is reused as the epilogue buffer
    constexpr int CS = kBN + 4;
    static_assert(TL::SMEM >= BM * CS * 4, "epilogue buffer must fit");
    float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < MF; ++i)
      wmma::store_matrix_sync(cs + i * 16 * CS + warp * 16, acc[i], CS,
                              wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < BM * kBN; e += kThreads) {
      const int r = e / kBN, c = e - r * kBN;
      const int m = m0 + r;
      if (m >= M) continue;
      emit(cs[r * CS + c], row0 + m, col0 + c, E * M, n_out, bias, y, zout,
           partial, act);
    }
  }
}


// The kernel's launch: one CTA per (BM x 64) output tile of every expert
// and fan-in split.
template <typename T, int BM>
plan::Dims split_dims(int E, int M, int n_rb, int bR, int n_splits) {
  return {dim3(n_rb * bR / kBN, E * ((M + BM - 1) / BM), n_splits), kThreads,
          static_cast<size_t>(Tile<T, BM>::SMEM)};
}

// Launches the kernel over n_splits fan-in splits of d_in_b slots: each
// split's CTAs store f32 partial sums to `partial` when it is given, else
// the finished tile (bias, activation, and z when given) straight to y.
template <typename T, int BM>
int launch_splits(const void* x, const void* w, const int* idx,
                  const void* bias, void* y, void* z, float* partial, int E,
                  int M, int n_in, int n_rb, int d_in_b, int bL, int bR,
                  int n_splits, int act, cudaStream_t stream) {
  const plan::Dims d = split_dims<T, BM>(E, M, n_rb, bR, n_splits);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        csd_spmm_fwd_kernel<T, BM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(d.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int per_split = (d_in_b + n_splits - 1) / n_splits;
  csd_spmm_fwd_kernel<T, BM><<<d.grid, d.threads, d.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), idx,
      static_cast<const T*>(bias), static_cast<T*>(y), static_cast<T*>(z),
      partial, E, M, n_in, d_in_b, bL, bR, n_rb * bR, per_split, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace csd_fwd
