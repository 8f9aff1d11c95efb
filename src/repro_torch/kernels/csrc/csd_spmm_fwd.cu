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
// What bounds it on the card: in decode M is the number of serving slots
// (a handful of rows), so the kernel is bound by the bytes of the weight
// slab it has to stream once. For gemma3-4b in bf16 that is 26.2 MB per
// up/gate junction and 41.9 MB per down junction, about 7.8 us and 12.5 us
// at 3.35 TB/s. Prefill (M = slots x chunk) is still below the bf16 ridge
// point at the chunk sizes the engine uses. The MoE decode step of
// granite-moe-1b-a400m (32 experts of C = 4 rows each) streams every expert
// slab once: 16.8 MB per up/gate call and 25.2 MB per down call in bf16,
// 5.0 us and 7.5 us.
//
// What the design does about it: the Pallas grid revisits one output tile
// across the sequential fan-in axis f; blocks on the GPU run in no order,
// so each CTA owns one (BM x 64) output tile (64 columns of one right
// block) and loops over fan-in slots and over bL in BK chunks itself,
// reading its own block_idx row. Every weight element is read by exactly
// one CTA, once. Tiles of x and w stream through a cp.async ring (6 stages
// for decode-sized M, 3 for prefill) so that many loads are in flight while
// the current chunk is multiplied (bf16 through WMMA tensor-core fragments,
// f32 on the CUDA cores in full precision). When the output tiles alone
// are too few to fill the card (gemma3's down junction has 40 in decode),
// the fan-in slots are split over gridDim.z CTAs that write f32 partial
// sums, and a second small kernel adds them in a fixed order (the result
// does not depend on scheduling). Experts are folded into gridDim.y
// (expert e owns row tiles [e * m_tiles, (e + 1) * m_tiles)); each CTA
// offsets x, w, bias and its output rows by its expert's strides, and the
// split counts the output tiles of all experts. The ragged M edge is
// masked with zero-filled loads and guarded stores rather than padded. The
// epilogue adds the bias, applies relu or tanh-gelu and casts, so the
// pre-activation never reaches device memory except as those partial sums,
// or as the second output z when training asks for it (save_preact: the
// backward of gelu needs z; the epilogue, or the split's second pass,
// writes it beside y from the same f32 value).
#include "csd_spmm_common.cuh"

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

template <typename T, int BM>
int launch(const void* x, const void* w, const int* idx, const void* bias,
           void* y, void* z, float* partial, int E, int M, int n_in,
           int n_rb, int d_in_b, int bL, int bR, int n_splits, int act,
           cudaStream_t stream) {
  constexpr int smem = Tile<T, BM>::SMEM;
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        csd_spmm_fwd_kernel<T, BM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int n_out = n_rb * bR;
  const int per_split = (d_in_b + n_splits - 1) / n_splits;
  dim3 grid(n_out / kBN, E * ((M + BM - 1) / BM), n_splits);
  csd_spmm_fwd_kernel<T, BM><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), idx,
      static_cast<const T*>(bias), static_cast<T*>(y), static_cast<T*>(z),
      n_splits > 1 ? partial : nullptr, E, M, n_in, d_in_b, bL, bR, n_out,
      per_split, act);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return static_cast<int>(e);
  const size_t total = static_cast<size_t>(E) * M * n_out;
  const int blocks = static_cast<int>((total + 255) / 256);
  csd::reduce_splits_kernel<T><<<blocks, 256, 0, stream>>>(
      partial, static_cast<const T*>(bias), static_cast<T*>(y),
      static_cast<T*>(z), E, M, n_out, n_splits, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// E expert junctions of M rows each over one shared pattern idx (n_rb,
// d_in_b): x (E, M, n_in), w (E, n_rb, d_in_b, bL, bR), bias (E, n_rb * bR)
// or null, y and z (E, M, n_rb * bR); E = 1 is the single junction.
// dtype: 0 float32, 1 bfloat16. act: 0 none, 1 relu, 2 gelu (tanh).
// n_splits: how many CTAs share one output tile's fan-in slots (1 = no
// second pass); every split must own at least one slot, and `partial`
// must then hold n_splits * E * M * n_rb * bR floats. z (nullable): where
// to write the pre-activation x @ W + b, in the dtype of x.
// Preconditions (checked by the Python wrapper): contiguous tensors on one
// device, 16-byte aligned, bL % 64 == 0, bR % 64 == 0, M >= 1, E >= 1,
// E * ceil(M / BM) <= 65535 (BM = 16 for M <= 16, else 64).
// Returns cudaGetLastError() after the launches.
extern "C" int csd_spmm_fwd(const void* x, const void* w, const int* idx,
                            const void* bias, void* y, void* z,
                            float* partial, int E, int M, int n_in,
                            int n_rb, int d_in_b, int bL, int bR,
                            int n_splits, int dtype, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = M <= 16;
  if (dtype == 0)
    return small ? launch<float, 16>(x, w, idx, bias, y, z, partial, E, M,
                                     n_in, n_rb, d_in_b, bL, bR, n_splits,
                                     act, s)
                 : launch<float, 64>(x, w, idx, bias, y, z, partial, E, M,
                                     n_in, n_rb, d_in_b, bL, bR, n_splits,
                                     act, s);
  if (dtype == 1)
    return small ? launch<__nv_bfloat16, 16>(x, w, idx, bias, y, z, partial,
                                             E, M, n_in, n_rb, d_in_b, bL,
                                             bR, n_splits, act, s)
                 : launch<__nv_bfloat16, 64>(x, w, idx, bias, y, z, partial,
                                             E, M, n_in, n_rb, d_in_b, bL,
                                             bR, n_splits, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
