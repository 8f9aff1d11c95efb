// csd_spmm_dw — backward-weights (UP, paper eq. (4b)) of the block-sparse
// junction for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/csd_spmm.py:csd_spmm_dw (Pallas body
// _dw_kernel), in its 4-D and its expert-batched (5-D) form:
//   dw[e, rb, f] = x[e, :, block_idx[rb, f]]^T @ mask(dy)[e, :, rb]
// summed over each expert's M rows, the pattern shared by all E experts,
// with the activation's derivative folded into dy from the saved aux (y for
// relu, the pre-activation z for gelu), f32 accumulation and dw stored in
// the dtype of x; with want_db also db[e, rb] = sum_m mask(dy)[e, m, rb] in
// f32. The 4-D form is E = 1.
//
// What bounds it on the card: every (bL x bR) block of the slab is a
// product with depth M (4096 tokens for gemma3-4b at 2 x 2048), so the work
// is 2 * M * (weights of the slab) operations, about 107 GFLOP for an
// up/gate junction and 172 GFLOP for down, against ~70-130 MB of x, dy, aux
// and dw: bound by operations, ~108 us (up/gate) and ~174 us (down) at
// 989 TFLOP/s in bf16. The expert junctions of granite-moe-1b-a400m in
// training (32 experts of C = 1280 rows, 128 x 256 blocks) are smaller
// products, about 21 and 32 GFLOP against ~140-150 MB: bound by bytes.
//
// What the design does about it: the Pallas grid revisits one dw block
// across the sequential M axis; here each CTA owns one 64 x 64 tile of one
// block (rb, f) and loops over all of M itself, so the reduction over M
// never crosses CTAs: no atomics, no second pass, and the result repeats
// bit for bit. The A operand x[:, blk]^T is read column-major straight from
// the row-major x tile (no transpose copy). Tiles of x, dy and aux stream
// through a 3-stage cp.async ring; each dy tile is masked in shared memory
// from its aux tile before the tensor cores read it (bf16 through WMMA
// fragments, f32 on the CUDA cores in full precision). db is the column sum
// of the masked tiles, taken in one fixed order (ascending M) by the CTAs
// of slot f = 0 and left-row tile 0 only, so each dy element is counted
// once. Rows past M are zero-filled on load and add nothing. Experts are
// folded into gridDim.z (blockIdx.z = e * n_rb * d_in_b + rb * d_in_b + f);
// each CTA offsets x, dy, aux, dw and db by its expert's strides, reads the
// one shared block_idx and still loops over all M rows of its expert.
#include "csd_spmm_common.cuh"

namespace {

using csd::cp_async16;
using csd::cp_async_commit;
using csd::cp_async_wait;
using csd::mask_tile;
using csd::store;
using csd::to_f32;

constexpr int kThreads = 128;
constexpr int kBI = 64;  // dw rows (inside bL) per CTA
constexpr int kBJ = 64;  // dw columns (inside bR) per CTA

template <typename T>
struct DwTile {
  static constexpr int BK = std::is_same<T, float>::value ? 32 : 64;  // M
  static constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int XS = kBI + EPC;  // x rows: [k][i], BK x kBI, padded
  static constexpr int DS = kBJ + EPC;  // dy/aux rows: [k][j], BK x kBJ
  static constexpr int STAGES = 3;
  static constexpr int SMEM =
      STAGES * (BK * XS + 2 * BK * DS) * static_cast<int>(sizeof(T));
};

// kExperts: E > 1, the expert index folded into gridDim.z. The single
// junction (E = 1) is compiled without the expert offsets, and the blocks
// per expert are derived here rather than passed: with either, its
// gelu-masked form ran measurably slower on the card (PERF.md).
template <typename T, bool kExperts>
__global__ void __launch_bounds__(kThreads)
    csd_spmm_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                       const T* __restrict__ aux, const int* __restrict__ idx,
                       T* __restrict__ dw, float* __restrict__ db, int M,
                       int n_in, int n_out, int d_in_b, int bL, int bR,
                       int act) {
  using TL = DwTile<T>;
  constexpr int BK = TL::BK, EPC = TL::EPC, XS = TL::XS, DS = TL::DS;
  constexpr int S = TL::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* dys = xs + S * BK * XS;
  T* auxs = dys + S * BK * DS;

  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * kBJ;  // column offset inside the right block
  const int i0 = blockIdx.y * kBI;  // row offset inside the left block
  int blk = blockIdx.z;  // rb * d_in_b + f
  if constexpr (kExperts) {
    const int n_blk = n_out / bR * d_in_b;  // slab blocks per expert
    const int ex = blockIdx.z / n_blk;      // this CTA's expert
    blk -= ex * n_blk;
    x += static_cast<size_t>(ex) * M * n_in;
    dy += static_cast<size_t>(ex) * M * n_out;
    if (aux != nullptr) aux += static_cast<size_t>(ex) * M * n_out;
    dw += static_cast<size_t>(ex) * n_blk * bL * bR;
    if (db != nullptr) db += static_cast<size_t>(ex) * n_out;
  }
  const int rb = blk / d_in_b;
  const int f = blk - rb * d_in_b;
  const int lb = __ldg(idx + blk);
  const bool takes_db = db != nullptr && f == 0 && blockIdx.y == 0;
  const int n_steps = (M + BK - 1) / BK;
  const size_t xcol = static_cast<size_t>(lb) * bL + i0;
  const size_t dcol = static_cast<size_t>(rb) * bR + j0;

  auto load_stage = [&](int t) {
    if (t >= n_steps) return;
    const int stage = t % S;
    const int mrow0 = t * BK;
    T* xdst = xs + stage * BK * XS;
    T* ddst = dys + stage * BK * DS;
    T* adst = auxs + stage * BK * DS;
    constexpr int C = kBI / EPC;  // chunks per row (kBI == kBJ)
    for (int c = tid; c < BK * C; c += kThreads) {
      const int r = c / C, cc = c - r * C;
      const int m = mrow0 + r;
      const bool ok = m < M;
      const size_t row = static_cast<size_t>(ok ? m : 0);
      cp_async16(xdst + r * XS + cc * EPC, x + row * n_in + xcol + cc * EPC,
                 ok);
      cp_async16(ddst + r * DS + cc * EPC, dy + row * n_out + dcol + cc * EPC,
                 ok);
      if (act != 0)
        cp_async16(adst + r * DS + cc * EPC,
                   aux + row * n_out + dcol + cc * EPC, ok);
    }
  };

  float colsum = 0.f;  // thread j < kBJ: db of column j0 + j

  // Waits for step t's tiles, masks its dy tile and adds it to db; returns
  // the stage.
  auto arrive = [&](int t) {
    cp_async_wait<S - 2>();
    __syncthreads();
    load_stage(t + S - 1);
    cp_async_commit();
    const int stage = t % S;
    T* d = dys + stage * BK * DS;
    if (act != 0) {
      const T* a = auxs + stage * BK * DS;
      mask_tile<T, BK, kBJ, DS, kThreads>(d, a, act, tid);
      __syncthreads();
    }
    if (takes_db && tid < kBJ)
      for (int r = 0; r < BK; ++r) colsum += to_f32(d[r * DS + tid]);
    return stage;
  };

  for (int s = 0; s < S - 1; ++s) {
    load_stage(s);
    cp_async_commit();
  }

  T* out = dw + (static_cast<size_t>(blk) * bL + i0) * bR + j0;
  if constexpr (std::is_same<T, float>::value) {
    // CUDA-core path: 16 threads across 64 columns (4 each), 8 across rows
    constexpr int TM = kBI / 8;
    const int tx = tid % 16, ty = tid / 16;
    float acc[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int t = 0; t < n_steps; ++t) {
      const int stage = arrive(t);
      const T* xt = xs + stage * BK * XS;
      const T* dt = dys + stage * BK * DS;
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        const float4 b4 =
            *reinterpret_cast<const float4*>(dt + kk * DS + tx * 4);
        const float4* ap =
            reinterpret_cast<const float4*>(xt + kk * XS + ty * TM);
#pragma unroll
        for (int q = 0; q < TM / 4; ++q) {
          const float4 a4 = ap[q];
          const float a[4] = {a4.x, a4.y, a4.z, a4.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int i = q * 4 + u;
            acc[i][0] = fmaf(a[u], b4.x, acc[i][0]);
            acc[i][1] = fmaf(a[u], b4.y, acc[i][1]);
            acc[i][2] = fmaf(a[u], b4.z, acc[i][2]);
            acc[i][3] = fmaf(a[u], b4.w, acc[i][3]);
          }
        }
      }
    }
    cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        store(acc[i][j],
              out + static_cast<size_t>(ty * TM + i) * bR + tx * 4 + j);
  } else {
    // tensor-core path: warp w owns dw columns [16w, 16w + 16) of the tile;
    // A = x tile read column-major (x^T), B = masked dy tile, row-major
    using namespace nvcuda;
    constexpr int MF = kBI / 16;
    const int warp = tid / 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF];
#pragma unroll
    for (int i = 0; i < MF; ++i) wmma::fill_fragment(acc[i], 0.f);

    for (int t = 0; t < n_steps; ++t) {
      const int stage = arrive(t);
      const T* xt = xs + stage * BK * XS;
      const T* dt = dys + stage * BK * DS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            bf;
        wmma::load_matrix_sync(bf, dt + kk * DS + warp * 16, DS);
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major>
              af;
          wmma::load_matrix_sync(af, xt + kk * XS + i * 16, XS);
          wmma::mma_sync(acc[i], af, bf, acc[i]);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the stage ring is reused as the epilogue buffer
    constexpr int CS = kBJ + 4;
    static_assert(TL::SMEM >= kBI * CS * 4, "epilogue buffer must fit");
    float* cs = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int i = 0; i < MF; ++i)
      wmma::store_matrix_sync(cs + i * 16 * CS + warp * 16, acc[i], CS,
                              wmma::mem_row_major);
    __syncthreads();
    for (int e = tid; e < kBI * kBJ; e += kThreads) {
      const int r = e / kBJ, c = e - r * kBJ;
      store(cs[r * CS + c], out + static_cast<size_t>(r) * bR + c);
    }
  }
  if (takes_db && tid < kBJ) db[dcol + tid] = colsum;
}

template <typename T>
plan::Dims dw_dims(int E, int n_rb, int d_in_b, int bL, int bR) {
  return {dim3(bR / kBJ, bL / kBI, E * n_rb * d_in_b), kThreads,
          static_cast<size_t>(DwTile<T>::SMEM)};
}

template <typename T, bool kExperts>
int launch(const void* x, const void* dy, const void* aux, const int* idx,
           void* dw, float* db, int E, int M, int n_in, int n_rb,
           int d_in_b, int bL, int bR, int act, cudaStream_t stream) {
  const plan::Dims d = dw_dims<T>(E, n_rb, d_in_b, bL, bR);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        csd_spmm_dw_kernel<T, kExperts>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(d.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  csd_spmm_dw_kernel<T, kExperts><<<d.grid, d.threads, d.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
      static_cast<const T*>(aux), idx, static_cast<T*>(dw), db, M, n_in,
      n_rb * bR, d_in_b, bL, bR, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// E expert junctions of M rows each over one shared pattern block_idx
// (n_rb, d_in_b): x (E, M, n_in), dy and aux (E, M, n_rb * bR), dw (E, n_rb,
// d_in_b, bL, bR); E = 1 is the single junction.
// dtype: 0 float32, 1 bfloat16. act: 0 none (aux unused, may be null),
// 1 relu (aux = y), 2 gelu (aux = z). db (nullable): E * n_rb * bR floats.
// Preconditions (checked by the Python wrapper): contiguous tensors on one
// device, 16-byte aligned, bL % 64 == 0, bR % 64 == 0, n_in % bL == 0,
// M >= 1, E >= 1, E * n_rb * d_in_b <= 65535.
// Returns cudaGetLastError() after the launch.
extern "C" int csd_spmm_dw(const void* x, const void* dy, const void* aux,
                           const int* block_idx, void* dw, float* db, int E,
                           int M, int n_in, int n_rb, int d_in_b, int bL,
                           int bR, int dtype, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool experts = E > 1;
  if (dtype == 0)
    return experts ? launch<float, true>(x, dy, aux, block_idx, dw, db, E, M,
                                         n_in, n_rb, d_in_b, bL, bR, act, s)
                   : launch<float, false>(x, dy, aux, block_idx, dw, db, E,
                                          M, n_in, n_rb, d_in_b, bL, bR, act,
                                          s);
  if (dtype == 1)
    return experts ? launch<__nv_bfloat16, true>(x, dy, aux, block_idx, dw,
                                                 db, E, M, n_in, n_rb,
                                                 d_in_b, bL, bR, act, s)
                   : launch<__nv_bfloat16, false>(x, dy, aux, block_idx, dw,
                                                  db, E, M, n_in, n_rb,
                                                  d_in_b, bL, bR, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch csd_spmm_dw makes for these arguments, from the host code it
// launches with: five ints (grid x, y, z, threads, dynamic shared memory
// bytes) written to out. Returns the launch count (1), or -1 for an unknown
// dtype.
extern "C" int csd_spmm_dw_plan(int E, int n_rb, int d_in_b, int bL, int bR,
                                int dtype, int* out) {
  if (dtype == 0)
    plan::put(out, 0, dw_dims<float>(E, n_rb, d_in_b, bL, bR));
  else if (dtype == 1)
    plan::put(out, 0, dw_dims<__nv_bfloat16>(E, n_rb, d_in_b, bL, bR));
  else
    return -1;
  return 1;
}
