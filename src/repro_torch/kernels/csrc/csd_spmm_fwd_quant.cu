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
// MB per down call, 2.5 us and 3.8 us.
//
// What the design does about it: csd_spmm_fwd.cu's schedule, unchanged:
// one CTA per (BM x 64) output tile looping over its fan-in slots and bL in
// BK chunks, the slots split over gridDim.z CTAs with the ordered f32
// second pass when the tiles alone are too few, a cp.async ring (6 stages
// for decode-sized M, 3 for prefill), experts folded into gridDim.y with
// each CTA offsetting x, q, s, bias and its output rows by its expert's
// strides. What changes is the weight tile: it arrives as int8, so one
// 16-byte copy carries 16 weights and a 64 x 64 tile is 4 KB. For bf16 x
// every thread widens its share of the arrived int8 tile to bf16 in shared
// memory (exact for |q| <= 127) behind one barrier, and the tensor cores
// read the widened tile; for f32 x the CUDA-core loop converts four int8
// weights to f32 in registers. The scale is uniform over a block, so the
// CTA keeps a second accumulator for the current slot (bL / BK k-steps, 4
// at bL = 256), and at the slot's end adds it times the slot's scale into
// the running sum, element by element in the accumulator fragments (legal
// because both fragments share one layout). The scale is not folded into
// the weights: bf16(q * s) would round where the reference does not. Bias,
// activation and cast run in the epilogue of csd_spmm_fwd.cu.
#include "csd_spmm_common.cuh"

namespace {

using csd::cp_async16;
using csd::cp_async_commit;
using csd::cp_async_wait;
using csd::emit;

constexpr int kThreads = 128;
constexpr int kBN = 64;
constexpr int kQS = kBN + 16;  // padded int8 row stride, 16-byte rows

template <typename T, int BM>
struct QTile {
  static constexpr bool kTensor = !std::is_same<T, float>::value;
  static constexpr int BK = kTensor ? 64 : 32;
  static constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int XS = BK + EPC;         // padded x row stride
  static constexpr int WS = kBN + EPC;        // widened weight row stride
  static constexpr int STAGES = BM == 16 ? 6 : 3;
  static constexpr int X_BYTES = BM * XS * static_cast<int>(sizeof(T));
  static constexpr int Q_BYTES = BK * kQS;
  static constexpr int RING = STAGES * (X_BYTES + Q_BYTES);
  static constexpr int SMEM =
      RING + (kTensor ? BK * WS * static_cast<int>(sizeof(T)) : 0);
};

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads)
    csd_spmm_fwd_quant_kernel(const T* __restrict__ x,
                              const int8_t* __restrict__ w,
                              const float* __restrict__ scale,
                              const int* __restrict__ idx,
                              const T* __restrict__ bias, T* __restrict__ y,
                              float* __restrict__ partial, int E, int M,
                              int n_in, int d_in_b, int bL, int bR,
                              int n_out, int slots_per_split, int act) {
  using TL = QTile<T, BM>;
  constexpr int BK = TL::BK, EPC = TL::EPC, XS = TL::XS, WS = TL::WS;
  constexpr int S = TL::STAGES;
  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
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
  // the scale of the slot that k-step t belongs to
  auto slot_scale = [&](int t) {
    return __ldg(scale + rb * d_in_b + f0 + t / steps_per_slot);
  };

  for (int s = 0; s < S - 1; ++s) {
    load_stage(s);
    cp_async_commit();
  }

  if constexpr (!TL::kTensor) {
    // CUDA-core path: 16 threads across 64 columns (4 each), 8 across rows
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
      const T* xt = xs + (t % S) * BM * XS;
      const int8_t* qt = qs + (t % S) * BK * kQS;
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const char4 b4 = *reinterpret_cast<const char4*>(qt + kk * kQS + tx * 4);
        const float b0 = b4.x, b1 = b4.y, b2 = b4.z, b3 = b4.w;
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
        const float s = slot_scale(t);
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
        emit(acc[i][j], row0 + m, col0 + tx * 4 + j, E * M, n_out, bias,
             y, static_cast<T*>(nullptr), partial, act);
    }
  } else {
    // tensor-core path: warp w owns columns [16w, 16w + 16) of the tile
    using namespace nvcuda;
    constexpr int MF = BM / 16;
    T* wb = reinterpret_cast<T*>(smem + TL::RING);  // widened weight tile
    const int warp = tid / 32;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF], part[MF];
#pragma unroll
    for (int i = 0; i < MF; ++i) wmma::fill_fragment(acc[i], 0.f);

    for (int t = 0; t < n_steps; ++t) {
      cp_async_wait<S - 2>();
      __syncthreads();  // stage t arrived; every warp is done with wb
      load_stage(t + S - 1);
      cp_async_commit();
      const int kstep = t % steps_per_slot;
      if (kstep == 0) {
#pragma unroll
        for (int i = 0; i < MF; ++i) wmma::fill_fragment(part[i], 0.f);
      }
      // widen the int8 tile: 16 weights per thread and pass
      const int8_t* qt = qs + (t % S) * BK * kQS;
      constexpr int QC = kBN / 16;
      for (int c = tid; c < BK * QC; c += kThreads) {
        const int r = c / QC, cc = c - r * QC;
        const int4 v = *reinterpret_cast<const int4*>(qt + r * kQS + cc * 16);
        const int8_t* e = reinterpret_cast<const int8_t*>(&v);
        uint4 out[2];
        __nv_bfloat16* o = reinterpret_cast<__nv_bfloat16*>(out);
#pragma unroll
        for (int i = 0; i < 16; ++i)
          o[i] = __float2bfloat16(static_cast<float>(e[i]));
        uint4* dst = reinterpret_cast<uint4*>(wb + r * WS + cc * 16);
        dst[0] = out[0];
        dst[1] = out[1];
      }
      __syncthreads();
      const T* xt = xs + (t % S) * BM * XS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            bf;
        wmma::load_matrix_sync(bf, wb + kk * WS + warp * 16, WS);
#pragma unroll
        for (int i = 0; i < MF; ++i) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              af;
          wmma::load_matrix_sync(af, xt + i * 16 * XS + kk, XS);
          wmma::mma_sync(part[i], af, bf, part[i]);
        }
      }
      if (kstep == steps_per_slot - 1) {
        const float s = slot_scale(t);
#pragma unroll
        for (int i = 0; i < MF; ++i)
#pragma unroll
          for (int e = 0; e < part[i].num_elements; ++e)
            acc[i].x[e] += part[i].x[e] * s;
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the stage ring is reused as the epilogue buffer
    constexpr int CS = kBN + 4;
    static_assert(TL::RING >= BM * CS * 4, "epilogue buffer must fit");
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
      emit(cs[r * CS + c], row0 + m, col0 + c, E * M, n_out, bias, y,
           static_cast<T*>(nullptr), partial, act);
    }
  }
}

template <typename T, int BM>
plan::Dims split_dims(int E, int M, int n_rb, int bR, int n_splits) {
  return {dim3(n_rb * bR / kBN, E * ((M + BM - 1) / BM), n_splits), kThreads,
          static_cast<size_t>(QTile<T, BM>::SMEM)};
}

template <typename T, int BM>
int launch(const void* x, const void* w, const float* scale, const int* idx,
           const void* bias, void* y, float* partial, int E, int M,
           int n_in, int n_rb, int d_in_b, int bL, int bR, int n_splits,
           int act, cudaStream_t stream) {
  const plan::Dims d = split_dims<T, BM>(E, M, n_rb, bR, n_splits);
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        csd_spmm_fwd_quant_kernel<T, BM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(d.smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int n_out = n_rb * bR;
  const int per_split = (d_in_b + n_splits - 1) / n_splits;
  csd_spmm_fwd_quant_kernel<T, BM><<<d.grid, d.threads, d.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w), scale, idx,
      static_cast<const T*>(bias), static_cast<T*>(y),
      n_splits > 1 ? partial : nullptr, E, M, n_in, d_in_b, bL, bR, n_out,
      per_split, act);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_splits == 1) return static_cast<int>(e);
  const plan::Dims r = csd::reduce_dims(static_cast<size_t>(E) * M * n_out);
  csd::reduce_splits_kernel<T><<<r.grid, r.threads, r.smem, stream>>>(
      partial, static_cast<const T*>(bias), static_cast<T*>(y),
      static_cast<T*>(nullptr), E, M, n_out, n_splits, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BM>
int plan_of(int E, int M, int n_rb, int bR, int n_splits, int* out) {
  plan::put(out, 0, split_dims<T, BM>(E, M, n_rb, bR, n_splits));
  if (n_splits == 1) return 1;
  plan::put(out, 1, csd::reduce_dims(static_cast<size_t>(E) * M * n_rb * bR));
  return 2;
}

}  // namespace

// E expert junctions of M rows each over one shared pattern idx (n_rb,
// d_in_b); E = 1 is the single junction. x (E, M, n_in), bias (E, n_rb *
// bR) or null and y (E, M, n_rb * bR): dtype 0 float32, 1 bfloat16. w: int8
// (E, n_rb, d_in_b, bL, bR); w_scale: float32 (E, n_rb, d_in_b). act: 0
// none, 1 relu, 2 gelu (tanh). n_splits: how many CTAs share one output
// tile's fan-in slots (1 = no second pass); every split must own at least
// one slot, and `partial` must then hold n_splits * E * M * n_rb * bR
// floats.
// Preconditions (checked by the Python wrapper): contiguous tensors on one
// device, 16-byte aligned, bL % 64 == 0, bR % 64 == 0, M >= 1, E >= 1,
// E * ceil(M / BM) <= 65535 (BM = 16 for M <= 16, else 64).
// Returns cudaGetLastError() after the launches.
extern "C" int csd_spmm_fwd_quant(const void* x, const void* w,
                                  const float* w_scale, const int* idx,
                                  const void* bias, void* y, float* partial,
                                  int E, int M, int n_in, int n_rb,
                                  int d_in_b, int bL, int bR, int n_splits,
                                  int dtype, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = M <= 16;
  if (dtype == 0)
    return small ? launch<float, 16>(x, w, w_scale, idx, bias, y, partial, E,
                                     M, n_in, n_rb, d_in_b, bL, bR, n_splits,
                                     act, s)
                 : launch<float, 64>(x, w, w_scale, idx, bias, y, partial, E,
                                     M, n_in, n_rb, d_in_b, bL, bR, n_splits,
                                     act, s);
  if (dtype == 1)
    return small ? launch<__nv_bfloat16, 16>(x, w, w_scale, idx, bias, y,
                                             partial, E, M, n_in, n_rb,
                                             d_in_b, bL, bR, n_splits, act, s)
                 : launch<__nv_bfloat16, 64>(x, w, w_scale, idx, bias, y,
                                             partial, E, M, n_in, n_rb,
                                             d_in_b, bL, bR, n_splits, act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launches csd_spmm_fwd_quant makes for these arguments, from the host
// code it launches with: five ints each (grid x, y, z, threads, dynamic
// shared memory bytes) written to out (room for 2). Returns the launch
// count, or -1 for an unknown dtype.
extern "C" int csd_spmm_fwd_quant_plan(int E, int M, int n_rb, int bR,
                                       int n_splits, int dtype, int* out) {
  const bool small = M <= 16;
  if (dtype == 0)
    return small ? plan_of<float, 16>(E, M, n_rb, bR, n_splits, out)
                 : plan_of<float, 64>(E, M, n_rb, bR, n_splits, out);
  if (dtype == 1)
    return small ? plan_of<__nv_bfloat16, 16>(E, M, n_rb, bR, n_splits, out)
                 : plan_of<__nv_bfloat16, 64>(E, M, n_rb, bR, n_splits, out);
  return -1;
}
