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
// What bounds it on the card. In decode M is the number of serving slots
// (a handful of rows), so the kernel is bound by the bytes of the weight
// slab it has to stream once: for gemma3-4b in bf16 26.2 MB per up/gate
// junction and 41.9 MB per down junction, about 7.8 us and 12.5 us at
// 3.35 TB/s; the MoE decode step of granite-moe-1b-a400m (32 experts of
// C = 4 rows) 16.8 MB per up/gate call and 25.2 MB per down call. In
// training M is batch x sequence (4096 for gemma3-4b at 2 x 2048), and the
// work, 2 * M * (weights of the slab) operations (107 GFLOP for an
// up/gate junction, 172 for down), is far above the bf16 ridge point:
// bound by operations, ~109 us and ~174 us at 989 TFLOP/s. The expert
// junctions of granite-moe-1b-a400m in training (32 experts of C = 1280
// rows, 128 x 256 blocks) are smaller products, 21 and 32 GFLOP against
// ~140 MB: bound by bytes.
//
// What the design does about it: two bodies. The caller's plan
// (launch.fwd_tile_n) picks one and passes it as tile_n: the wgmma body
// and its tile width, or 0 for the grid body.
//
// bf16 at the training shapes, the expert-batched decode and most of
// prefill: csd_spmm_fwd_wgmma_kernel of csd_spmm_fwd_wgmma.cuh (shared with
// the int8 forward, which instantiates it for int8 weights), a persistent
// GEMM over gathered left blocks on wgmma fed by TMA, 128 x BN tiles (BN
// 256, 128 or 64 dividing bR), the fan-in a loop inside the CTA, y and z
// staged in shared memory and stored with TMA; its design is described
// there. (Storing y and z from the
// registers instead, as bf16 pairs that spread each warp's store over 8
// rows, took a third longer at gemma3-4b's gate junction, whose y and z
// are 84 MB each: PERF.md, section 6.)
//
// f32, the single junction's decode (M <= 16) and shapes whose few
// 128-row tiles would leave most SMs idle on a deep fan-in (gemma3-4b's
// down junction below 128 rows): csd_spmm_fwd_kernel in csd_spmm_fwd.cuh
// (which sparselint's race-broken copy shares). Each CTA
// owns one (BM x 64) output tile, BM = 16 for M <= 16 else 64, and loops
// over the fan-in slots itself, tiles of x and w streaming through a
// cp.async ring (6 stages for decode-sized M, 3 otherwise) into WMMA
// fragments (bf16) or the CUDA cores (f32). When the output tiles alone
// are too few to fill the card (gemma3's down junction has 40 in decode),
// the fan-in slots are split over gridDim.z CTAs that write f32 partial
// sums, and a second small kernel adds them in a fixed order. Experts are
// folded into gridDim.y; the ragged M edge is masked with zero-filled
// loads and guarded stores; the epilogue (csd::emit) adds the bias, applies
// the activation and stores y and, with save_preact, z.
#include "csd_spmm_fwd.cuh"
#include "csd_spmm_fwd_wgmma.cuh"

namespace {

using Bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// which body, and the launchers
// ---------------------------------------------------------------------------

// Whether tile_n names a body the kernels have for these arguments: 0 the
// grid body, or in bf16 a wgmma tile width that divides bR.
bool body_taken(int dtype, int bR, int tile_n) {
  return tile_n == 0 ||
         (dtype == 1 && (tile_n == 64 || tile_n == 128 || tile_n == 256) &&
          bR % tile_n == 0);
}

template <typename T, int BM>
int launch_grid(const void* x, const void* w, const int* idx,
                const void* bias, void* y, void* z, float* partial, int E,
                int M, int n_in, int n_rb, int d_in_b, int bL, int bR,
                int n_splits, int act, cudaStream_t stream) {
  const int e = csd_fwd::launch_splits<T, BM>(
      x, w, idx, bias, y, z, n_splits > 1 ? partial : nullptr, E, M, n_in,
      n_rb, d_in_b, bL, bR, n_splits, act, stream);
  if (e != 0 || n_splits == 1) return e;
  const plan::Dims d = csd::reduce_dims(static_cast<size_t>(E) * M * n_rb *
                                        bR);
  csd::reduce_splits_kernel<T><<<d.grid, d.threads, d.smem, stream>>>(
      partial, static_cast<const T*>(bias), static_cast<T*>(y),
      static_cast<T*>(z), E, M, n_rb * bR, n_splits, act);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int BM>
int grid_plan(int E, int M, int n_rb, int bR, int n_splits, int* out) {
  plan::put(out, 0, csd_fwd::split_dims<T, BM>(E, M, n_rb, bR, n_splits));
  if (n_splits == 1) return 1;
  plan::put(out, 1, csd::reduce_dims(static_cast<size_t>(E) * M * n_rb * bR));
  return 2;
}

}  // namespace

// E expert junctions of M rows each over one shared pattern idx (n_rb,
// d_in_b): x (E, M, n_in), w (E, n_rb, d_in_b, bL, bR), bias (E, n_rb * bR)
// or null, y and z (E, M, n_rb * bR); E = 1 is the single junction.
// dtype: 0 float32, 1 bfloat16. act: 0 none, 1 relu, 2 gelu (tanh).
// tile_n: the body launch.fwd_plan chose, 0 the grid body, 64/128/256 the
// wgmma body at that tile width; n_sm: the SMs its persistent CTAs may
// fill. n_splits (grid body only; 1
// with the wgmma body): how many CTAs share one output tile's fan-in slots
// (1 = no second pass); every split must own at least one slot, and
// `partial` must then hold n_splits * E * M * n_rb * bR floats. z
// (nullable): where to write the pre-activation x @ W + b, in the dtype of
// x.
// Preconditions (checked by the Python wrapper): contiguous tensors on one
// device, 16-byte aligned, bL % 64 == 0, bR % 64 == 0, M >= 1, E >= 1, and
// for the grid body E * ceil(M / BM) <= 65535 (BM = 16 for M <= 16, else
// 64). Returns cudaGetLastError() after the launches, 10001 if the driver
// refused a tensor map, or cudaErrorInvalidValue for arguments the kernels
// do not take.
extern "C" int csd_spmm_fwd(const void* x, const void* w, const int* idx,
                            const void* bias, void* y, void* z,
                            float* partial, int E, int M, int n_in,
                            int n_rb, int d_in_b, int bL, int bR,
                            int n_splits, int n_sm, int tile_n, int dtype,
                            int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bn = tile_n;
  if (!body_taken(dtype, bR, bn) || (bn > 0 && n_splits != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (bn == 256)
    return fwd_wgmma::launch_wgmma_act<Bf16, 256>(
        x, w, nullptr, idx, bias, y, z, E, M, n_in, n_rb, d_in_b, bL, bR,
        n_sm, act, s);
  if (bn == 128)
    return fwd_wgmma::launch_wgmma_act<Bf16, 128>(
        x, w, nullptr, idx, bias, y, z, E, M, n_in, n_rb, d_in_b, bL, bR,
        n_sm, act, s);
  if (bn == 64)
    return fwd_wgmma::launch_wgmma_act<Bf16, 64>(
        x, w, nullptr, idx, bias, y, z, E, M, n_in, n_rb, d_in_b, bL, bR,
        n_sm, act, s);
  const bool small = M <= 16;
  if (dtype == 0)
    return small ? launch_grid<float, 16>(x, w, idx, bias, y, z, partial, E,
                                          M, n_in, n_rb, d_in_b, bL, bR,
                                          n_splits, act, s)
                 : launch_grid<float, 64>(x, w, idx, bias, y, z, partial, E,
                                          M, n_in, n_rb, d_in_b, bL, bR,
                                          n_splits, act, s);
  if (dtype == 1)
    return small ? launch_grid<__nv_bfloat16, 16>(x, w, idx, bias, y, z,
                                                  partial, E, M, n_in, n_rb,
                                                  d_in_b, bL, bR, n_splits,
                                                  act, s)
                 : launch_grid<__nv_bfloat16, 64>(x, w, idx, bias, y, z,
                                                  partial, E, M, n_in, n_rb,
                                                  d_in_b, bL, bR, n_splits,
                                                  act, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launches csd_spmm_fwd makes for these arguments, from the host code it
// launches with: six ints each (grid x, y, z, threads, dynamic shared memory
// bytes, cluster) written to out (room for 2). Returns the launch count, or -1
// for arguments csd_spmm_fwd refuses.
extern "C" int csd_spmm_fwd_plan(int E, int M, int n_rb, int bR,
                                 int n_splits, int n_sm, int tile_n,
                                 int dtype, int* out) {
  if (!body_taken(dtype, bR, tile_n) || (tile_n > 0 && n_splits != 1))
    return -1;
  if (tile_n > 0) {
    plan::put(out, 0,
              fwd_wgmma::wgmma_dims<Bf16>(E, M, n_rb, bR, tile_n, n_sm));
    return 1;
  }
  const bool small = M <= 16;
  if (dtype == 0)
    return small ? grid_plan<float, 16>(E, M, n_rb, bR, n_splits, out)
                 : grid_plan<float, 64>(E, M, n_rb, bR, n_splits, out);
  if (dtype == 1)
    return small ? grid_plan<__nv_bfloat16, 16>(E, M, n_rb, bR, n_splits, out)
                 : grid_plan<__nv_bfloat16, 64>(E, M, n_rb, bR, n_splits,
                                                out);
  return -1;
}
