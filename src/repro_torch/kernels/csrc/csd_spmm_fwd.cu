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
// writes it beside y from the same f32 value). The kernel is in
// csd_spmm_fwd.cuh, which sparselint's race-broken copy shares.
#include "csd_spmm_fwd.cuh"

namespace {

template <typename T, int BM>
int launch(const void* x, const void* w, const int* idx, const void* bias,
           void* y, void* z, float* partial, int E, int M, int n_in,
           int n_rb, int d_in_b, int bL, int bR, int n_splits, int act,
           cudaStream_t stream) {
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
int plan_of(int E, int M, int n_rb, int bR, int n_splits, int* out) {
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

// The launches csd_spmm_fwd makes for these arguments, from the host code
// it launches with: five ints each (grid x, y, z, threads, dynamic shared
// memory bytes) written to out (room for 2). Returns the launch count, or
// -1 for an unknown dtype.
extern "C" int csd_spmm_fwd_plan(int E, int M, int n_rb, int bR,
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
