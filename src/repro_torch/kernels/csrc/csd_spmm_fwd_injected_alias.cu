// csd_spmm_fwd_injected_alias — sparselint's deliberately race-broken
// forward block-sparse junction, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/analysis/grid_pass.py:_aliased_fwd_copy
// (its pl.pallas_call runs csd_spmm_fwd's body with the fan-in slot as the
// outermost grid axis, so each output tile is revisited out of order, in
// interpret mode, only under `lint --selftest-inject`): the forward of
// csd_spmm_fwd, y = sum_f x[:, blk(block_idx[rb, f])] @ w[rb, f], with the
// race that sparselint's SL101 exists to catch.
//
// What it computes: the kernel of csd_spmm_fwd.cuh with the fan-in slot as
// a grid axis (blockIdx.z = f, one CTA per slot, n_splits = d_in_b) and no
// partial-sum scratch, no ordered second pass and no atomics: every CTA
// stores its slot's product straight into y with plain stores. CTAs run in
// no order, so each element of y ends as the product of whichever slot
// stored it last (the hardware's own form of the TPU bug, where the tile
// left VMEM between visits and the revisit overwrote the sum). It differs
// from csd_spmm_fwd only in where the split results go.
//
// What bounds it on the card: what bounds csd_spmm_fwd at the same shape
// (the slab's bytes at decode sizes); it is launched only by the lint's
// self-test and by chip_smoke.py, on no serving or training path.
#include "csd_spmm_fwd.cuh"

namespace {

template <typename T, int BM>
int launch(const void* x, const void* w, const int* idx, void* y, int E,
           int M, int n_in, int n_rb, int d_in_b, int bL, int bR,
           cudaStream_t stream) {
  return csd_fwd::launch_splits<T, BM>(x, w, idx, nullptr, y, nullptr,
                                       nullptr, E, M, n_in, n_rb, d_in_b, bL,
                                       bR, d_in_b, 0, stream);
}

template <typename T, int BM>
int plan_of(int E, int M, int n_rb, int bR, int d_in_b, int* out) {
  plan::put(out, 0, csd_fwd::split_dims<T, BM>(E, M, n_rb, bR, d_in_b));
  return 1;
}

}  // namespace

// x (E, M, n_in), w (E, n_rb, d_in_b, bL, bR), idx (n_rb, d_in_b) int32,
// y (E, M, n_rb * bR); no bias, no activation. dtype: 0 float32, 1
// bfloat16. Preconditions as csd_spmm_fwd's (checked by the Python
// wrapper). Returns cudaGetLastError() after the launch.
extern "C" int csd_spmm_fwd_injected_alias(const void* x, const void* w,
                                           const int* idx, void* y, int E,
                                           int M, int n_in, int n_rb,
                                           int d_in_b, int bL, int bR,
                                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool small = M <= 16;
  if (dtype == 0)
    return small ? launch<float, 16>(x, w, idx, y, E, M, n_in, n_rb, d_in_b,
                                     bL, bR, s)
                 : launch<float, 64>(x, w, idx, y, E, M, n_in, n_rb, d_in_b,
                                     bL, bR, s);
  if (dtype == 1)
    return small ? launch<__nv_bfloat16, 16>(x, w, idx, y, E, M, n_in, n_rb,
                                             d_in_b, bL, bR, s)
                 : launch<__nv_bfloat16, 64>(x, w, idx, y, E, M, n_in, n_rb,
                                             d_in_b, bL, bR, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The launch csd_spmm_fwd_injected_alias makes for these arguments: six
// ints (grid x, y, z, threads, dynamic shared memory bytes, cluster)
// written to out. Returns the launch count (1), or -1 for an unknown
// dtype.
extern "C" int csd_spmm_fwd_injected_alias_plan(int E, int M, int n_rb,
                                                int bR, int d_in_b,
                                                int dtype, int* out) {
  const bool small = M <= 16;
  if (dtype == 0)
    return small ? plan_of<float, 16>(E, M, n_rb, bR, d_in_b, out)
                 : plan_of<float, 64>(E, M, n_rb, bR, d_in_b, out);
  if (dtype == 1)
    return small ? plan_of<__nv_bfloat16, 16>(E, M, n_rb, bR, d_in_b, out)
                 : plan_of<__nv_bfloat16, 64>(E, M, n_rb, bR, d_in_b, out);
  return -1;
}
