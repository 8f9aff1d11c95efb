// csd_mask_cotangent — the fused activation's derivative folded into the
// junction's cotangent, once per backward, for Hopper (sm_90a).
//
// g = mask(dy) elementwise from the forward's saved aux: relu keeps dy where
// the saved output y is positive; gelu multiplies dy by the analytic
// derivative of the tanh approximation at the saved pre-activation z, in
// f32, rounded to the dtype of dy (csd::mask_in_place). Its plain version is
// kernels/csd_spmm.py:mask_cotangent. The TPU kernels csd_spmm_dx and
// csd_spmm_dw (repro/kernels/csd_spmm.py) fold the same mask into each dy
// tile they load; here the backward computes g once and hands it to both
// products (csd_spmm_dx.cu, csd_spmm_dw.cu), which read it as they read an
// unmasked dy.
//
// What bounds it on the card: bytes. One read of dy and aux and one write
// of g, 3 x E x M x n_out elements: 252 MB at gemma3-4b's gate junction in
// bf16 (M 4096, n_out 10240), ~75 us at 3.35 TB/s; ~30 flops per element
// for gelu are far below the ridge point.
//
// What the design does about it: one thread per 16-byte chunk (8 bf16 or 4
// f32 elements), each loading one chunk of dy and one of aux and storing
// one of g, so every access is a full 16-byte vector and consecutive
// threads touch consecutive chunks. The mask is elementwise over the flat
// tensor, so the row width does not matter: where the element count is not
// a multiple of the chunk (the paper MLP's widths of 39, 100 and 390 at an
// odd row count), the last elements go one to a thread after the chunks.
#include "csd_spmm_common.cuh"

namespace {

constexpr int kThreads = 256;

// Thread c < n_chunks masks chunk c; thread n_chunks + t masks the tail's
// element t (t < tail, tail < N).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    csd_mask_cotangent_kernel(const T* __restrict__ dy,
                              const T* __restrict__ aux, T* __restrict__ g,
                              size_t n_chunks, size_t tail, int act) {
  constexpr int N = 16 / sizeof(T);
  const size_t c = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
  if (c >= n_chunks) {
    if (c >= n_chunks + tail) return;
    const size_t i = n_chunks * N + (c - n_chunks);
    T v = dy[i];
    csd::mask_in_place(&v, aux[i], act);
    g[i] = v;
    return;
  }
  uint4 dv = reinterpret_cast<const uint4*>(dy)[c];
  const uint4 av = reinterpret_cast<const uint4*>(aux)[c];
  T* de = reinterpret_cast<T*>(&dv);
  const T* ae = reinterpret_cast<const T*>(&av);
#pragma unroll
  for (int i = 0; i < N; ++i) csd::mask_in_place(de + i, ae[i], act);
  reinterpret_cast<uint4*>(g)[c] = dv;
}

// (whole 16-byte chunks, elements after them) of rows x n_out elements
struct Split {
  size_t chunks, tail;
};

Split split(int rows, int n_out, int dtype) {
  const size_t total = static_cast<size_t>(rows) * n_out;
  const size_t n = dtype == 0 ? 4 : 8;
  return {total / n, total % n};
}

plan::Dims mask_dims(Split sp) {
  const size_t threads = sp.chunks + sp.tail;
  return {dim3(static_cast<unsigned>((threads + kThreads - 1) / kThreads)),
          kThreads, 0};
}

}  // namespace

// g = mask(dy) over rows x n_out elements: dy, aux and g of one dtype (0
// float32, 1 bfloat16); act 1 relu (aux = y), 2 gelu (aux = z).
// Preconditions (checked by the Python wrapper): contiguous tensors on one
// device, 16-byte aligned, fewer than 2^31 CTAs.
// Returns cudaGetLastError() after the launch.
extern "C" int csd_mask_cotangent(const void* dy, const void* aux, void* g,
                                  int rows, int n_out, int dtype, int act,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (act != 1 && act != 2) return static_cast<int>(cudaErrorInvalidValue);
  const Split sp = split(rows, n_out, dtype);
  const plan::Dims d = mask_dims(sp);
  if (dtype == 0) {
    csd_mask_cotangent_kernel<float><<<d.grid, d.threads, 0, s>>>(
        static_cast<const float*>(dy), static_cast<const float*>(aux),
        static_cast<float*>(g), sp.chunks, sp.tail, act);
  } else if (dtype == 1) {
    csd_mask_cotangent_kernel<__nv_bfloat16><<<d.grid, d.threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(dy),
        static_cast<const __nv_bfloat16*>(aux),
        static_cast<__nv_bfloat16*>(g), sp.chunks, sp.tail, act);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch csd_mask_cotangent makes for these arguments, from the host code
// it launches with: six ints (grid x, y, z, threads, dynamic shared memory
// bytes, cluster) written to out. Returns the launch count (1), or -1 for an
// unknown dtype.
extern "C" int csd_mask_cotangent_plan(int rows, int n_out, int dtype,
                                       int* out) {
  if (dtype != 0 && dtype != 1) return -1;
  plan::put(out, 0, mask_dims(split(rows, n_out, dtype)));
  return 1;
}
