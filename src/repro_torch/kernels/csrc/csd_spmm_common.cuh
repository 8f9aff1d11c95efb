// Device helpers shared by the block-sparse junction kernels
// (csd_spmm_fwd.cu, csd_spmm_fwd_quant.cu, csd_spmm_dx.cu, csd_spmm_dw.cu):
// 16-byte cp.async copies with zero fill, f32 <-> storage-type conversion,
// the fused activation and its derivative folded into a cotangent, and the
// two forward kernels' epilogue and ordered second pass over fan-in splits
// (for one junction or E expert junctions of one shared pattern).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "plan.cuh"

namespace csd {

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;  // 0 bytes read: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* out) { *out = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16(v);
}

constexpr float kGeluC = 0.7978845608028654f;  // sqrt(2 / pi)
constexpr float kGeluA = 0.044715f;

// act: 0 none, 1 relu, 2 tanh-approximate gelu (jax.nn.gelu approximate)
__device__ __forceinline__ float activate(float z, int act) {
  if (act == 1) return fmaxf(z, 0.f);
  if (act == 2) {
    float t = tanhf(kGeluC * (z + kGeluA * z * z * z));
    return z * (0.5f * (1.f + t));
  }
  return z;
}

// The cotangent with the activation's derivative folded in, rounded to the
// storage type as the JAX package's mask_cotangent rounds it: relu keeps dy
// where the saved output is positive; gelu multiplies dy by the analytic
// derivative of the tanh approximation at the saved pre-activation, in f32.
template <typename T>
__device__ __forceinline__ void mask_in_place(T* dy, T aux, int act) {
  const float a = to_f32(aux);
  if (act == 1) {
    if (!(a > 0.f)) store(0.f, dy);
  } else if (act == 2) {
    const float t = tanhf(kGeluC * (a + kGeluA * a * a * a));
    const float g = 0.5f * (1.f + t) +
                    0.5f * a * (1.f - t * t) * kGeluC *
                        (1.f + 3.f * kGeluA * a * a);
    store(to_f32(*dy) * g, dy);
  }
}

// Masks a ROWS x COLS tile of dy in shared memory, in place, from the aux
// tile of the same layout (row stride LD elements, rows 16-byte aligned).
// Each of the NT threads takes whole 16-byte chunks: one load of dy and one
// of aux feed 8 (bf16) or 4 (f32) independent evaluations, which keeps the
// pass from waiting on one shared-memory round trip per element.
template <typename T, int ROWS, int COLS, int LD, int NT>
__device__ __forceinline__ void mask_tile(T* dy, const T* aux, int act,
                                          int tid) {
  constexpr int N = 16 / sizeof(T);
  constexpr int CPR = COLS / N;  // chunks per row
  static_assert(COLS % N == 0 && (LD * sizeof(T)) % 16 == 0, "16-byte rows");
#pragma unroll 2
  for (int c = tid; c < ROWS * CPR; c += NT) {
    const int r = c / CPR;
    const int off = r * LD + (c - r * CPR) * N;
    uint4 dv = *reinterpret_cast<const uint4*>(dy + off);
    const uint4 av = *reinterpret_cast<const uint4*>(aux + off);
    T* de = reinterpret_cast<T*>(&dv);
    const T* ae = reinterpret_cast<const T*>(&av);
#pragma unroll
    for (int i = 0; i < N; ++i) mask_in_place(de + i, ae[i], act);
    *reinterpret_cast<uint4*>(dy + off) = dv;
  }
}

// Writes the tile's element (m, n) of the junction output: the finished
// value (and the pre-activation when zout is given) when there is one
// split, else the split's raw f32 partial sum. In the expert-batched form
// m is the row across all experts (e * M_e + row) and M the rows of all
// experts, so y, zout and the partial sums are (E * M_e, n_out); bias
// points at the expert's own row.
template <typename T>
__device__ __forceinline__ void emit(float z, int m, int n, int M, int n_out,
                                     const T* bias, T* y, T* zout,
                                     float* partial, int act) {
  if (partial != nullptr) {
    partial[(static_cast<size_t>(blockIdx.z) * M + m) * n_out + n] = z;
    return;
  }
  if (bias != nullptr) z += to_f32(bias[n]);
  const size_t e = static_cast<size_t>(m) * n_out + n;
  if (zout != nullptr) store(z, zout + e);
  store(activate(z, act), y + e);
}

// Second pass of a split junction over E experts of M_e rows each: z =
// sum_s partial[s] + bias[expert], the splits added in order; y = act(z),
// and z itself when zout is given. bias is (E, n_out) (E = 1: one row).
template <typename T>
__global__ void __launch_bounds__(256)
    reduce_splits_kernel(const float* __restrict__ partial,
                         const T* __restrict__ bias, T* __restrict__ y,
                         T* __restrict__ zout, int E, int M_e, int n_out,
                         int n_splits, int act) {
  const size_t per_expert = static_cast<size_t>(M_e) * n_out;
  const size_t total = per_expert * E;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float z = 0.f;
    for (int s = 0; s < n_splits; ++s) z += partial[s * total + e];
    if (bias != nullptr)
      z += to_f32(bias[(e / per_expert) * n_out + e % n_out]);
    if (zout != nullptr) store(z, zout + e);
    store(activate(z, act), y + e);
  }
}

// The second pass's launch over `total` output elements: one thread each.
inline plan::Dims reduce_dims(size_t total) {
  return {dim3(static_cast<unsigned>((total + 255) / 256)), 256, 0};
}

}  // namespace csd
