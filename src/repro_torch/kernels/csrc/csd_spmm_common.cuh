// Device helpers shared by the block-sparse junction kernels
// (csd_spmm_fwd.cu, csd_spmm_fwd_quant.cu, csd_spmm_dx.cu, csd_spmm_dw.cu,
// csd_mask_cotangent.cu): 16-byte cp.async copies with zero fill, f32 <->
// storage-type conversion, the fused activation and its derivative folded
// into a cotangent, and the
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
// storage type: relu keeps dy where the saved output is positive; gelu
// multiplies dy by the analytic derivative of the tanh approximation at the
// saved pre-activation, in f32. The gelu arithmetic is that of the plain
// version (kernels/csd_spmm.py:mask_cotangent), one rounded f32 operation
// at a time in its order, with its f32 constants and no fused
// multiply-adds, so the two agree bit for bit where their tanhf does.
template <typename T>
__device__ __forceinline__ void mask_in_place(T* dy, T aux, int act) {
  const float a = to_f32(aux);
  if (act == 1) {
    if (!(a > 0.f)) store(0.f, dy);
  } else if (act == 2) {
    constexpr float kA = static_cast<float>(0.044715);
    constexpr float kC = static_cast<float>(0.7978845608028654);
    constexpr float kB = static_cast<float>(3.0 * 0.044715);
    // t = tanh(C (a + A a a a))
    const float a3 = __fmul_rn(__fmul_rn(__fmul_rn(kA, a), a), a);
    const float t = tanhf(__fmul_rn(kC, __fadd_rn(a, a3)));
    // d = 0.5 (1 + t) + 0.5 a (1 - t t) C (1 + 3 A a a)
    const float lhs = __fmul_rn(0.5f, __fadd_rn(1.f, t));
    float rhs = __fmul_rn(__fmul_rn(0.5f, a),
                          __fsub_rn(1.f, __fmul_rn(t, t)));
    rhs = __fmul_rn(rhs, kC);
    rhs = __fmul_rn(rhs, __fadd_rn(1.f, __fmul_rn(__fmul_rn(kB, a), a)));
    store(__fmul_rn(to_f32(*dy), __fadd_rn(lhs, rhs)), dy);
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
