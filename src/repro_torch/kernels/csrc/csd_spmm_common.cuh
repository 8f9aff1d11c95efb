// Device helpers shared by the block-sparse junction kernels
// (csd_spmm_fwd.cu, csd_spmm_fwd_quant.cu, csd_spmm_dx.cu, csd_spmm_dw.cu,
// csd_mask_cotangent.cu, csd_spmm_small.cu, csd_spmm_small_dw.cu): 16-byte
// cp.async copies with zero fill, 4- to 16-byte ones without and the rows
// of segments they copy, vector loads as f32, f32 <-> storage-type
// conversion, the fused activation and its derivative folded into a
// cotangent, and the two forward kernels' epilogue and ordered second pass
// over fan-in splits (for one junction or E expert junctions of one shared
// pattern). load_vec also widens int8 slab rows (the int8 small-block
// forward of csd_spmm_small.cu).
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

// A V-byte (4, 8 or 16) cp.async piece, no zero fill.
template <int V>
__device__ __forceinline__ void cp_async_v(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (V == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(gmem), "n"(V));
}

// The widest cp.async piece that tiles rows of `bytes` bytes (0: none).
__host__ __device__ inline int piece_bytes(int bytes) {
  return bytes % 16 == 0 ? 16 : bytes % 8 == 0 ? 8 : bytes % 4 == 0 ? 4 : 0;
}

// Copies `rows` rows of nseg segments of len elements: segment k of row r
// from src + r srs + src_off(k) to dst + r drs + dst_off(k), in V-byte
// cp.async pieces (V = 4, 8 or 16, dividing every segment's bytes, offset
// and row stride) shared by the CTA's threads, or for V = 0 element by
// element with plain loads and stores. The caller commits and waits.
template <int V, typename T, typename SrcOff, typename DstOff>
__device__ __forceinline__ void copy_segments(T* dst, int drs, const T* src,
                                              size_t srs, int rows, int nseg,
                                              int len, SrcOff src_off,
                                              DstOff dst_off) {
  if constexpr (V == 0) {
    const int per_row = nseg * len;
    for (int q = threadIdx.x; q < rows * per_row; q += blockDim.x) {
      const int r = q / per_row, c = q % per_row;
      const int k = c / len, i = c % len;
      dst[r * drs + dst_off(k) + i] = src[r * srs + src_off(k) + i];
    }
  } else {
    const int pieces = len * static_cast<int>(sizeof(T)) / V;
    const int per_row = nseg * pieces;
    for (int q = threadIdx.x; q < rows * per_row; q += blockDim.x) {
      const int r = q / per_row, c = q % per_row;
      const int k = c / pieces, p = c % pieces;
      cp_async_v<V>(
          reinterpret_cast<unsigned char*>(dst + r * drs + dst_off(k)) +
              p * V,
          reinterpret_cast<const unsigned char*>(src + r * srs +
                                                 src_off(k)) +
              p * V);
    }
  }
}

// copy_segments with the piece size vbytes (piece_bytes) chosen at run
// time.
template <typename T, typename SrcOff, typename DstOff>
__device__ __forceinline__ void copy_segments(int vbytes, T* dst, int drs,
                                              const T* src, size_t srs,
                                              int rows, int nseg, int len,
                                              SrcOff src_off,
                                              DstOff dst_off) {
  if (vbytes == 16)
    copy_segments<16>(dst, drs, src, srs, rows, nseg, len, src_off, dst_off);
  else if (vbytes == 8)
    copy_segments<8>(dst, drs, src, srs, rows, nseg, len, src_off, dst_off);
  else if (vbytes == 4)
    copy_segments<4>(dst, drs, src, srs, rows, nseg, len, src_off, dst_off);
  else
    copy_segments<0>(dst, drs, src, srs, rows, nseg, len, src_off, dst_off);
}

// N (1, 2 or 4) consecutive elements at p, aligned to N elements, as f32:
// `G` through the read-only path (global memory), else an ordinary load
// (shared memory).
template <bool G, int N>
__device__ __forceinline__ void load_vec(const float* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const float4 t = G ? __ldg(reinterpret_cast<const float4*>(p))
                       : *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else if constexpr (N == 2) {
    const float2 t = G ? __ldg(reinterpret_cast<const float2*>(p))
                       : *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
    v[0] = G ? __ldg(p) : *p;
  }
}

template <bool G, int N>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[N]) {
  if constexpr (N == 4) {
    const uint2 t = G ? __ldg(reinterpret_cast<const uint2*>(p))
                      : *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&t.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&t.y));
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  } else if constexpr (N == 2) {
    const unsigned t = G ? __ldg(reinterpret_cast<const unsigned*>(p))
                         : *reinterpret_cast<const unsigned*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t));
    v[0] = a.x;
    v[1] = a.y;
  } else {
    const unsigned short t =
        G ? __ldg(reinterpret_cast<const unsigned short*>(p))
          : *reinterpret_cast<const unsigned short*>(p);
    v[0] = __bfloat162float(__ushort_as_bfloat16(t));
  }
}

// N (1, 2 or 4) consecutive int8 values at p, aligned to N bytes, widened
// exactly to f32 (an int8 slab's rows of 4, 2 or 1 columns: no 16-byte
// alignment assumed).
template <bool G, int N>
__device__ __forceinline__ void load_vec(const int8_t* p, float (&v)[N]) {
  if constexpr (N == 4) {
    const int t = G ? __ldg(reinterpret_cast<const int*>(p))
                    : *reinterpret_cast<const int*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      v[i] = static_cast<float>(static_cast<int8_t>(t >> (8 * i)));
  } else if constexpr (N == 2) {
    const short t = G ? __ldg(reinterpret_cast<const short*>(p))
                      : *reinterpret_cast<const short*>(p);
    v[0] = static_cast<float>(static_cast<int8_t>(t));
    v[1] = static_cast<float>(static_cast<int8_t>(t >> 8));
  } else {
    v[0] = static_cast<float>(G ? __ldg(p) : *p);
  }
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
