// Helpers shared by the port's Hopper kernels: element types, conversions
// to and from f32, and warp reductions (sums, maxima, and a reduce-scatter
// of several steps' partial sums).
//
// Each kernel exports one C function (extern "C", plain pointers, the CUDA
// stream as a pointer) that launches it on the caller's stream and returns
// cudaGetLastError(), so a refused launch is reported to the Python wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// Masked score, as in the TPU kernels: large and negative but finite, so a
// fully masked row gives exp(0) = 1 rather than NaN.
constexpr float kNegInf = -1e30f;

// Element type codes passed from Python.
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);  // round to nearest even, as torch and XLA cast
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// N consecutive floats (1, 2, 4 or 8) as 4-, 8- or 16-byte accesses; the
// address must be aligned to the access (N floats, 16 bytes at 8).
template <int N>
__device__ __forceinline__ void load_floats(float (&x)[N], const float* src) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(src)[q];
      x[4 * q] = v.x, x[4 * q + 1] = v.y, x[4 * q + 2] = v.z, x[4 * q + 3] = v.w;
    }
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    x[0] = v.x, x[1] = v.y;
  } else {
    x[0] = *src;
  }
}

template <int N>
__device__ __forceinline__ void store_floats(float* dst, const float (&x)[N]) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q)
      reinterpret_cast<float4*>(dst)[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2],
                                                      x[4 * q + 3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
  } else {
    *dst = x[0];
  }
}

// Sum over the P lanes `STRIDE` apart that share a value (a butterfly: every
// one of them ends with the sum).
template <int P, int STRIDE>
__device__ __forceinline__ float lanes_sum(float v) {
#pragma unroll
  for (int o = P / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o * STRIDE);
  return v;
}

// Reduce-scatter of P steps' V-wide partial sums over the P lanes that
// share them, `STRIDE` lanes apart (`g`: this lane's index among them). Each
// round a lane keeps the half of its steps that its bit O selects and adds
// its partner's partials for them: P - 1 shuffles of V floats, after which
// part[0] holds step g's sum, in an order fixed by g. The rounds are
// unrolled at compile time so the partials stay in registers. Call with
// O = P / 2.
template <int O, int STRIDE, int P, int V>
__device__ __forceinline__ void reduce_scatter(float (&part)[P][V], int g) {
  if constexpr (O > 0) {
    const bool upper = g & O;
#pragma unroll
    for (int j = 0; j < O; ++j) {
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const float send = upper ? part[j][c] : part[j + O][c];
        const float keep = upper ? part[j + O][c] : part[j][c];
        part[j][c] = keep + __shfl_xor_sync(0xffffffffu, send, O * STRIDE);
      }
    }
    reduce_scatter<O / 2, STRIDE>(part, g);
  }
}

}  // namespace repro
