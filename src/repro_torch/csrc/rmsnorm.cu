// Row-wise RMSNorm for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel): out = x * rsqrt(mean(x^2) + eps) * w, the mean of
// squares in f32, written back in x's type.
//
// What bounds it on the card: bytes. It does ~4 operations per element it
// reads and writes, far below the H100's ~295 operations per byte, so the
// least time is (rows*D reads + rows*D writes + D weights) / 3.35 TB/s.
// On the serving path the rows are few (4 decode slots, 32 prefill tokens)
// and D = 5120, so one launch moves about 40-660 KB and is bound by launch
// latency more than by either limit.
//
// Design: one block per row, so every row is reduced without any traffic
// between blocks. Threads stride over the row, sum squares in f32, reduce
// with warp shuffles and one shared-memory step, then a second pass over the
// same row (now in L1) writes the result. The TPU kernel pads rows to its
// block; here the grid is exactly the row count, so nothing is padded.
#include "common.cuh"

namespace repro {

template <typename T, int THREADS>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w,
               T* __restrict__ out, int d, float eps) {
  constexpr int kWarps = THREADS / 32;
  __shared__ float partial[kWarps];
  __shared__ float inv_rms;
  const int64_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* orow = out + row * d;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  ss = warp_sum(ss);
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kWarps ? partial[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) inv_rms = rsqrtf(t / static_cast<float>(d) + eps);
  }
  __syncthreads();
  const float r = inv_rms;
  for (int i = threadIdx.x; i < d; i += THREADS) {
    orow[i] = from_f32<T>(to_f32(xr[i]) * r * to_f32(w[i]));
  }
}

template <typename T>
static cudaError_t launch(const void* x, const void* w, void* out, int rows,
                          int d, float eps, cudaStream_t stream) {
  constexpr int kThreads = 256;
  rmsnorm_kernel<T, kThreads><<<rows, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      d, eps);
  return cudaGetLastError();
}

}  // namespace repro

extern "C" int repro_rmsnorm(const void* x, const void* w, void* out, int rows,
                             int d, float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return repro::launch<float>(x, w, out, rows, d, eps, s);
    case repro::kBF16:
      return repro::launch<__nv_bfloat16>(x, w, out, rows, d, eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
