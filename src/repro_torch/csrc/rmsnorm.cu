// Row-wise RMSNorm for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm
// (_rmsnorm_kernel): out = x * rsqrt(mean(x^2) + eps) * w, the mean of
// squares in f32, written back in x's type.
//
// What bounds it on the card: bytes, on paper. It does ~4 operations per
// element it reads and writes, far below the H100's ~295 operations per
// byte, so the least time is (rows*D reads + rows*D writes + D weights) /
// 3.35 TB/s: 0.03 us for the decode step's 4 rows of 5120. No launch gets
// near that: on the serving path one call is a launch, a memory round trip
// and a reduction, so latency sets its time.
//
// Design: one memory round trip. Each thread starts all its loads of x and
// w (16-byte vectors: 8 bf16 or 4 f32) before it uses any, keeps them in
// registers (VPT vectors a thread, a template parameter), reduces the sum
// of squares in f32 (warp shuffles; across warps one shared-memory step),
// and writes the row from registers: nothing is read twice. The launch
// shape follows the row (the wrapper's launch_plan): a row of up to 256
// vectors goes to one warp, several rows to a block, with no block-level
// synchronisation at all (hymba-1.5b's D = 1600 is 200 vectors); a longer
// row gets a block of up to 512 threads (llama-13b's 5120 is 640 vectors,
// 160 threads of 4). A D that is not a multiple of the vector, or a
// pointer that is not 16-byte aligned, takes the same kernel with one
// element a load. Vectors past VPT a thread (rows over 4,096 vectors) are
// read again after the reduction, so any D works.
//
// A launch with programmatic dependent launch (PDL), which would overlap
// this launch with the end of the kernel before it, was measured on the
// H100 and did not lower the time K1 adds after the decode step's GEMMs
// (PERF.md), so K1 is launched plainly.
//
// Order of operations as the plain version: (x * rsqrt(mean + eps)) * w in
// f32, rounded once to the output type.
#include <type_traits>

#include "common.cuh"

namespace repro {

// Loads and stores of one vector: 16 bytes, or one element.
template <typename T, bool VECTOR>
struct NormIo {
  static constexpr int N = 1;
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p, int64_t i) { return p[i]; }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[N]) { f[0] = to_f32(r); }
  static __device__ __forceinline__ void store(T* p, int64_t i, const float (&f)[N]) {
    p[i] = from_f32<T>(f[0]);
  }
};

template <typename T>
struct NormIo<T, true> {
  static constexpr int N = 16 / sizeof(T);
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const T* p, int64_t i) {
    return reinterpret_cast<const uint4*>(p)[i];
  }
  static __device__ __forceinline__ void unpack(const Raw& r, float (&f)[N]) {
    const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (std::is_same<T, float>::value) {
        f[q] = __uint_as_float(u[q]);
      } else {                  // bf16 pairs, the lower address in the low half
        f[2 * q] = __uint_as_float(u[q] << 16);
        f[2 * q + 1] = __uint_as_float(u[q] & 0xffff0000u);
      }
    }
  }
  static __device__ __forceinline__ void store(T* p, int64_t i, const float (&f)[N]) {
    uint32_t u[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (std::is_same<T, float>::value) {
        u[q] = __float_as_uint(f[q]);
      } else {
        u[q] = static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * q]))) |
               (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f[2 * q + 1])))
                << 16);
      }
    }
    reinterpret_cast<uint4*>(p)[i] = make_uint4(u[0], u[1], u[2], u[3]);
  }
};

constexpr int kWarpRowThreads = 256;    // 8 rows a block when a warp takes a row
constexpr int kBlockRowThreads = 512;

// WARP_ROWS: a warp per row, blockDim.x / 32 rows a block; else a block per
// row. VPT vectors a thread are held in registers.
template <typename T, bool VECTOR, int VPT, bool WARP_ROWS>
__global__ void __launch_bounds__(WARP_ROWS ? kWarpRowThreads : kBlockRowThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out,
               int64_t rows, int d, float eps) {
  using Io = NormIo<T, VECTOR>;
  constexpr int N = Io::N;
  __shared__ float partial[32];
  const int nv = d / N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row = WARP_ROWS ? static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + warp
                                : static_cast<int64_t>(blockIdx.x);
  const int t = WARP_ROWS ? lane : threadIdx.x;
  const int nt = WARP_ROWS ? 32 : blockDim.x;
  if (WARP_ROWS && row >= rows) return;
  const T* xr = x + row * d;
  T* orow = out + row * d;

  typename Io::Raw xv[VPT], wv[VPT];
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = t + j * nt;
    if (i < nv) {
      wv[j] = Io::load(w, i);
      xv[j] = Io::load(xr, i);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    if (t + j * nt < nv) {
      float f[N];
      Io::unpack(xv[j], f);
#pragma unroll
      for (int q = 0; q < N; ++q) ss += f[q] * f[q];
    }
  }
  for (int i = t + VPT * nt; i < nv; i += nt) {     // past the registers
    float f[N];
    Io::unpack(Io::load(xr, i), f);
#pragma unroll
    for (int q = 0; q < N; ++q) ss += f[q] * f[q];
  }
  ss = warp_sum(ss);
  if (!WARP_ROWS) {
    if (lane == 0) partial[warp] = ss;
    __syncthreads();
    ss = warp_sum(lane < (nt >> 5) ? partial[lane] : 0.f);
  }
  const float r = rsqrtf(ss / static_cast<float>(d) + eps);

#pragma unroll
  for (int j = 0; j < VPT; ++j) {
    const int i = t + j * nt;
    if (i < nv) {
      float f[N], g[N];
      Io::unpack(xv[j], f);
      Io::unpack(wv[j], g);
#pragma unroll
      for (int q = 0; q < N; ++q) f[q] = f[q] * r * g[q];
      Io::store(orow, i, f);
    }
  }
  for (int i = t + VPT * nt; i < nv; i += nt) {
    float f[N], g[N];
    Io::unpack(Io::load(xr, i), f);
    Io::unpack(Io::load(w, i), g);
#pragma unroll
    for (int q = 0; q < N; ++q) f[q] = f[q] * r * g[q];
    Io::store(orow, i, f);
  }
}

__global__ void empty_kernel(int) {}

template <typename T, bool VECTOR, bool WARP_ROWS>
static cudaError_t launch(const void* x, const void* w, void* out, int rows, int d,
                         float eps, int vpt, int threads, cudaStream_t stream) {
  const int64_t blocks = WARP_ROWS ? (rows + (threads >> 5) - 1) / (threads >> 5) : rows;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  const int64_t r = rows;
  switch (vpt) {
#define REPRO_K1(V)                                                                 \
  case V:                                                                           \
    rmsnorm_kernel<T, VECTOR, V, WARP_ROWS>                                         \
        <<<static_cast<unsigned>(blocks), threads, 0, stream>>>(xp, wp, op, r, d, eps); \
    return cudaGetLastError();
    REPRO_K1(1)
    REPRO_K1(2)
    REPRO_K1(4)
    REPRO_K1(8)
#undef REPRO_K1
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
static cudaError_t dispatch(const void* x, const void* w, void* out, int rows, int d,
                           float eps, int width, int vpt, int threads, int warp_rows,
                           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vector = width == kVec;
  if (!vector && width != 1) return cudaErrorInvalidValue;
  if (vector && (d % kVec || (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                              reinterpret_cast<uintptr_t>(out)) % 16))
    return cudaErrorMisalignedAddress;
  if (threads < 32 || threads % 32 ||
      threads > (warp_rows ? kWarpRowThreads : kBlockRowThreads))
    return cudaErrorInvalidValue;
  if (vector) {
    return warp_rows ? launch<T, true, true>(x, w, out, rows, d, eps, vpt, threads, stream)
                     : launch<T, true, false>(x, w, out, rows, d, eps, vpt, threads, stream);
  }
  return warp_rows ? launch<T, false, true>(x, w, out, rows, d, eps, vpt, threads, stream)
                   : launch<T, false, false>(x, w, out, rows, d, eps, vpt, threads, stream);
}

}  // namespace repro

// The launch plan (elements a load, vectors a thread, threads a block, a
// warp or a block per row) comes from the Python wrapper's
// launch_plan; a plan the kernel cannot take is refused.
extern "C" int repro_rmsnorm(const void* x, const void* w, void* out, int rows,
                             int d, float eps, int dtype, int width, int vpt,
                             int threads, int warp_rows, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32:
      return repro::dispatch<float>(x, w, out, rows, d, eps, width, vpt, threads, warp_rows, s);
    case repro::kBF16:
      return repro::dispatch<__nv_bfloat16>(x, w, out, rows, d, eps, width, vpt, threads,
                                            warp_rows, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// An empty kernel, one warp, launched as K1 is: the launch floor that K1's
// times are read against.
extern "C" int repro_empty_kernel(void* stream) {
  repro::empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(0);
  return cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
