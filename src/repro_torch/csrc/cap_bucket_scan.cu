// Cap-bucket scan of the what-if power-cap replay, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/run_replay.py::cap_bucket_scan
// (_cap_scan_kernel): k[g, b, c] = #{sorted_p[g, b, :] > caps[g, b, c]},
// i.e. Np - bisect_right(row, cap), over float64 rows sorted ascending and
// front-padded with -inf. float64 in, int32 out, exact.
//
// What bounds it on the card: bytes. The least traffic is each row and
// each distinct cap read once and each count written once. The work is
// bit_length(Np) probes of ~5 operations per (row, cap): at the what-if
// path's shapes (rows of up to 2^14 doubles, thousands of caps per stream)
// that is a few operations per byte moved, well under the ~20 per byte at
// which even the H100's float32 rate (67 TFLOP/s over 3.35 TB/s) would
// take over, so the least time is bytes / 3.35 TB/s.
//
// Design: one thread per (row, cap), running the Pallas kernel's fixed-trip
// bisection (lo converges to the insertion point in bit_length(Np) halvings;
// lanes that are done keep lo == hi), so every thread takes the same number
// of steps and a warp never diverges on the loop. Neighbouring threads take
// neighbouring caps of the same row, so the caps are read and the counts
// written coalesced, and the probes of one warp hit the same row, which at
// these sizes stays in the 50 MB L2. The caps are read through their
// strides: the power-cap evaluator passes one [S, C] cap table expanded
// over each stream's four buckets (stride 0), so it is never materialised.
// Staging a row in shared memory (16384 doubles are 128 KB of the 227 KB a
// block can have) is left for later.
#include "common.cuh"

namespace repro {

__global__ void __launch_bounds__(256)
cap_bucket_scan_kernel(const double* __restrict__ sorted_p,
                       const double* __restrict__ caps,
                       int32_t* __restrict__ out, int64_t rows_per_group,
                       int32_t n, int64_t c, int64_t total,
                       int64_t caps_stride_group, int64_t caps_stride_row,
                       int64_t caps_stride_col, int iters) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t row = idx / c;
  const int64_t col = idx - row * c;
  const int64_t grp = row / rows_per_group;
  const int64_t in_grp = row - grp * rows_per_group;
  const double cap = caps[grp * caps_stride_group + in_grp * caps_stride_row +
                          col * caps_stride_col];
  const double* sp = sorted_p + row * static_cast<int64_t>(n);
  int32_t lo = 0, hi = n;
  for (int it = 0; it < iters; ++it) {
    const bool cont = lo < hi;
    const int32_t mid = min((lo + hi) >> 1, n - 1);
    const bool right = cont && (sp[mid] <= cap);
    lo = right ? mid + 1 : lo;
    hi = (cont && !right) ? mid : hi;
  }
  out[idx] = n - lo;
}

}  // namespace repro

extern "C" int repro_cap_bucket_scan(const void* sorted_p, const void* caps,
                                     void* out, int64_t groups,
                                     int64_t rows_per_group, int64_t n,
                                     int64_t c, int64_t caps_stride_group,
                                     int64_t caps_stride_row,
                                     int64_t caps_stride_col, int iters,
                                     void* stream) {
  constexpr int kThreads = 256;
  const int64_t total = groups * rows_per_group * c;
  if (total <= 0 || n <= 0) return cudaSuccess;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  repro::cap_bucket_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(sorted_p), static_cast<const double*>(caps),
      static_cast<int32_t*>(out), rows_per_group, static_cast<int32_t>(n), c,
      total, caps_stride_group, caps_stride_row, caps_stride_col, iters);
  return cudaGetLastError();
}
