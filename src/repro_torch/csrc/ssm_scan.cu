// Mamba selective scan for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py::ssm_scan
// (_ssm_kernel): per batch row and inner channel i, with an f32 state h of
// N entries,
//     h_t = exp(dt_t * a_i) * h_{t-1} + dt_t * B_t * u_t,   y_t = C_t . h_t,
// y without the D-skip term (the caller adds u * D), and the final state.
// The state starts from h0 when one is given, else from zeros.
//
// What bounds it on the card: bytes. Per (row, step, channel) it reads u
// and dt (8 bytes) and writes y (4 bytes) for ~5 N operations, and it reads
// and writes the (B, I, N) f32 state once. At hymba-1.5b's decode step (B = 4,
// S = 1, I = 3200, N = 16) that is 1.6 MB of state in and out plus 0.15 MB
// of u, dt and y: ~0.5 us at 3.35 TB/s, so launch latency sets its time. At
// a prefill the steps form a dependency chain per channel.
//
// Design: the TPU kernel evaluates each chunk in a closed form with (C, C)
// pair terms in log space, to feed the TPU's matrix unit. Here the
// sequential recurrence is exact (it is the oracle's own form) and cheap:
// one thread per (batch row, channel i) holds a[i, :] and h[:] in registers
// (N = 8 or 16, a template parameter) and walks t in order, N independent
// FMA chains per step. A block of 128 channels of one row stages B_t and C_t
// for a tile of 32 steps in shared memory, since every channel of a row
// reads them; u, dt and y are read and written coalesced along i. At the
// decode step this is 12,800 threads, a tenth of the card's resident
// threads: occupancy is low and left for later work.
//
// The final state may be written over the initial one (h_out == h0): each
// thread reads its own N entries before it writes them.
#include "common.cuh"

namespace repro {

struct SsmParams {
  const float* u;
  const float* dt;
  const float* a;
  const float* b;
  const float* c;
  const float* h0;  // may be null: start from zeros
  float* y;         // (B, S, I) contiguous
  float* h_out;     // (B, I, N) contiguous
  int64_t us[3], dts[3], bs[3], cs[3];  // strides of (batch, seq, last axis)
  int64_t as[2];                        // strides of a (channel, state)
  int s, di;
};

constexpr int kSsmThreads = 128;
constexpr int kSsmSteps = 32;

template <int N>
__global__ void __launch_bounds__(kSsmThreads)
ssm_scan_kernel(const SsmParams p) {
  __shared__ float s_b[kSsmSteps][N];
  __shared__ float s_c[kSsmSteps][N];
  const int64_t row = blockIdx.y;
  const int i = blockIdx.x * kSsmThreads + threadIdx.x;
  const bool live = i < p.di;
  const int64_t hoff = (row * p.di + i) * N;

  float a[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    a[n] = live ? p.a[i * p.as[0] + n * p.as[1]] : 0.f;
    h[n] = (live && p.h0 != nullptr) ? p.h0[hoff + n] : 0.f;
  }
  const float* u = p.u + row * p.us[0] + static_cast<int64_t>(i) * p.us[2];
  const float* dt = p.dt + row * p.dts[0] + static_cast<int64_t>(i) * p.dts[2];
  const float* bm = p.b + row * p.bs[0];
  const float* cm = p.c + row * p.cs[0];
  float* y = p.y + row * p.s * p.di + i;

  for (int t0 = 0; t0 < p.s; t0 += kSsmSteps) {
    const int steps = min(kSsmSteps, p.s - t0);
    __syncthreads();  // the previous tile is no longer read
    for (int idx = threadIdx.x; idx < steps * N; idx += kSsmThreads) {
      const int t = idx / N, n = idx % N;
      s_b[t][n] = bm[(t0 + t) * p.bs[1] + n * p.bs[2]];
      s_c[t][n] = cm[(t0 + t) * p.cs[1] + n * p.cs[2]];
    }
    __syncthreads();
    if (!live) continue;
    for (int t = 0; t < steps; ++t) {
      const int64_t tt = t0 + t;
      const float dtv = dt[tt * p.dts[1]];
      const float uv = u[tt * p.us[1]];
      float yv = 0.f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        h[n] = expf(dtv * a[n]) * h[n] + dtv * s_b[t][n] * uv;
        yv = fmaf(h[n], s_c[t][n], yv);
      }
      y[tt * p.di] = yv;
    }
  }
  if (live) {
#pragma unroll
    for (int n = 0; n < N; ++n) p.h_out[hoff + n] = h[n];
  }
}

template <int N>
static cudaError_t launch(const SsmParams& p, int bsz, cudaStream_t stream) {
  const dim3 grid((p.di + kSsmThreads - 1) / kSsmThreads, bsz);
  ssm_scan_kernel<N><<<grid, kSsmThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace repro

// strides: 14 int64 values in elements: (batch, seq, channel) of u and dt,
// (batch, seq, state) of b and c, then (channel, state) of a. All inputs are
// float32; h0 may be null.
extern "C" int repro_ssm_scan(const void* u, const void* dt, const void* a,
                              const void* b, const void* c, const void* h0,
                              void* y, void* h_out, const int64_t* strides,
                              int bsz, int s, int di, int n, void* stream) {
  repro::SsmParams p;
  p.u = static_cast<const float*>(u);
  p.dt = static_cast<const float*>(dt);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.c = static_cast<const float*>(c);
  p.h0 = static_cast<const float*>(h0);
  p.y = static_cast<float*>(y);
  p.h_out = static_cast<float*>(h_out);
  for (int i = 0; i < 3; ++i) {
    p.us[i] = strides[i];
    p.dts[i] = strides[3 + i];
    p.bs[i] = strides[6 + i];
    p.cs[i] = strides[9 + i];
  }
  p.as[0] = strides[12];
  p.as[1] = strides[13];
  p.s = s;
  p.di = di;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8: return repro::launch<8>(p, bsz, st);
    case 16: return repro::launch<16>(p, bsz, st);
    default: return cudaErrorInvalidValue;
  }
}
