// RWKV-6 WKV recurrence for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py::wkv6
// (_wkv_kernel): per batch row and head, with a (K, V) f32 state S,
//     y_t = r_t . (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T,
// where w_t in (0, 1) is the data-dependent decay and u the bonus. It
// returns y and the final state; the state starts from state0 when one is
// given, else from zeros.
//
// What bounds it on the card: bytes. Per (row, head, step) it reads r, k, v
// and w (4 K floats) and writes y (K floats) for ~5 K^2 operations; the
// state is read and written once. At rwkv6-3b's decode step (B = 4, H = 40,
// S = 1, K = 64) that is 2.6 MB of state in and 2.6 MB out: ~1.6 us at
// 3.35 TB/s, so launch latency sets its time. At a prefill the steps form a
// dependency chain per head.
//
// Design: the TPU kernel evaluates each chunk in a closed form over a
// (C, C, K) log-space decay tensor, to feed the TPU's matrix unit. Here the
// sequential recurrence is exact (it is the oracle's own form) and needs no
// log space: it only multiplies by w in (0, 1), so decays of 1e-4 and 0.999
// stay finite. One block per (batch row, head), one thread per value
// channel j (K = 16, 32 or 64, a template parameter): thread j keeps column
// S[:, j] in registers. The block stages r_t, k_t and w_t for a tile of 32
// steps, and u once, in shared memory (every thread reads all K of them,
// as broadcasts); thread j reads v_t[j] itself. Per step it forms
//     y_j = sum_k r_k (S[k, j] + u_k k_k v_j),   S[k, j] = w_k S[k, j] + k_k v_j,
// in the oracle's order. Inputs are read through their (batch, head, seq)
// strides, so the model's (B, S, H, K) projections need no transpose copy.
//
// The final state may be written over the initial one (state_out ==
// state0): each thread reads its own column before it writes it.
#include "common.cuh"

namespace repro {

struct WkvParams {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;       // (H, K) contiguous
  const float* state0;  // (B, H, K, K) contiguous, may be null: zeros
  float* y;
  float* state_out;     // (B, H, K, K) contiguous
  int64_t rs[3], ks[3], vs[3], ws[3], ys[3];  // strides of (batch, head, seq)
  int h, s;
};

constexpr int kWkvSteps = 32;

template <int K>
__global__ void __launch_bounds__(K)
wkv6_kernel(const WkvParams p) {
  __shared__ float s_r[kWkvSteps][K];
  __shared__ float s_k[kWkvSteps][K];
  __shared__ float s_w[kWkvSteps][K];
  __shared__ float s_u[K];
  const int j = threadIdx.x;
  const int head = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int64_t soff = (b * p.h + head) * K * K;

  float st[K];
#pragma unroll
  for (int kk = 0; kk < K; ++kk) {
    st[kk] = p.state0 != nullptr ? p.state0[soff + kk * K + j] : 0.f;
  }
  s_u[j] = p.u[head * K + j];
  const float* r = p.r + b * p.rs[0] + head * p.rs[1];
  const float* k = p.k + b * p.ks[0] + head * p.ks[1];
  const float* v = p.v + b * p.vs[0] + head * p.vs[1];
  const float* w = p.w + b * p.ws[0] + head * p.ws[1];
  float* y = p.y + b * p.ys[0] + head * p.ys[1];

  for (int t0 = 0; t0 < p.s; t0 += kWkvSteps) {
    const int steps = min(kWkvSteps, p.s - t0);
    __syncthreads();  // the previous tile is no longer read (and s_u is set)
    for (int idx = j; idx < steps * K; idx += K) {
      const int t = idx / K, c = idx % K;
      const int64_t tt = t0 + t;
      s_r[t][c] = r[tt * p.rs[2] + c];
      s_k[t][c] = k[tt * p.ks[2] + c];
      s_w[t][c] = w[tt * p.ws[2] + c];
    }
    __syncthreads();
    for (int t = 0; t < steps; ++t) {
      const int64_t tt = t0 + t;
      const float vj = v[tt * p.vs[2] + j];
      float yj = 0.f;
#pragma unroll
      for (int kk = 0; kk < K; ++kk) {
        const float kv = s_k[t][kk] * vj;
        yj = fmaf(s_r[t][kk], st[kk] + s_u[kk] * kv, yj);
        st[kk] = s_w[t][kk] * st[kk] + kv;
      }
      y[tt * p.ys[2] + j] = yj;
    }
  }
#pragma unroll
  for (int kk = 0; kk < K; ++kk) p.state_out[soff + kk * K + j] = st[kk];
}

template <int K>
static cudaError_t launch(const WkvParams& p, int bsz, cudaStream_t stream) {
  const dim3 grid(p.h, bsz);
  wkv6_kernel<K><<<grid, K, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace repro

// strides: 15 int64 values in elements, the (batch, head, seq) strides of r,
// k, v, w and y; the last axis of each is contiguous. All tensors are
// float32; state0 may be null.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* state0,
                          void* y, void* state_out, const int64_t* strides,
                          int bsz, int h, int s, int kd, void* stream) {
  repro::WkvParams p;
  p.r = static_cast<const float*>(r);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.state0 = static_cast<const float*>(state0);
  p.y = static_cast<float*>(y);
  p.state_out = static_cast<float*>(state_out);
  for (int i = 0; i < 3; ++i) {
    p.rs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.ws[i] = strides[9 + i];
    p.ys[i] = strides[12 + i];
  }
  p.h = h;
  p.s = s;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kd) {
    case 16: return repro::launch<16>(p, bsz, st);
    case 32: return repro::launch<32>(p, bsz, st);
    case 64: return repro::launch<64>(p, bsz, st);
    default: return cudaErrorInvalidValue;
  }
}
