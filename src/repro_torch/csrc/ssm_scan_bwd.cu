// The Mamba selective scan's backward for Hopper.
//
// Replaces no TPU kernel: the JAX package takes this gradient by XLA's
// autodiff of its lax.scan (src/repro/models/hymba.py:113 under
// chunked_scan, held here to jax.grad of
// src/repro/kernels/ref.py::ssm_scan_reference). It computes, per batch
// row and inner channel i with f32 state h of N entries, dA_t = exp(dt_t a)
// and g_t the total gradient of h_t (g_{S-1} = dh_out + c_{S-1} dy_{S-1},
// g_{t-1} = dA_t g_t + c_{t-1} dy_{t-1}):
//     dc_t[n] = sum_i dy_t[i] h_t[i,n],    db_t[n] = sum_i g_t[i,n] dt_t[i] u_t[i],
//     du_t[i] = dt_t[i] sum_n g_t[i,n] b_t[n],
//     ddt_t[i] = sum_n g_t[i,n] (a[i,n] dA_t[i,n] h_{t-1}[i,n] + b_t[n] u_t[i]),
//     da = sum_{rows,t} g_t dt_t dA_t h_{t-1},    dh0 = dA_0 g_0,
// the plain version's formulas (kernels/ref.py::ssm_scan_backward_reference).
//
// What bounds it on the card: operations and bytes about equally. Per
// (row, step, channel) it reads u, dt and dy and writes du and ddt (20
// bytes); per (row, step, channel, state entry) it does ~26 operations (6
// to recompute the state, 20 in the reverse step). At hymba-1.5b's
// training shape (B = 2, S = 2,048, I = 3,200, N = 16) that is 262 MB
// (78 us at 3.35 TB/s) and 5.45 GFLOP (81 us at the f32 rate of 67
// TFLOP/s).
//
// Design: a simple kernel that is right. The reverse walk needs h_{t-1} at
// every step, and h cannot be run backwards (dividing by dA, which is 0
// for a large dt, is not allowed). So the states are kept at chunk
// boundaries, as the reference's chunked_scan keeps its carry: a first
// pass walks the scan forward and stores the state entering every chunk of
// kChunk = 16 steps in a scratch of B * ceil(S / 16) * I * N floats that the
// wrapper allocates (52 MB at the shape above, against 839 MB for every
// step's state); the reverse pass, chunk by chunk from the last, recomputes
// the chunk's 16 states and dA's from its boundary into registers and walks
// them backwards. A thread owns one state entry of one (row, channel), so N
// lanes hold a channel and a block of 256 threads 256 / N channels; u, dt,
// dy, B and C of a chunk are staged in shared memory. The sums over the N
// entries (du, ddt) are reduce-scattered over the channel's lanes once for
// N steps (N - 1 shuffles of two values); the sums over channels (db, dc)
// are taken within a warp by shuffles, then over the block's warps in
// shared memory, and written as one partial per block and step, which the
// wrapper sums over the blocks; da is one partial per batch row, summed by
// the wrapper. Every sum is in a fixed order, with no atomics: two calls
// give the same bits. Not yet fast: each step's arithmetic is issued twice
// (boundary pass, chunk recompute) plus the reverse, from one thread per
// state entry.
#include "common.cuh"

namespace repro {

struct SsmBwdParams {
  const float* u;
  const float* dt;
  const float* a;
  const float* b;
  const float* c;
  const float* h0;      // (B, I, N) contiguous, may be null: zeros
  const float* dy;      // (B, S, I) contiguous
  const float* dh_out;  // (B, I, N) contiguous, may be null: zeros
  float* du;            // (B, S, I) contiguous
  float* ddt;           // (B, S, I) contiguous
  float* da_part;       // (B, I, N): each batch row's share of da
  float* bc_part;       // (2, B, blocks, S, N): each block's share of db, then dc
  float* dh0;           // (B, I, N) contiguous, may be null: not wanted
  float* scratch;       // (B, chunks, I, N): the state entering each chunk
  int64_t us[3], dts[3], bs[3], cs[3];  // strides of (batch, seq, last axis)
  int64_t as[2];                        // strides of a (channel, state)
  int bsz, s, di;
};

constexpr int kSsmBwdThreads = 256;  // a block (ssm_scan.BWD_BLOCK_THREADS)
constexpr int kChunk = 16;           // steps between stored states (ssm_scan.BWD_CHUNK)

template <int N>
__global__ void __launch_bounds__(kSsmBwdThreads)
ssm_scan_bwd_kernel(const SsmBwdParams p) {
  constexpr int CH = kSsmBwdThreads / N;   // channels a block
  constexpr int CPW = 32 / N;              // channels a warp
  constexpr int WARPS = kSsmBwdThreads / 32;
  static_assert(kChunk % N == 0, "whole batches of N steps a chunk");
  __shared__ float s_u[kChunk][CH], s_dt[kChunk][CH], s_dy[kChunk][CH];
  __shared__ float s_b[kChunk][N], s_c[kChunk][N];
  __shared__ float s_red[kChunk][WARPS][2][N];  // each warp's db, dc
  __shared__ float s_out[kChunk][CH][2];        // du, ddt of the chunk

  const int64_t row = blockIdx.y;
  const int i0 = blockIdx.x * CH;
  const int cl = threadIdx.x / N;          // this thread's channel in the block
  const int n = threadIdx.x % N;           // and its state entry
  const int warp = threadIdx.x / 32;
  const int i = i0 + cl;
  const bool live = i < p.di;
  const int64_t hoff = (row * p.di + i) * N + n;
  const int chunks = (p.s + kChunk - 1) / kChunk;

  // dead lanes (past I) run on zeros so that every lane takes the shuffles
  const float a = live ? p.a[i * p.as[0] + n * p.as[1]] : 0.f;
  float h = (live && p.h0 != nullptr) ? p.h0[hoff] : 0.f;
  const float* u = p.u + row * p.us[0];
  const float* dt = p.dt + row * p.dts[0];
  const float* bm = p.b + row * p.bs[0];
  const float* cm = p.c + row * p.cs[0];
  const float* dy = p.dy + row * p.s * p.di;

  // u, dt and B of steps [t0, t0 + len), and dy and C when walking back
  auto stage = [&](int t0, int len, bool back) {
    for (int idx = threadIdx.x; idx < len * CH; idx += kSsmBwdThreads) {
      const int j = idx / CH, ci = idx % CH, ii = i0 + ci;
      const int64_t t = t0 + j;
      const bool ok = ii < p.di;
      s_u[j][ci] = ok ? u[t * p.us[1] + ii * p.us[2]] : 0.f;
      s_dt[j][ci] = ok ? dt[t * p.dts[1] + ii * p.dts[2]] : 0.f;
      if (back) s_dy[j][ci] = ok ? dy[t * p.di + ii] : 0.f;
    }
    for (int idx = threadIdx.x; idx < len * N; idx += kSsmBwdThreads) {
      const int j = idx / N, nn = idx % N;
      const int64_t t = t0 + j;
      s_b[j][nn] = bm[t * p.bs[1] + nn * p.bs[2]];
      if (back) s_c[j][nn] = cm[t * p.cs[1] + nn * p.cs[2]];
    }
  };
  auto boundary = [&](int k) -> float* {
    return p.scratch + ((row * chunks + k) * p.di + i) * N + n;
  };

  // forward: the state entering each chunk (the last chunk's steps are not
  // needed for that)
  for (int k = 0; k < chunks; ++k) {
    if (live) *boundary(k) = h;
    if (k == chunks - 1) break;
    const int t0 = k * kChunk;
    __syncthreads();  // the previous chunk's inputs are read
    stage(t0, kChunk, false);
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      const float dtv = s_dt[j][cl];
      h = expf(dtv * a) * h + dtv * s_b[j][n] * s_u[j][cl];
    }
  }

  // reverse, chunk by chunk from the last
  float g = (live && p.dh_out != nullptr) ? p.dh_out[hoff] : 0.f;
  float da = 0.f;
  for (int k = chunks - 1; k >= 0; --k) {
    const int t0 = k * kChunk;
    const int len = min(kChunk, p.s - t0);
    __syncthreads();  // the previous chunk's inputs and outputs are read
    stage(t0, len, true);
    __syncthreads();
    const float hs = live ? *boundary(k) : 0.f;
    float hist[kChunk], dah[kChunk];  // h_t and dA_t of the chunk's steps
    float hc = hs;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      if (j < len) {
        const float dtv = s_dt[j][cl];
        dah[j] = expf(dtv * a);
        hc = dah[j] * hc + dtv * s_b[j][n] * s_u[j][cl];
        hist[j] = hc;
      }
    }
    // batches of N steps from the chunk's end; a step past the length adds
    // zeros and leaves g as it is
#pragma unroll
    for (int jb = kChunk - N; jb >= 0; jb -= N) {
      float part[N][2];
#pragma unroll
      for (int jj = N - 1; jj >= 0; --jj) {
        const int j = jb + jj;
        float db = 0.f, dc = 0.f;
        part[jj][0] = part[jj][1] = 0.f;
        if (j < len) {
          const float dtv = s_dt[j][cl], uv = s_u[j][cl], dyv = s_dy[j][cl];
          const float bn = s_b[j][n], cn = s_c[j][n];
          const float hp = j > 0 ? hist[j - 1] : hs;
          g = fmaf(cn, dyv, g);
          dc = dyv * hist[j];
          db = g * dtv * uv;
          part[jj][0] = g * bn;
          part[jj][1] = g * (a * dah[j] * hp + bn * uv);
          da = fmaf(g * dtv, dah[j] * hp, da);
          g *= dah[j];
        }
        // over the warp's channels (lanes N apart), then its first channel's
        // lanes hold the warp's share
        db = lanes_sum<CPW, N>(db);
        dc = lanes_sum<CPW, N>(dc);
        if (cl % CPW == 0) {
          s_red[j][warp][0][n] = db;
          s_red[j][warp][1][n] = dc;
        }
      }
      // over the channel's N entries: lane n ends with step jb + n
      reduce_scatter<N / 2, 1>(part, n);
      s_out[jb + n][cl][0] = part[0][0] * s_dt[jb + n][cl];
      s_out[jb + n][cl][1] = part[0][1];
    }
    __syncthreads();  // the chunk's du, ddt and every warp's db, dc are in
    for (int idx = threadIdx.x; idx < len * CH; idx += kSsmBwdThreads) {
      const int j = idx / CH, ci = idx % CH, ii = i0 + ci;
      if (ii < p.di) {
        const int64_t o = (row * p.s + t0 + j) * p.di + ii;
        p.du[o] = s_out[j][ci][0];
        p.ddt[o] = s_out[j][ci][1];
      }
    }
    for (int idx = threadIdx.x; idx < 2 * len * N; idx += kSsmBwdThreads) {
      const int q = idx / (len * N), j = idx / N % len, nn = idx % N;
      float sum = s_red[j][0][q][nn];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) sum += s_red[j][w][q][nn];
      p.bc_part[(((q * p.bsz + row) * gridDim.x + blockIdx.x) * p.s + t0 + j) * N + nn] = sum;
    }
  }
  if (live) {
    p.da_part[hoff] = da;
    if (p.dh0 != nullptr) p.dh0[hoff] = g;
  }
}

template <int N>
static cudaError_t launch(const SsmBwdParams& p, cudaStream_t stream) {
  constexpr int CH = kSsmBwdThreads / N;
  const dim3 grid((p.di + CH - 1) / CH, p.bsz);
  ssm_scan_bwd_kernel<N><<<grid, kSsmBwdThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace repro

// strides: 14 int64 values in elements: (batch, seq, channel) of u and dt,
// (batch, seq, state) of b and c, then (channel, state) of a, as
// repro_ssm_scan takes them. All tensors are float32; h0, dh_out and dh0
// may be null. bc_part holds (2, B, ceil(I / (256 / N)), S, N) floats and
// scratch (B, ceil(S / 16), I, N).
extern "C" int repro_ssm_scan_bwd(const void* u, const void* dt, const void* a,
                                  const void* b, const void* c, const void* h0,
                                  const void* dy, const void* dh_out, void* du, void* ddt,
                                  void* da_part, void* bc_part, void* dh0, void* scratch,
                                  const int64_t* strides, int bsz, int s, int di, int n,
                                  void* stream) {
  repro::SsmBwdParams p;
  p.u = static_cast<const float*>(u);
  p.dt = static_cast<const float*>(dt);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.c = static_cast<const float*>(c);
  p.h0 = static_cast<const float*>(h0);
  p.dy = static_cast<const float*>(dy);
  p.dh_out = static_cast<const float*>(dh_out);
  p.du = static_cast<float*>(du);
  p.ddt = static_cast<float*>(ddt);
  p.da_part = static_cast<float*>(da_part);
  p.bc_part = static_cast<float*>(bc_part);
  p.dh0 = static_cast<float*>(dh0);
  p.scratch = static_cast<float*>(scratch);
  for (int i = 0; i < 3; ++i) {
    p.us[i] = strides[i];
    p.dts[i] = strides[3 + i];
    p.bs[i] = strides[6 + i];
    p.cs[i] = strides[9 + i];
  }
  p.as[0] = strides[12];
  p.as[1] = strides[13];
  p.bsz = bsz;
  p.s = s;
  p.di = di;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 8: return repro::launch<8>(p, st);
    case 16: return repro::launch<16>(p, st);
    default: return cudaErrorInvalidValue;
  }
}
