// The RWKV-6 WKV recurrence's backward for Hopper.
//
// Replaces no TPU kernel: the JAX package takes this gradient by XLA's
// autodiff of its lax.scan (src/repro/models/rwkv.py:160 under
// chunked_scan, held here to jax.grad of
// src/repro/kernels/ref.py::wkv6_reference). Per batch row and head, with
// the (K, V) f32 state S_{t-1} before step t and G_t the gradient of the
// state after it (G_{S-1} = dstate_out, G_{t-1} = w_t (.)_k G_t + r_t dy_t^T):
//     dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t,   dk_t = r_t u (dy_t . v_t) + G_t v_t,
//     dv_t = dy_t (sum_k r_t u k_t) + G_t^T k_t,   dw_t[k] = sum_v G_t[k,v] S_{t-1}[k,v],
//     du = sum_{rows,t} r_t k_t (dy_t . v_t),      dstate0 = G_{-1},
// the plain version's formulas (kernels/ref.py::wkv6_backward_reference).
// It never divides by a decay, so decays of 1e-4 and 0.999 stay finite.
//
// What bounds it on the card: operations, about as much as bytes. Per
// (row, head, step) it reads r, k, v, w and dy and writes dr, dk, dv and dw
// (9 K floats); per state entry and step it does ~15 operations (2 to
// recompute the state, 13 in the reverse step). At rwkv6-3b's training
// shape (B = 8, H = 40, S = 128, K = 64) that is 100 MB with the states
// (30 us at 3.35 TB/s) and 2.5 GFLOP (38 us at the f32 rate of 67 TFLOP/s).
//
// Design: a simple kernel that is right. The reverse walk needs S_{t-1} at
// every step, and S cannot be run backwards (dividing by a decay is not
// allowed). A thread's share of the state is K / 4 entries, so a chunk of
// states would not fit in its registers as the selective scan's backward
// keeps them; a first pass instead walks the recurrence forward and stores
// every step's state in a scratch of B * H * S * K * K floats that the
// wrapper allocates (671 MB at the shape above, written once and read
// once: ~0.4 ms of the card's bandwidth). One block per (row, head), of
// 4 K threads: a thread owns row k of the state over every fourth column
// (4 c + slice, so that a warp's reads of v and dy from shared memory hit
// distinct banks), and keeps G for them in registers. The sums over the
// columns (dr, dk, dw, dy . v) are a thread's partials summed over its
// row's 4 lanes by shuffles; the sums over the rows (dv) are reduce-scattered
// over a warp's 8 rows by shuffles (7 per two columns), then summed over
// the block's warps in shared memory once a tile of kWkvBwdTile steps; du is one
// partial per batch row, summed by the wrapper. Every sum is in a fixed
// order, with no atomics: two calls give the same bits. The scratch is laid
// out so that a warp's accesses to it are 128 contiguous bytes. Not yet
// fast: the scratch's traffic is ten times the bytes the function must move.
#include "common.cuh"

namespace repro {

struct WkvBwdParams {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;           // (H, K) contiguous
  const float* state0;      // (B, H, K, K) contiguous, may be null: zeros
  const float* dy;
  const float* dstate_out;  // (B, H, K, K) contiguous, may be null: zeros
  float* dr;
  float* dk;
  float* dv;
  float* dw;
  float* du_part;           // (B, H, K): each batch row's share of du
  float* dstate0;           // (B, H, K, K) contiguous, may be null: not wanted
  float* scratch;           // (B, H, S, K / 4, 4 K): the state before each step
  int64_t rs[3], ks[3], vs[3], ws[3], dys[3];  // strides of (batch, head, seq)
  int64_t gs[3];            // strides of (batch, head, seq) of dr, dk, dv, dw
  int h, s;
};

constexpr int kWkvBwdTile = 8;   // steps staged at once (rwkv6_scan.BWD_TILE)

template <int K>
__global__ void __launch_bounds__(4 * K)
wkv6_bwd_kernel(const WkvBwdParams p) {
  constexpr int THREADS = 4 * K;
  constexpr int CW = K / 4;                 // columns a thread
  constexpr int WARPS = THREADS / 32;
  constexpr int V = CW >= 8 ? CW / 8 : 1;   // columns a row lane holds after the scatter
  constexpr int T = kWkvBwdTile;
  __shared__ float s_r[T][K], s_k[T][K], s_w[T][K], s_v[T][K], s_dy[T][K];
  __shared__ float s_dv[T][WARPS][K];       // each warp's share of dv
  __shared__ float s_u[K];

  const int head = blockIdx.x;
  const int64_t b = blockIdx.y;
  const int kr = threadIdx.x / 4;           // this thread's row of the state
  const int sl = threadIdx.x % 4;           // its columns: 4 c + sl
  const int warp = threadIdx.x / 32;
  const int rg = threadIdx.x % 32 / 4;      // its row among the warp's 8
  const int64_t bh = b * p.h + head;
  const int64_t soff = bh * K * K + kr * K + sl;
  const float* r = p.r + b * p.rs[0] + head * p.rs[1];
  const float* k = p.k + b * p.ks[0] + head * p.ks[1];
  const float* v = p.v + b * p.vs[0] + head * p.vs[1];
  const float* w = p.w + b * p.ws[0] + head * p.ws[1];
  const float* dy = p.dy + b * p.dys[0] + head * p.dys[1];
  // entry c of this thread's share of the state before step t
  auto saved = [&](int64_t t, int c) -> float* {
    return p.scratch + ((bh * p.s + t) * CW + c) * THREADS + threadIdx.x;
  };
  // k, w and v of steps [t0, t0 + len), and r and dy when walking back
  auto stage = [&](int t0, int len, bool back) {
    for (int idx = threadIdx.x; idx < len * K; idx += THREADS) {
      const int j = idx / K, x = idx % K;
      const int64_t t = t0 + j;
      s_k[j][x] = k[t * p.ks[2] + x];
      s_w[j][x] = w[t * p.ws[2] + x];
      s_v[j][x] = v[t * p.vs[2] + x];
      if (back) {
        s_r[j][x] = r[t * p.rs[2] + x];
        s_dy[j][x] = dy[t * p.dys[2] + x];
      }
    }
  };
  if (threadIdx.x < K) s_u[threadIdx.x] = p.u[head * K + threadIdx.x];
  __syncthreads();
  const float uk = s_u[kr];

  // forward: every step's state, before the step
  float st[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c)
    st[c] = p.state0 != nullptr ? p.state0[soff + 4 * c] : 0.f;
  for (int t0 = 0; t0 < p.s; t0 += T) {
    const int len = min(T, p.s - t0);
    __syncthreads();  // the previous tile is read
    stage(t0, len, false);
    __syncthreads();
    for (int j = 0; j < len; ++j) {
      const float kk = s_k[j][kr], wk = s_w[j][kr];
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        *saved(t0 + j, c) = st[c];
        st[c] = wk * st[c] + kk * s_v[j][4 * c + sl];
      }
    }
  }

  // reverse, tile by tile from the last
  float g[CW];
#pragma unroll
  for (int c = 0; c < CW; ++c)
    g[c] = p.dstate_out != nullptr ? p.dstate_out[soff + 4 * c] : 0.f;
  float du = 0.f;
  const int tiles = (p.s + T - 1) / T;
  for (int tile = tiles - 1; tile >= 0; --tile) {
    const int t0 = tile * T;
    const int len = min(T, p.s - t0);
    __syncthreads();  // the previous tile's inputs and dv shares are read
    stage(t0, len, true);
    __syncthreads();
    for (int j = len - 1; j >= 0; --j) {
      const int64_t t = t0 + j;
      const float rk = s_r[j][kr], kk = s_k[j][kr], wk = s_w[j][kr];
      float dr = 0.f, dk = 0.f, dw = 0.f, dyv = 0.f;
      float part[8][V];  // this row's dv terms, then the warp's sums
#pragma unroll
      for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int x = 0; x < V; ++x) part[q][x] = 0.f;
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        const float vj = s_v[j][4 * c + sl], dyj = s_dy[j][4 * c + sl];
        const float prev = *saved(t, c);
        dr = fmaf(dyj, prev, dr);
        dk = fmaf(g[c], vj, dk);
        dw = fmaf(g[c], prev, dw);
        dyv = fmaf(dyj, vj, dyv);
        part[c / V][c % V] = (dyj * rk * uk + g[c]) * kk;
        g[c] = wk * g[c] + rk * dyj;
      }
      // over the row's 4 lanes
      dr = lanes_sum<4, 1>(dr);
      dk = lanes_sum<4, 1>(dk);
      dw = lanes_sum<4, 1>(dw);
      dyv = lanes_sum<4, 1>(dyv);
      dr = fmaf(uk * kk, dyv, dr);
      dk = fmaf(rk * uk, dyv, dk);
      du = fmaf(rk * kk, dyv, du);
      const int64_t o = b * p.gs[0] + head * p.gs[1] + t * p.gs[2] + kr;
      if (sl == 0) p.dr[o] = dr;
      if (sl == 1) p.dk[o] = dk;
      if (sl == 2) p.dw[o] = dw;
      // over the warp's 8 rows (lanes 4 apart): row lane rg ends with the
      // columns of group rg
      reduce_scatter<4, 4>(part, rg);
#pragma unroll
      for (int x = 0; x < V; ++x) {
        const int c = rg * V + x;
        if (c < CW) s_dv[j][warp][4 * c + sl] = part[0][x];
      }
    }
    __syncthreads();  // every warp's dv shares of the tile are in
    for (int idx = threadIdx.x; idx < len * K; idx += THREADS) {
      const int j = idx / K, x = idx % K;
      float sum = s_dv[j][0][x];
#pragma unroll
      for (int wi = 1; wi < WARPS; ++wi) sum += s_dv[j][wi][x];
      p.dv[b * p.gs[0] + head * p.gs[1] + (t0 + j) * p.gs[2] + x] = sum;
    }
  }
  if (sl == 0) p.du_part[bh * K + kr] = du;
  if (p.dstate0 != nullptr) {
#pragma unroll
    for (int c = 0; c < CW; ++c) p.dstate0[soff + 4 * c] = g[c];
  }
}

template <int K>
static cudaError_t launch(const WkvBwdParams& p, int bsz, cudaStream_t stream) {
  const dim3 grid(p.h, bsz);
  wkv6_bwd_kernel<K><<<grid, 4 * K, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace repro

// strides: 18 int64 values in elements, the (batch, head, seq) strides of r,
// k, v, w, dy and of the four gradients dr, dk, dv, dw (one layout); the
// last axis of each is contiguous. All tensors are float32; state0,
// dstate_out and dstate0 may be null. scratch holds B * H * S * K * K floats.
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* state0, const void* dy,
                              const void* dstate_out, void* dr, void* dk, void* dv, void* dw,
                              void* du_part, void* dstate0, void* scratch,
                              const int64_t* strides, int bsz, int h, int s, int kd,
                              void* stream) {
  repro::WkvBwdParams p;
  p.r = static_cast<const float*>(r);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.w = static_cast<const float*>(w);
  p.u = static_cast<const float*>(u);
  p.state0 = static_cast<const float*>(state0);
  p.dy = static_cast<const float*>(dy);
  p.dstate_out = static_cast<const float*>(dstate_out);
  p.dr = static_cast<float*>(dr);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.dw = static_cast<float*>(dw);
  p.du_part = static_cast<float*>(du_part);
  p.dstate0 = static_cast<float*>(dstate0);
  p.scratch = static_cast<float*>(scratch);
  for (int i = 0; i < 3; ++i) {
    p.rs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.ws[i] = strides[9 + i];
    p.dys[i] = strides[12 + i];
    p.gs[i] = strides[15 + i];
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
