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
// What the first design lost: it wrote every step's state to a scratch of
// B H S K K floats and read it back in the reverse walk (671 MB at the shape
// above, 1.34 GB of traffic: 0.40 ms of the card's bandwidth, more than half
// its time), and one block a (row, head), 320 blocks of 256 threads at 105
// registers, ran as 1.21 waves on 132 SMs.
//
// This design:
// * Column v of S and of G needs only r, k, w, u and v_t[v], dy_t[v], so a
//   (row, head) is split by column slice over C = K / 16 blocks of 16
//   columns (as the forward, csrc/wkv6.cu, splits its state), a
//   thread-block cluster: 1,280 blocks at the shape above. A thread owns row
//   k of the state over a quad of its slice's columns (4 entries), a block 4
//   K threads.
// * The scratch keeps only the state entering every 16-step chunk (42 MB
//   at the shape above, written once and read once). The reverse walk
//   recomputes a chunk's states from its kept one into registers (15 x 4
//   floats a thread), the next chunk's kept state loaded ahead.
// * r, k, w of a chunk (all K) and v, dy (the slice's 16 columns) are
//   staged by cp.async into two buffers, 16 bytes a copy (the wrapper puts
//   inputs that lie off the 16-byte grid onto it), the next chunk's copies
//   in flight during this chunk's walk; the staging loops stay rolled and
//   index in 32 bits (the wrapper bounds a (row, head)'s offsets).
// * Sums: each step a thread stores its row's partial dr, dk, dw (over its 4
//   columns) and its 4 columns' dv terms in shared memory. Every 8 steps the
//   block sums the row partials over its 4 quads, with the terms in dy . v
//   (over the slice's columns, once a step) and du's, into slice sums; then
//   dv over its K rows (16-byte loads, a quarter of the rows a lane, the
//   quarters added by two shuffles). It releases the slice sums to the
//   cluster (barrier.cluster.arrive), stores dv, waits for the other
//   blocks, and sums dr, dk, dw over the slices in rank order through
//   distributed shared memory, each block for K / C rows, so each gradient
//   is written once; the slice sums are double-buffered, so one cluster
//   barrier a round suffices. du is one partial a (row, slice), summed by
//   the wrapper. Every sum has a fixed order and no atomics: two calls give
//   the same bits.
// * 2 blocks an SM (__launch_bounds__(4 K, 2), 106 KB of shared memory at
//   K = 64): the 1,280 blocks run as 4.85 waves of 264.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {

namespace cg = cooperative_groups;

struct WkvBwdParams {
  const float* r;           // r, k, v, w, dy and the gradients (B, H, S, K):
  const float* k;           // last axis contiguous, strides multiples of 4,
  const float* v;           // on the 16-byte grid
  const float* w;
  const float* u;           // (H, K) contiguous
  const float* state0;      // (B, H, K, K) contiguous, may be null: zeros
  const float* dy;
  const float* dstate_out;  // (B, H, K, K) contiguous, may be null: zeros
  float* dr;
  float* dk;
  float* dv;
  float* dw;
  float* du_part;           // (B, slices, H, K): each (row, slice)'s share of du
  float* dstate0;           // (B, H, K, K) contiguous, may be null: not wanted
  float* scratch;           // (B, H, chunks, K, K): the state entering each chunk
  int64_t rs[3], ks[3], vs[3], ws[3], dys[3];  // strides of (batch, head, seq)
  int64_t gs[3];            // strides of (batch, head, seq) of dr, dk, dv, dw
  int h, s;
};

constexpr int kWkvBwdCols = 16;   // columns a block (rwkv6_scan.BWD_COLS)
constexpr int kWkvBwdChunk = 16;  // steps between kept states (rwkv6_scan.BWD_CHUNK)
constexpr int kWkvBwdRound = 8;   // steps summed at once (rwkv6_scan.BWD_ROUND)

// The block for head size K. Shared memory (floats): two staging buffers of
// [T][K] r, k, w and [T][CW] v, dy; the rows' partials, [R][4 quads] planes
// of K float4 (dr, dk, dw, -) padded by 2 float4; the dv terms, [R] planes
// of [K][CW] padded by 16; two buffers of [R][3][K] slice sums read by the
// cluster; dy . v of the chunk's steps; u. The launch plan's smem_bytes.
template <int K>
struct WkvBwdBlock {
  static constexpr int CW = kWkvBwdCols, T = kWkvBwdChunk, R = kWkvBwdRound;
  static constexpr int C = K / CW;
  static constexpr int THREADS = 4 * K;
  static constexpr int BUF = T * (3 * K + 2 * CW);
  static constexpr int PART = 4 * (K + 2);       // one quad's plane, floats
  static constexpr int DVP = K * CW + 16;        // one step's dv plane
  static constexpr int RED = R * 3 * K;          // one buffer of slice sums
  static constexpr int SMEM_BYTES = 4 * (2 * BUF + R * 4 * PART + R * DVP + 2 * RED + T + K);
  static_assert(C >= 1 && C <= 8, "a portable cluster of slices");
};

template <int K>
__global__ void __launch_bounds__(4 * K, 2)
wkv6_bwd_kernel(const WkvBwdParams p) {
  using Blk = WkvBwdBlock<K>;
  constexpr int CW = Blk::CW, T = Blk::T, R = Blk::R, C = Blk::C, THREADS = Blk::THREADS;
  constexpr int BUF = Blk::BUF, PART = Blk::PART, DVP = Blk::DVP, RED = Blk::RED;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_part = smem + 2 * BUF;          // [R][4][K + 2] float4
  float* s_dv = s_part + R * 4 * PART;     // [R][K][CW], planes padded
  float* s_red = s_dv + R * DVP;           // [2][R][3][K]
  float* s_dyv = s_red + 2 * RED;          // [T]
  float* s_u = s_dyv + T;                  // [K]

  cg::cluster_group cluster = cg::this_cluster();
  const int head = blockIdx.x / C;
  const int slice = blockIdx.x % C;        // the cluster's rank: clusters are (C, 1, 1)
  const int c0 = slice * CW;               // the slice's first column
  const int64_t b = blockIdx.y;
  const int kr = threadIdx.x / 4;          // this thread's row of the state
  const int quad = threadIdx.x % 4;        // and its columns c0 + 4 quad ..
  const int64_t bh = b * p.h + head;
  const int64_t soff = bh * K * K + kr * K + c0 + quad * 4;
  const int chunks = (p.s + T - 1) / T;
  const float* r = p.r + b * p.rs[0] + head * p.rs[1];
  const float* k = p.k + b * p.ks[0] + head * p.ks[1];
  const float* v = p.v + b * p.vs[0] + head * p.vs[1];
  const float* w = p.w + b * p.ws[0] + head * p.ws[1];
  const float* dy = p.dy + b * p.dys[0] + head * p.dys[1];
  auto kept = [&](int ch) { return p.scratch + (bh * chunks + ch) * K * K + (soff - bh * K * K); };

  // chunk ch into a buffer: [T][K] r, k, w; [T][CW] v, dy (r and dy only
  // when walking back), 16 bytes a copy
  auto stage = [&](float* buf, int ch, bool back) {
    const int t0 = ch * T, len = min(T, p.s - t0);
    const int first = back ? 0 : 1;  // r is array 0
    // element offsets within this (row, head) fit in 32 bits (the wrapper checks)
    const int sr = static_cast<int>(p.rs[2]), sk = static_cast<int>(p.ks[2]);
    const int sw = static_cast<int>(p.ws[2]), sv = static_cast<int>(p.vs[2]);
    const int sy = static_cast<int>(p.dys[2]);
#pragma unroll 1
    for (int arr = first; arr < 3; ++arr) {
      const float* src = arr == 0 ? r : arr == 1 ? k : w;
      const int st = arr == 0 ? sr : arr == 1 ? sk : sw;
#pragma unroll 1
      for (int idx = threadIdx.x; idx < len * (K / 4); idx += THREADS) {
        const int j = idx / (K / 4), x = idx % (K / 4) * 4;
        cp_async16(smem_u32(buf + arr * T * K + j * K + x), src + ((t0 + j) * st + x));
      }
    }
#pragma unroll 1
    for (int idx = threadIdx.x; idx < len * (CW / 4); idx += THREADS) {
      const int j = idx / (CW / 4), x = idx % (CW / 4) * 4, t = t0 + j;
      cp_async16(smem_u32(buf + 3 * T * K + j * CW + x), v + (t * sv + c0 + x));
      if (back) cp_async16(smem_u32(buf + 3 * T * K + T * CW + j * CW + x), dy + (t * sy + c0 + x));
    }
    cp_async_commit();
  };
  for (int x = threadIdx.x; x < K; x += THREADS) s_u[x] = p.u[head * K + x];

  // ---- forward: the state entering each chunk (the last chunk's steps are
  // not needed for that)
  float st[4];
  if (p.state0 != nullptr) {
    load_floats<4>(st, p.state0 + soff);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) st[c] = 0.f;
  }
  if (chunks > 1) stage(smem, 0, false);
  for (int ch = 0, cur = 0; ch < chunks; ++ch, cur ^= 1) {
    store_floats<4>(kept(ch), st);
    if (ch == chunks - 1) break;
    if (ch + 2 < chunks) {
      stage(smem + (cur ^ 1) * BUF, ch + 1, false);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk has landed, from every thread's copies
    const float* s_k = smem + cur * BUF + T * K;
    const float* s_w = s_k + T * K;
    const float* s_v = s_w + T * K;
#pragma unroll 4
    for (int j = 0; j < T; ++j) {  // a chunk before the last is whole
      const float kk = s_k[j * K + kr], wk = s_w[j * K + kr];
      float vj[4];
      load_floats<4>(vj, s_v + j * CW + quad * 4);
#pragma unroll
      for (int c = 0; c < 4; ++c) st[c] = fmaf(wk, st[c], kk * vj[c]);
    }
    __syncthreads();  // this buffer is read before the next stage refills it
  }

  // ---- reverse, chunk by chunk from the last, in rounds of R steps
  float g[4];
  if (p.dstate_out != nullptr) {
    load_floats<4>(g, p.dstate_out + soff);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c) g[c] = 0.f;
  }
  float du = 0.f;  // row threadIdx.x % K's share over this thread's rounds
  float nxt[4];    // the next chunk's kept state, loaded ahead
  load_floats<4>(nxt, kept(chunks - 1));
  stage(smem, chunks - 1, true);
  int red = 0;     // the slice-sum buffer of this round
  for (int ch = chunks - 1, cur = 0; ch >= 0; --ch, cur ^= 1) {
    float hs[4];   // the state entering the chunk
#pragma unroll
    for (int c = 0; c < 4; ++c) hs[c] = nxt[c];
    if (ch > 0) {
      load_floats<4>(nxt, kept(ch - 1));
      stage(smem + (cur ^ 1) * BUF, ch - 1, true);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk has landed, from every thread's copies
    const float* s_r = smem + cur * BUF;
    const float* s_k = s_r + T * K;
    const float* s_w = s_k + T * K;
    const float* s_v = s_w + T * K;
    const float* s_dy = s_v + T * CW;
    const int t0 = ch * T, len = min(T, p.s - t0);
    // dy . v over the slice's columns, a step (read after the round's barrier)
    for (int j = threadIdx.x; j < len; j += THREADS) {
      float acc = 0.f;
#pragma unroll
      for (int x = 0; x < CW; ++x) acc = fmaf(s_dy[j * CW + x], s_v[j * CW + x], acc);
      s_dyv[j] = acc;
    }
    // the chunk's states after each step but the last, recomputed
    float hist[T - 1][4];
#pragma unroll
    for (int j = 0; j < T - 1; ++j) {
      if (j < len - 1) {
        const float kk = s_k[j * K + kr], wk = s_w[j * K + kr];
        float vj[4];
        load_floats<4>(vj, s_v + j * CW + quad * 4);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          hist[j][c] = fmaf(wk, j > 0 ? hist[j > 0 ? j - 1 : 0][c] : hs[c], kk * vj[c]);
      }
    }
    const float uk = s_u[kr];
#pragma unroll
    for (int rb = T - R; rb >= 0; rb -= R) {
      if (rb >= len) continue;  // uniform over the cluster: its blocks share (row, head)
      const int nj = min(R, len - rb);
#pragma unroll
      for (int jj = R - 1; jj >= 0; --jj) {
        const int j = rb + jj;
        if (j < len) {
          const float rk = s_r[j * K + kr], kk = s_k[j * K + kr], wk = s_w[j * K + kr];
          const float ruk = rk * uk;
          float vj[4], dyj[4], prev[4], dvp[4];
          load_floats<4>(vj, s_v + j * CW + quad * 4);
          load_floats<4>(dyj, s_dy + j * CW + quad * 4);
#pragma unroll
          for (int c = 0; c < 4; ++c) prev[c] = j > 0 ? hist[j > 0 ? j - 1 : 0][c] : hs[c];
          float dr = 0.f, dk = 0.f, dw = 0.f;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            dr = fmaf(dyj[c], prev[c], dr);
            dk = fmaf(g[c], vj[c], dk);
            dw = fmaf(g[c], prev[c], dw);
            dvp[c] = fmaf(dyj[c], ruk, g[c]) * kk;
            g[c] = fmaf(wk, g[c], rk * dyj[c]);
          }
          *reinterpret_cast<float4*>(s_part + (jj * 4 + quad) * PART + kr * 4) =
              make_float4(dr, dk, dw, 0.f);
          store_floats<4>(s_dv + jj * DVP + kr * CW + quad * 4, dvp);
        }
      }
      __syncthreads();  // the round's terms are in
      // dr, dk, dw of the slice over the 4 quads, with the dy . v terms; du
      float* sred = s_red + red * RED;
      for (int o = threadIdx.x; o < nj * K; o += THREADS) {
        const int jj = o / K, y = o % K, j = rb + jj;
        float drs = 0.f, dks = 0.f, dws = 0.f;
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {  // quad order
          const float4 q = *reinterpret_cast<const float4*>(s_part + (jj * 4 + qq) * PART + y * 4);
          drs += q.x, dks += q.y, dws += q.z;
        }
        const float dyv = s_dyv[j];
        const float ry = s_r[j * K + y], ky = s_k[j * K + y], uy = s_u[y];
        sred[(jj * 3) * K + y] = fmaf(uy * ky, dyv, drs);
        sred[(jj * 3 + 1) * K + y] = fmaf(ry * uy, dyv, dks);
        sred[(jj * 3 + 2) * K + y] = dws;
        du = fmaf(ry * ky, dyv, du);
      }
      // dv over the block's K rows: lanes l, l + 8, l + 16, l + 24 of a warp
      // sum a quarter of the rows each for the same 4 columns (16-byte
      // loads, even and odd rows apart), the quarters added by two shuffles
      constexpr int OUT4 = R * CW / 4, QR = K / 4;
      const int quarter = threadIdx.x % 32 / 8;
      float4 dv4[(OUT4 + THREADS / 4 - 1) / (THREADS / 4)];
#pragma unroll
      for (int m = 0; m * (THREADS / 4) < OUT4; ++m) {
        const int o4 = m * (THREADS / 4) + threadIdx.x / 32 * 8 + threadIdx.x % 8;
        float4 e = make_float4(0.f, 0.f, 0.f, 0.f), od = e;
        if (o4 < OUT4) {
          const float* col = s_dv + o4 / (CW / 4) * DVP + quarter * QR * CW + o4 % (CW / 4) * 4;
#pragma unroll 4
          for (int y = 0; y < QR; y += 2) {
            const float4 a = *reinterpret_cast<const float4*>(col + y * CW);
            const float4 c = *reinterpret_cast<const float4*>(col + (y + 1) * CW);
            e.x += a.x, e.y += a.y, e.z += a.z, e.w += a.w;
            od.x += c.x, od.y += c.y, od.z += c.z, od.w += c.w;
          }
        }
        float4 v4 = make_float4(e.x + od.x, e.y + od.y, e.z + od.z, e.w + od.w);
#pragma unroll
        for (int off = 8; off <= 16; off *= 2) {
          v4.x += __shfl_xor_sync(0xffffffffu, v4.x, off);
          v4.y += __shfl_xor_sync(0xffffffffu, v4.y, off);
          v4.z += __shfl_xor_sync(0xffffffffu, v4.z, off);
          v4.w += __shfl_xor_sync(0xffffffffu, v4.w, off);
        }
        dv4[m] = v4;
      }
      // every read of this round's terms is done: release the slice sums to
      // the cluster, store dv while the other blocks arrive
      cluster_arrive();
#pragma unroll
      for (int m = 0; m * (THREADS / 4) < OUT4; ++m) {
        const int o4 = m * (THREADS / 4) + threadIdx.x / 32 * 8 + threadIdx.x % 8;
        const int jj = o4 / (CW / 4);
        if (quarter == 0 && o4 < OUT4 && jj < nj) {
          const int64_t t = t0 + rb + jj;
          *reinterpret_cast<float4*>(
              p.dv + b * p.gs[0] + head * p.gs[1] + t * p.gs[2] + c0 + o4 % (CW / 4) * 4) = dv4[m];
        }
      }
      cluster_wait();
      // over the cluster's slices in rank order: this block's K / C rows
      for (int o = threadIdx.x; o < nj * 3 * (K / C); o += THREADS) {
        const int jj = o / (3 * (K / C)), q = o / (K / C) % 3;
        const int y = slice * (K / C) + o % (K / C);
        const int at = red * RED + (jj * 3 + q) * K + y;
        float sum = cluster.map_shared_rank(s_red, 0)[at];
#pragma unroll
        for (int rank = 1; rank < C; ++rank) sum += cluster.map_shared_rank(s_red, rank)[at];
        float* out = q == 0 ? p.dr : q == 1 ? p.dk : p.dw;
        out[b * p.gs[0] + head * p.gs[1] + (t0 + rb + jj) * p.gs[2] + y] = sum;
      }
      red ^= 1;
    }
  }
  // du: the rows' shares over this block's 4 threads a row, in order
  __syncthreads();
  s_part[threadIdx.x] = du;
  __syncthreads();
  if (threadIdx.x < K) {
    const float* d = s_part + threadIdx.x;
    p.du_part[((b * C + slice) * p.h + head) * K + threadIdx.x] = (d[0] + d[K]) + (d[2 * K] + d[3 * K]);
  }
  if (p.dstate0 != nullptr) store_floats<4>(p.dstate0 + soff, g);
  cluster.sync();  // no block leaves while another reads its slice sums
}

template <int K>
static cudaError_t launch(const WkvBwdParams& p, int bsz, int smem_bytes, cudaStream_t stream) {
  using Blk = WkvBwdBlock<K>;
  if (smem_bytes != Blk::SMEM_BYTES) return cudaErrorInvalidValue;
  const auto kernel = wkv6_bwd_kernel<K>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.h * Blk::C, bsz);
  cfg.blockDim = dim3(Blk::THREADS);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;  // the slices of a (row, head)
  attr[0].val.clusterDim.x = Blk::C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace repro

// strides: 18 int64 values in elements, the (batch, head, seq) strides of r,
// k, v, w, dy and of the four gradients dr, dk, dv, dw (one layout): each
// a multiple of 4, the last axis of each contiguous and each on the 16-byte
// grid. All tensors are float32; state0, dstate_out and dstate0 may be null.
// The launch plan (kernels/rwkv6_scan.py::backward_plan), taken as given:
// `smem_bytes` of shared memory; the wrapper allocates du_part (B, K / 16,
// H, K) and scratch (B, H, ceil(S / 16), K, K).
extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const void* state0, const void* dy,
                              const void* dstate_out, void* dr, void* dk, void* dv, void* dw,
                              void* du_part, void* dstate0, void* scratch,
                              const int64_t* strides, int bsz, int h, int s, int kd,
                              int smem_bytes, void* stream) {
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
  if (s < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kd) {
    case 16: return repro::launch<16>(p, bsz, smem_bytes, st);
    case 32: return repro::launch<32>(p, bsz, smem_bytes, st);
    case 64: return repro::launch<64>(p, bsz, smem_bytes, st);
    default: return cudaErrorInvalidValue;
  }
}
