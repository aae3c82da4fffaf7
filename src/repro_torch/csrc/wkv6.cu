// RWKV-6 WKV recurrence for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py::wkv6
// (_wkv_kernel, :30): per batch row and head, with a (K, V) f32 state S,
//     y_t = r_t . (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T,
// where w_t in (0, 1) is the data-dependent decay and u the bonus. It
// returns y and the final state; the state starts from state0 when one is
// given, else from zeros.
//
// What bounds it on the card: bytes. Per (row, head, step) it reads r, k, v
// and w (4 K floats) and writes y (K floats) for ~7 K^2 operations; the
// state is read and written once. At rwkv6-3b's decode step (B = 4, H = 40,
// S = 1, K = 64) that is 2.6 MB of state in and 2.6 MB out: 1.63 us at
// 3.35 TB/s. At its 32-token prefill (B = 1) r, k, v, w, y and the final
// state are 2.3 MB (0.69 us). One block of K threads per (row, head) would
// run 2.4 warps an SM at the decode step and use 40 of 132 SMs at a B = 1
// prefill, each step's y a 64-deep FMA chain. An in-place mul_ of the same
// state, rotated past the L2, takes ~3.5 us a call on the H100 (chip_smoke.py
// prints it beside this kernel's time): the read and write of the state set
// the decode step's time, and the design keeps all of it in flight at once.
//
// Design: the TPU kernel evaluates each chunk in a closed form over a
// (C, C, K) log-space decay tensor, to feed the TPU's matrix unit. Here the
// sequential recurrence is exact (the oracle's own form) and needs no log
// space: it only multiplies by w in (0, 1), so decays of 1e-4 and 0.999 stay
// finite. Column j of S needs only r_t, k_t, w_t, u and v_t[j], so a (row,
// head) is split by column slice over C blocks (C in {1, 2}, a template
// parameter picked by the launch plan: 2 at rwkv6-3b's decode step, 320
// blocks, and at its B = 1 prefill, 80), with no reduction across blocks.
// Within a block a thread owns a quad of columns (a float4) over R
// consecutive rows, lanes along the column quads first, so a warp loads and
// stores whole rows of its slice as 16-byte vectors. Each state entry keeps
// its arithmetic in the oracle's order,
//     y_j += r_k (S[k, j] + u_k k_k v_j),   S[k, j] = w_k S[k, j] + k_k v_j;
// only y's summation order changes: a thread's R rows; then the P row groups
// of a warp, which hold their partials for P steps in a row and
// reduce-scatter them by __shfl_xor_sync (P - 1 shuffles a column for P
// steps, after which row group g holds step g's sum; steps left over, all
// of a decode step, take a butterfly); then the warps, whose partials each
// step buffers in shared memory and the block sums, in warp order, once a
// tile of steps, storing y coalesced along the columns. No atomics: two
// calls give the same bits. The block stages r_t, k_t and w_t (all K) and
// its slice of v_t by cp.async, the next tile's copies in flight while this
// tile is computed (two buffers), and u once. The final state is stored
// before the last tile's y, so the two stores overlap. Inputs are read
// through their (batch, head, seq) strides, so the model's (B, S, H, K)
// projections need no transpose copy.
//
// The final state may be written over the initial one (state_out ==
// state0): each thread reads its own entries before it writes them. A
// state off the 16-byte grid moves as single floats.
#include "common.cuh"
#include "hopper.cuh"

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
  int steps;            // steps a tile
};

// The block of a plan (kernels/rwkv6_scan.py::launch_plan, which picks R):
// K columns split into C slices of CW, a thread owning a quad of columns
// over R rows, QUADS threads across a slice and P row groups a warp.
template <int K, int C, int R>
struct WkvBlock {
  static constexpr int CW = K / C;
  static constexpr int QUADS = CW / 4;
  static constexpr int THREADS = QUADS * (K / R);
  static constexpr int WARPS = THREADS / 32;
  static constexpr int P = 32 / QUADS;
  static_assert(THREADS % 32 == 0 && 32 % QUADS == 0, "whole warps of whole row groups");
};

// VEC: both states lie on the 16-byte grid and move as float4, else as floats
template <int K, int C, int R, bool VEC>
__global__ void __launch_bounds__(WkvBlock<K, C, R>::THREADS)
wkv6_kernel(const WkvParams p) {
  using S = WkvBlock<K, C, R>;
  constexpr int CW = S::CW, P = S::P, WARPS = S::WARPS;
  // two buffers of [steps][K] r, k, w and [steps][CW] v, then the warps'
  // partial y and u: the launch plan's smem_bytes (kernels/rwkv6_scan.py)
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile = p.steps * (3 * K + CW);     // one buffer's floats
  float* s_part = smem + 2 * tile;             // [steps][WARPS][CW]
  float* s_u = s_part + p.steps * WARPS * CW;  // [K]

  const int head = blockIdx.x / C;
  const int c0 = blockIdx.x % C * CW;          // the slice's first column
  const int64_t b = blockIdx.y;
  const int quad = threadIdx.x % S::QUADS;
  const int k0 = threadIdx.x / S::QUADS * R;   // this thread's first row
  const int j0 = c0 + quad * 4;                // and first column
  const int warp = threadIdx.x / 32;
  const int rg = threadIdx.x % 32 / S::QUADS;  // its row group within the warp
  const int64_t soff = (b * p.h + head) * K * K;

  float st[R][4];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    const float* src = p.state0 + soff + (k0 + rr) * K + j0;
    if (p.state0 != nullptr && VEC) {
      load_floats<4>(st[rr], src);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) st[rr][c] = p.state0 != nullptr ? src[c] : 0.f;
    }
  }
  auto store_state = [&]() {
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      float* dst = p.state_out + soff + (k0 + rr) * K + j0;
      if constexpr (VEC) {
        store_floats<4>(dst, st[rr]);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) dst[c] = st[rr][c];
      }
    }
  };
  const float* r = p.r + b * p.rs[0] + head * p.rs[1];
  const float* k = p.k + b * p.ks[0] + head * p.ks[1];
  const float* v = p.v + b * p.vs[0] + head * p.vs[1];
  const float* w = p.w + b * p.ws[0] + head * p.ws[1];
  float* y = p.y + b * p.ys[0] + head * p.ys[1];

  // a buffer holds [steps][K] of r, of k, of w, then [steps][CW] of v
  auto stage = [&](float* buf, int t0) {
    const int steps = min(p.steps, p.s - t0);
    for (int idx = threadIdx.x; idx < steps * K; idx += S::THREADS) {
      const int64_t t = t0 + idx / K;
      const int c = idx % K;
      cp_async4(smem_u32(buf + idx), r + t * p.rs[2] + c);
      cp_async4(smem_u32(buf + p.steps * K + idx), k + t * p.ks[2] + c);
      cp_async4(smem_u32(buf + 2 * p.steps * K + idx), w + t * p.ws[2] + c);
    }
    for (int idx = threadIdx.x; idx < steps * CW; idx += S::THREADS) {
      cp_async4(smem_u32(buf + 3 * p.steps * K + idx),
                v + (t0 + idx / CW) * p.vs[2] + c0 + idx % CW);
    }
    cp_async_commit();
  };
  if (p.s > 0) {  // u goes with the first tile's copies
    for (int idx = threadIdx.x; idx < K; idx += S::THREADS)
      cp_async4(smem_u32(s_u + idx), p.u + head * K + idx);
    stage(smem, 0);
  }

  int cur = 0;
  for (int t0 = 0; t0 < p.s; t0 += p.steps, cur ^= 1) {
    const int steps = min(p.steps, p.s - t0);
    const bool last = t0 + p.steps >= p.s;
    // the other buffer was last read by the previous tile, before the
    // barrier that ended its compute: fill it with the next tile
    if (!last) {
      stage(smem + (cur ^ 1) * tile, t0 + p.steps);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and u) has landed, from every thread
    const float* s_r = smem + cur * tile;
    const float* s_k = s_r + p.steps * K;
    const float* s_w = s_k + p.steps * K;
    const float* s_v = s_w + p.steps * K;
    float uk[R];
    load_floats<R>(uk, s_u + k0);
    // one step's partials over this thread's R rows, for its 4 columns
    auto step = [&](int t, float (&yp)[4]) {
      float vj[4], rk[R], kk[R], wk[R];
      load_floats<4>(vj, s_v + t * CW + quad * 4);
      load_floats<R>(rk, s_r + t * K + k0);
      load_floats<R>(kk, s_k + t * K + k0);
      load_floats<R>(wk, s_w + t * K + k0);
#pragma unroll
      for (int c = 0; c < 4; ++c) yp[c] = 0.f;
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float kv = kk[rr] * vj[c];
          yp[c] = fmaf(rk[rr], st[rr][c] + uk[rr] * kv, yp[c]);
          st[rr][c] = wk[rr] * st[rr][c] + kv;
        }
      }
    };
    // whole batches of P steps, whose loads and products overlap, then a
    // reduce-scatter over the warp's row groups (lanes QUADS apart): row
    // group g ends with step tb + g
    int tb = 0;
    for (; tb + P <= steps; tb += P) {
      float part[P][4];
#pragma unroll
      for (int j = 0; j < P; ++j) step(tb + j, part[j]);
      reduce_scatter<P / 2, S::QUADS>(part, rg);
      store_floats<4>(s_part + ((tb + rg) * WARPS + warp) * CW + quad * 4, part[0]);
    }
    // the rest (all of a decode step) one at a time, summed by a butterfly
    for (; tb < steps; ++tb) {
      float yp[4];
      step(tb, yp);
#pragma unroll
      for (int c = 0; c < 4; ++c) yp[c] = lanes_sum<P, S::QUADS>(yp[c]);
      if (rg == 0) store_floats<4>(s_part + (tb * WARPS + warp) * CW + quad * 4, yp);
    }
    if (last) store_state();  // before the tile's y, to overlap the two stores
    __syncthreads();  // every warp's partials are in, and the tile is read
    for (int idx = threadIdx.x; idx < steps * CW; idx += S::THREADS) {
      const int t = idx / CW, c = idx % CW;
      const float* col = s_part + t * WARPS * CW + c;
      float yj = col[0];
#pragma unroll
      for (int wi = 1; wi < WARPS; ++wi) yj += col[wi * CW];
      y[(t0 + t) * p.ys[2] + c0 + c] = yj;
    }
  }
  if (p.s == 0) store_state();
}

template <int K, int C, int R>
static cudaError_t launch(const WkvParams& p, int bsz, int smem_bytes, bool vec,
                          cudaStream_t stream) {
  const dim3 grid(p.h * C, bsz);
  constexpr int threads = WkvBlock<K, C, R>::THREADS;
  if (vec) {
    wkv6_kernel<K, C, R, true><<<grid, threads, smem_bytes, stream>>>(p);
  } else {
    wkv6_kernel<K, C, R, false><<<grid, threads, smem_bytes, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace repro

// strides: 15 int64 values in elements, the (batch, head, seq) strides of r,
// k, v, w and y; the last axis of each is contiguous. All tensors are
// float32; state0 may be null. The launch plan (kernels/rwkv6_scan.py::
// launch_plan), taken as given: `slices` column slices a (row, head),
// `rows` rows a thread (the two pick the block), `steps` a tile and
// `smem_bytes` of shared memory for it.
extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* state0,
                          void* y, void* state_out, const int64_t* strides,
                          int bsz, int h, int s, int kd, int slices, int rows,
                          int steps, int smem_bytes, void* stream) {
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
  p.steps = steps;
  const bool vec =
      (reinterpret_cast<uintptr_t>(state0) | reinterpret_cast<uintptr_t>(state_out)) % 16 == 0;
  if (steps < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((kd * 10 + slices) * 10 + rows) {  // the (K, slices, rows) the plan takes
    case 1611: return repro::launch<16, 1, 1>(p, bsz, smem_bytes, vec, st);
    case 1621: return repro::launch<16, 2, 1>(p, bsz, smem_bytes, vec, st);
    case 3212: return repro::launch<32, 1, 2>(p, bsz, smem_bytes, vec, st);
    case 3221: return repro::launch<32, 2, 1>(p, bsz, smem_bytes, vec, st);
    case 6418: return repro::launch<64, 1, 8>(p, bsz, smem_bytes, vec, st);
    case 6424: return repro::launch<64, 2, 4>(p, bsz, smem_bytes, vec, st);
    default: return cudaErrorInvalidValue;
  }
}
