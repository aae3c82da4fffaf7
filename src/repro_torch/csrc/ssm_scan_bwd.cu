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
// What bounds it on the card: operations. Per (row, step, channel) it reads
// u, dt and dy and writes du and ddt (20 bytes); per (row, step, channel,
// state entry) it does ~26 operations (6 to recompute the state, 20 in the
// reverse step). At hymba-1.5b's training shape (B = 2, S = 2,048, I =
// 3,200, N = 16) that is 262 MB (78 us at 3.35 TB/s) and 5.45 GFLOP (81 us
// at the f32 rate of 67 TFLOP/s). The reverse walk needs h_{t-1} at every
// step, and h cannot be run backwards (dividing by dA, which is 0 for a
// large dt, is not allowed), so the states are kept at chunk boundaries and
// each chunk is recomputed: at least two exps per (row, step, channel,
// entry), which at the 16 a clock an SM of the special-function unit take
// ~100 us.
//
// What the first design (one thread a state entry) lost: every step's
// loads of u, dt and dy from shared memory were issued once for each of the
// N entries of a channel; db and dc were summed over a warp's channels by
// shuffles at every step and left as one partial a block of 16 channels and
// step (105 MB at the shape above, summed again by PyTorch); a chunk's
// inputs were staged between two barriers with nothing in flight; and 400
// blocks of 126 registers ran as 1.52 waves on 132 SMs.
//
// This design:
// * A thread owns G in {1, 2, 4} consecutive entries of one (row, channel),
//   so L = N / G lanes hold a channel and a block of 256 threads 256 / L
//   channels (64 at N = 16, G = 4); the launch plan picks G
//   (kernels/ssm_scan.py::backward_plan). One load of u_t, dt_t and dy_t
//   serves G entries, B_t and C_t are read as G-float vectors, and each
//   entry's reverse step is 9 operations. du and ddt (sums over the
//   channel's N entries) are reduce-scattered over its L lanes, L - 1
//   shuffles of two values for L steps.
// * db and dc (sums over channels) are not shuffled at each step: each step
//   a thread stores its G entries' terms in shared memory, and once a chunk
//   the block sums them over all its channels (16-byte loads, a quarter of
//   the channels a lane, the quarters added by two shuffles), one partial a
//   block, step and entry (26 MB at the shape above, 64 channels each).
// * A chunk's inputs (u, dt, dy, B, C, the chunk's kept state and, between
//   segments, its dt prefix) are staged by cp.async into two buffers, the
//   next chunk's copies in flight during this chunk's walk, 16 bytes a copy
//   (the wrapper puts inputs that lie off the 16-byte grid onto it, and pads
//   I to a multiple of 4 with channels of zeros). The staging loops stay
//   rolled and index in 32 bits, as does the rest of the kernel (the wrapper
//   bounds every buffer below 2^31 elements): 64-bit index arithmetic, kept
//   live across the walk, is what made earlier versions of this kernel
//   spill at its 128-register cap.
// * exp(dt a) is one ex2.approx of dt * (a log2 e), a log2 e kept in
//   registers (about 2 ulp; 0 for a large dt). The state is kept every 8
//   steps at G = 4 (105 MB at the shape above), every 16 below; a chunk's
//   states are recomputed into registers and dA_t once more in the reverse
//   step: three exps per (row, step, channel, entry), 0.19 clocks of an SM's
//   special-function unit, where keeping the chunk's dA's would take 8 G
//   more registers a thread and spill. (States kept every 16 steps at G = 4
//   halve the scratch but, at 64 registers of them a thread, were no faster
//   on an H100.)
// * 2 blocks an SM (__launch_bounds__(256, 2); 94 KB of shared memory at
//   N = 16, G = 4). B I / 64 = 100 blocks would leave 32 of 132 SMs idle,
//   so the plan splits S into P in {2, 4, 8} segments, a thread-block cluster
//   of P blocks along S: 8 at the shape above, 800 blocks, which the card
//   balances as they finish. Each segment first walks forward from a zero
//   state (the first from h0), keeping its chunk states and, per entry, the
//   product D of its dA's, its end state and g's local part gl = sum_t
//   (prod_{s <= t} dA_s) c_t dy_t (3 operations a step more, no exp); the
//   cluster composes the carries through its distributed shared memory in
//   segment order (h_in = D h_in' + h_end', g_in = D g_in' + gl', never a
//   division); the reverse walk then adds exp(a * sum dt) h_in to each kept
//   state of a later segment, one exp per chunk and entry: 1/8 exp per (row,
//   step, channel, entry) at G = 4 beyond the three of one segment.
//
// Every sum has a fixed order and no atomics: two calls give the same bits.
// One launch a call; the wrapper sums the blocks' db, dc partials and the
// (row, segment) partials of da.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {

namespace cg = cooperative_groups;

struct SsmBwdParams {
  const float* u;       // (B, S, I), last axis contiguous, 16-byte grid
  const float* dt;      // (B, S, I), as u
  const float* a;       // (I, N) contiguous
  const float* b;       // (B, S, N), last axis contiguous, 16-byte grid
  const float* c;       // (B, S, N), as b
  const float* h0;      // (B, I, N) contiguous, may be null: zeros
  const float* dy;      // (B, S, I) contiguous
  const float* dh_out;  // (B, I, N) contiguous, may be null: zeros
  float* du;            // (B, S, I) contiguous
  float* ddt;           // (B, S, I) contiguous
  float* da_part;       // (B, segments, I, N): each (row, segment)'s share of da
  float* bc_part;       // (2, B, tiles, S, N): each block's share of db, then dc
  float* dh0;           // (B, I, N) contiguous, may be null: not wanted
  float* scratch;       // (B, chunks, I, N): the state entering each chunk
  float* cumdt;         // (B, chunks, I): sum of dt from the segment's start; null for one segment
  int64_t us[2], dts[2], bs[2], cs[2];  // strides of (batch, seq)
  int s, di;            // di a multiple of 4
  int seg_chunks;       // chunks a segment
};

constexpr int kSsmBwdThreads = 256;  // a block (ssm_scan.BWD_THREADS)

// The block of a plan: G entries a thread, L lanes a channel, CH channels,
// chunks of C steps. Shared memory (floats): two staging buffers, then the
// chunk's db and dc terms (one plane of [CH][N] a (step, db | dc), padded by
// N so that neighbouring planes start N banks apart), then its du, ddt. The
// segments' carries reuse the planes. The launch plan's smem_bytes.
template <int N, int G>
struct SsmBwdBlock {
  static constexpr int L = N / G;
  static constexpr int CH = kSsmBwdThreads / L;
  static constexpr int C = G == 4 ? 8 : 16;
  static constexpr int PLANE = CH * N + N;
  // [C][CH] u, dt, dy; [C][N] b, c; [CH][N] the kept state; [CH] the dt prefix
  static constexpr int BUF = C * (3 * CH + 2 * N) + CH * N + CH;
  static constexpr int SMEM_BYTES = 4 * (2 * BUF + 2 * C * PLANE + 2 * C * CH);
  static_assert(C % L == 0, "whole batches of L steps a chunk");
  static_assert(3 * CH * N <= 2 * C * PLANE, "the carries fit in the planes");
};

// G consecutive floats, global -> shared, asynchronously
template <int G>
__device__ __forceinline__ void cp_async_floats(float* dst, const float* src) {
  if constexpr (G == 4) {
    cp_async16(smem_u32(dst), src);
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) cp_async4(smem_u32(dst + g), src + g);
  }
}

template <int N, int G>
__global__ void __launch_bounds__(kSsmBwdThreads, 2)
ssm_scan_bwd_kernel(const SsmBwdParams p) {
  using Blk = SsmBwdBlock<N, G>;
  constexpr int L = Blk::L, CH = Blk::CH, C = Blk::C, PLANE = Blk::PLANE, BUF = Blk::BUF;
  constexpr float kLog2e = 1.4426950408889634f, kLn2 = 0.6931471805599453f;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_bc = smem + 2 * BUF;        // [C][2] planes: db, dc terms of the chunk
  float* s_out = s_bc + 2 * C * PLANE; // [C][CH][2]: du, ddt of the chunk
  float* s_carry = s_bc;               // [3][CH][N]: D, end state, gl, before phase B

  const int row = blockIdx.y;
  const int seg = blockIdx.z;          // the cluster's rank: clusters are (1, 1, segments)
  const int nseg = gridDim.z;
  const bool carry = nseg > 1;
  const int i0 = blockIdx.x * CH;
  const int cl = threadIdx.x / L;      // this thread's channel in the block
  const int lane = threadIdx.x % L;    // and its place among the channel's lanes
  const int n0 = lane * G;             // its first state entry
  const int i = i0 + cl;
  const bool live = i < p.di;
  const int hoff = (row * p.di + i) * N + n0;
  const int chunks = (p.s + C - 1) / C;
  const int k0 = min(chunks, seg * p.seg_chunks);  // the segment's chunks [k0, k1)
  const int k1 = min(chunks, k0 + p.seg_chunks);

  // dead lanes (past I) run on zeros so that every lane takes the shuffles
  float a2[G];                          // a log2 e
  if (live) {
    load_floats<G>(a2, p.a + static_cast<int64_t>(i) * N + n0);
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) a2[g] = 0.f;
  }
#pragma unroll
  for (int g = 0; g < G; ++g) a2[g] *= kLog2e;
  const float* u = p.u + row * p.us[0];
  const float* dt = p.dt + row * p.dts[0];
  const float* bm = p.b + row * p.bs[0];
  const float* cm = p.c + row * p.cs[0];
  const float* dy = p.dy + row * p.s * p.di;

  // chunk k into a buffer: [C][CH] u, dt, dy, [C][N] b, c, and when walking
  // back the chunk's kept state and dt prefix; 16-byte copies (I is a
  // multiple of 4, so a float4 of channels is live or dead as a whole)
  auto stage = [&](float* buf, int k, bool back, bool with_c) {
    const int t0 = k * C, len = min(C, p.s - t0);
    float* bb = buf + 3 * C * CH;
    float* bc = bb + C * N;
    const int arrays = with_c ? 3 : 2;
    // element offsets within this row fit in 32 bits (the wrapper checks)
    const int su = static_cast<int>(p.us[1]), sd = static_cast<int>(p.dts[1]);
    const int sb = static_cast<int>(p.bs[1]), sc = static_cast<int>(p.cs[1]);
    constexpr int Q = CH / 4;                       // float4s a row
#pragma unroll 1
    for (int arr = 0; arr < arrays; ++arr) {
      const float* src = arr == 0 ? u : arr == 1 ? dt : dy;
      const int st = arr == 0 ? su : arr == 1 ? sd : p.di;
#pragma unroll 1
      for (int idx = threadIdx.x; idx < len * Q; idx += kSsmBwdThreads) {
        const int j = idx / Q, x = idx % Q * 4, ii = i0 + x;
        float* dst = buf + arr * C * CH + j * CH + x;
        if (ii < p.di) {
          cp_async16(smem_u32(dst), src + ((t0 + j) * st + ii));
        } else {
          *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
#pragma unroll 1
    for (int idx = threadIdx.x; idx < len * (N / 4); idx += kSsmBwdThreads) {
      const int j = idx / (N / 4), n = idx % (N / 4) * 4, t = t0 + j;
      cp_async16(smem_u32(bb + j * N + n), bm + (t * sb + n));
      if (with_c) cp_async16(smem_u32(bc + j * N + n), cm + (t * sc + n));
    }
    if (back) {
      float* bh = bc + C * N;
      if (live) {
        cp_async_floats<G>(bh + cl * N + n0, p.scratch + ((row * chunks + k) * p.di + i) * N + n0);
      } else {
#pragma unroll
        for (int g = 0; g < G; ++g) bh[cl * N + n0 + g] = 0.f;
      }
      if (seg > 0) {
#pragma unroll 1
        for (int ci = threadIdx.x; ci < CH; ci += kSsmBwdThreads) {
          if (i0 + ci < p.di) {
            cp_async4(smem_u32(bh + CH * N + ci), p.cumdt + (row * chunks + k) * p.di + i0 + ci);
          } else {
            bh[CH * N + ci] = 0.f;
          }
        }
      }
    }
    cp_async_commit();
  };

  // ---- phase A: forward through the segment from its own start, keeping the
  // state entering each chunk (the last chunk's steps are needed only for
  // the carries)
  float h[G], dprod[G], gl[G];
#pragma unroll
  for (int g = 0; g < G; ++g) h[g] = 0.f, dprod[g] = 1.f, gl[g] = 0.f;
  if (seg == 0 && live && p.h0 != nullptr) load_floats<G>(h, p.h0 + hoff);
  float cum = 0.f;
  const int kend = carry ? k1 : k1 - 1;
  if (k0 < kend) stage(smem, k0, false, carry);
  for (int k = k0, cur = 0; k < k1; ++k, cur ^= 1) {
    if (live) store_floats<G>(p.scratch + ((row * chunks + k) * p.di + i) * N + n0, h);
    if (seg > 0 && lane == 0 && live) p.cumdt[(row * chunks + k) * p.di + i] = cum;
    if (k >= kend) break;
    if (k + 1 < kend) {
      stage(smem + (cur ^ 1) * BUF, k + 1, false, carry);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk has landed, from every thread's copies
    const float* s_u = smem + cur * BUF;
    const float* s_dt = s_u + C * CH;
    const float* s_dy = s_dt + C * CH;
    const float* s_b = s_dy + C * CH;
    const float* s_c = s_b + C * N;
    const int len = min(C, p.s - k * C);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      if (j < len) {
        const float dtv = s_dt[j * CH + cl];
        const float dtu = dtv * s_u[j * CH + cl];
        float bt[G];
        load_floats<G>(bt, s_b + j * N + n0);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float e = fast_exp2(dtv * a2[g]);
          h[g] = fmaf(e, h[g], dtu * bt[g]);
          if (carry) dprod[g] *= e;
        }
        if (carry) {
          const float dyv = s_dy[j * CH + cl];
          float ct[G];
          load_floats<G>(ct, s_c + j * N + n0);
#pragma unroll
          for (int g = 0; g < G; ++g) gl[g] = fmaf(dprod[g], ct[g] * dyv, gl[g]);
          cum += dtv;
        }
      }
    }
    __syncthreads();  // this buffer is read before the next stage refills it
  }

  // ---- the segments' carries, composed in segment order through the
  // cluster's shared memory
  float g_[G], hin[G];
#pragma unroll
  for (int g = 0; g < G; ++g) g_[g] = 0.f, hin[g] = 0.f;
  if (live && p.dh_out != nullptr) load_floats<G>(g_, p.dh_out + hoff);
  if (carry) {
    cg::cluster_group cluster = cg::this_cluster();
    const int at = cl * N + n0;
    store_floats<G>(s_carry + at, dprod);
    store_floats<G>(s_carry + CH * N + at, h);
    store_floats<G>(s_carry + 2 * CH * N + at, gl);
    cluster.sync();
    for (int r = 0; r < seg; ++r) {       // h entering this segment
      const float* rem = cluster.map_shared_rank(s_carry, r);
      float dr[G], hr[G];
      load_floats<G>(dr, rem + at);
      load_floats<G>(hr, rem + CH * N + at);
#pragma unroll
      for (int g = 0; g < G; ++g) hin[g] = fmaf(dr[g], hin[g], hr[g]);
    }
    for (int r = nseg - 1; r > seg; --r) {  // g entering it from the end
      const float* rem = cluster.map_shared_rank(s_carry, r);
      float dr[G], gr[G];
      load_floats<G>(dr, rem + at);
      load_floats<G>(gr, rem + 2 * CH * N + at);
#pragma unroll
      for (int g = 0; g < G; ++g) g_[g] = fmaf(dr[g], g_[g], gr[g]);
    }
    cluster.sync();  // every block's carries are read before the planes are reused
  }

  // ---- phase B: reverse, chunk by chunk from the segment's last
  float da[G];
#pragma unroll
  for (int g = 0; g < G; ++g) da[g] = 0.f;
  if (k0 < k1) stage(smem, k1 - 1, true, true);
  for (int k = k1 - 1, cur = 0; k >= k0; --k, cur ^= 1) {
    // the other buffer was last read by the previous chunk, before the
    // barrier that ended its walk: fill it with the next chunk
    if (k > k0) {
      stage(smem + (cur ^ 1) * BUF, k - 1, true, true);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk has landed, from every thread's copies
    const float* s_u = smem + cur * BUF;
    const float* s_dt = s_u + C * CH;
    const float* s_dy = s_dt + C * CH;
    const float* s_b = s_dy + C * CH;
    const float* s_c = s_b + C * N;
    const float* s_h = s_c + C * N;
    const int t0 = k * C, len = min(C, p.s - t0);
    float hs[G];   // the state entering the chunk
    load_floats<G>(hs, s_h + cl * N + n0);
    if (seg > 0) {
      const float cumk = s_h[CH * N + cl];
#pragma unroll
      for (int g = 0; g < G; ++g) hs[g] = fmaf(fast_exp2(a2[g] * cumk), hin[g], hs[g]);
    }
    // the chunk's states h_t, recomputed into registers (dA_t is recomputed
    // again in the reverse step: an exp is cheaper than 8 G registers)
    float hist[C][G];
    {
      float hc[G];
#pragma unroll
      for (int g = 0; g < G; ++g) hc[g] = hs[g];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (j < len) {
          const float dtv = s_dt[j * CH + cl];
          const float dtu = dtv * s_u[j * CH + cl];
          float bt[G];
          load_floats<G>(bt, s_b + j * N + n0);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            hc[g] = fmaf(fast_exp2(dtv * a2[g]), hc[g], dtu * bt[g]);
            hist[j][g] = hc[g];
          }
        }
      }
    }
    // batches of L steps from the chunk's end; a step past the length adds
    // zeros and leaves g as it is
#pragma unroll
    for (int jb = C - L; jb >= 0; jb -= L) {
      float part[L][2];  // per step: sum_n g b, sum_n g (a log2 e) dA h_{t-1}
#pragma unroll
      for (int jj = L - 1; jj >= 0; --jj) {
        const int j = jb + jj;
        float dbv[G], dcv[G];
        part[jj][0] = part[jj][1] = 0.f;
#pragma unroll
        for (int g = 0; g < G; ++g) dbv[g] = dcv[g] = 0.f;
        if (j < len) {
          const float dtv = s_dt[j * CH + cl];
          const float dtu = dtv * s_u[j * CH + cl];
          const float dyv = s_dy[j * CH + cl];
          float bt[G], ct[G];
          load_floats<G>(bt, s_b + j * N + n0);
          load_floats<G>(ct, s_c + j * N + n0);
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float hp = j > 0 ? hist[j > 0 ? j - 1 : 0][g] : hs[g];
            const float dag = fast_exp2(dtv * a2[g]);
            g_[g] = fmaf(ct[g], dyv, g_[g]);
            dcv[g] = dyv * hist[j][g];
            dbv[g] = g_[g] * dtu;
            part[jj][0] = fmaf(g_[g], bt[g], part[jj][0]);
            const float tt = g_[g] * (dag * hp);
            part[jj][1] = fmaf(tt, a2[g], part[jj][1]);
            da[g] = fmaf(tt, dtv, da[g]);
            g_[g] *= dag;
          }
        }
        store_floats<G>(s_bc + (2 * j) * PLANE + cl * N + n0, dbv);
        store_floats<G>(s_bc + (2 * j + 1) * PLANE + cl * N + n0, dcv);
      }
      // over the channel's L lanes: lane l ends with step jb + l
      reduce_scatter<L / 2, 1>(part, lane);
      const int j = jb + lane;
      s_out[(j * CH + cl) * 2] = part[0][0] * s_dt[j * CH + cl];
      s_out[(j * CH + cl) * 2 + 1] = fmaf(part[0][0], s_u[j * CH + cl], part[0][1] * kLn2);
    }
    __syncthreads();  // the chunk's terms are in, and its inputs are read
    // db, dc: one partial over the block's channels a (step, entry). Lanes
    // l and l + 8, l + 16, l + 24 of a warp sum a quarter of the channels each
    // for the same 4 entries (16-byte loads, even and odd channels apart),
    // then add the quarters by two shuffles: a fixed order
    {
      constexpr int Q4 = N / 4, OUT4 = 2 * C * Q4, QCH = CH / 4;
      const int quarter = threadIdx.x % 32 / 8;
      for (int o4 = threadIdx.x / 32 * 8 + threadIdx.x % 8; o4 < OUT4; o4 += kSsmBwdThreads / 4) {
        const int plane = o4 / Q4, n = o4 % Q4 * 4;   // plane 2 j + q
        const float* col = s_bc + plane * PLANE + quarter * QCH * N + n;
        float4 e = make_float4(0.f, 0.f, 0.f, 0.f), od = e;
#pragma unroll 4
        for (int ci = 0; ci < QCH; ci += 2) {
          const float4 x = *reinterpret_cast<const float4*>(col + ci * N);
          const float4 y = *reinterpret_cast<const float4*>(col + (ci + 1) * N);
          e.x += x.x, e.y += x.y, e.z += x.z, e.w += x.w;
          od.x += y.x, od.y += y.y, od.z += y.z, od.w += y.w;
        }
        float4 v = make_float4(e.x + od.x, e.y + od.y, e.z + od.z, e.w + od.w);
#pragma unroll
        for (int o = 8; o <= 16; o *= 2) {
          v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
          v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
          v.z += __shfl_xor_sync(0xffffffffu, v.z, o);
          v.w += __shfl_xor_sync(0xffffffffu, v.w, o);
        }
        const int j = plane / 2, q = plane % 2;
        if (quarter == 0 && j < len) {
          *reinterpret_cast<float4*>(
              p.bc_part + (((q * gridDim.y + row) * gridDim.x + blockIdx.x) * p.s + t0 + j) * N + n) = v;
        }
      }
    }
    for (int idx = threadIdx.x; idx < len * CH; idx += kSsmBwdThreads) {
      const int ii = i0 + idx % CH;
      if (ii < p.di) {
        const int o = (row * p.s + t0 + idx / CH) * p.di + ii;
        p.du[o] = s_out[idx * 2];
        p.ddt[o] = s_out[idx * 2 + 1];
      }
    }
  }
  if (live) {
    store_floats<G>(p.da_part + ((row * nseg + seg) * p.di + i) * N + n0, da);
    if (seg == 0 && p.dh0 != nullptr) store_floats<G>(p.dh0 + hoff, g_);
  }
}

template <int N, int G>
static cudaError_t launch(const SsmBwdParams& p, int bsz, int segments, int smem_bytes,
                          cudaStream_t stream) {
  using Blk = SsmBwdBlock<N, G>;
  if (smem_bytes != Blk::SMEM_BYTES || segments < 1 || segments > 8) return cudaErrorInvalidValue;
  const auto kernel = ssm_scan_bwd_kernel<N, G>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.di + Blk::CH - 1) / Blk::CH, bsz, segments);
  cfg.blockDim = dim3(kSsmBwdThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;  // the segments of a (row, tile)
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = segments;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace repro

// strides: 8 int64 values in elements: (batch, seq) of u, dt, b and c,
// whose last axes are contiguous, whose strides are multiples of 4 and which
// start on the 16-byte grid; I is a multiple of 4. All tensors are float32
// and a is (I, N) contiguous; h0, dh_out and dh0 may be null. The launch
// plan (kernels/ssm_scan.py::backward_plan), taken as given: `group` state
// entries a thread, `segments` along S (a cluster) of `seg_chunks` chunks
// each, and `smem_bytes` of shared memory. The wrapper allocates da_part
// (B, segments, I, N), bc_part (2, B, tiles, S, N), scratch (B, chunks, I,
// N) and, for more than one segment, cumdt (B, chunks, I).
extern "C" int repro_ssm_scan_bwd(const void* u, const void* dt, const void* a,
                                  const void* b, const void* c, const void* h0,
                                  const void* dy, const void* dh_out, void* du, void* ddt,
                                  void* da_part, void* bc_part, void* dh0, void* scratch,
                                  void* cumdt, const int64_t* strides, int bsz, int s, int di,
                                  int n, int group, int segments, int seg_chunks,
                                  int smem_bytes, void* stream) {
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
  p.cumdt = static_cast<float*>(cumdt);
  for (int i = 0; i < 2; ++i) {
    p.us[i] = strides[i];
    p.dts[i] = strides[2 + i];
    p.bs[i] = strides[4 + i];
    p.cs[i] = strides[6 + i];
  }
  p.s = s;
  p.di = di;
  p.seg_chunks = seg_chunks;
  if (seg_chunks < 1 || di % 4 || (segments > 1 && cumdt == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n * 10 + group) {
    case 81: return repro::launch<8, 1>(p, bsz, segments, smem_bytes, st);
    case 82: return repro::launch<8, 2>(p, bsz, segments, smem_bytes, st);
    case 84: return repro::launch<8, 4>(p, bsz, segments, smem_bytes, st);
    case 161: return repro::launch<16, 1>(p, bsz, segments, smem_bytes, st);
    case 162: return repro::launch<16, 2>(p, bsz, segments, smem_bytes, st);
    case 164: return repro::launch<16, 4>(p, bsz, segments, smem_bytes, st);
    default: return cudaErrorInvalidValue;
  }
}
