// K2's backward for Hopper: the gradient of the bf16 tensor-core forward
// (flash_attention.cu) on the tensor cores, with P recomputed tile by tile
// from each row's log-sum-exp, so that no (Sq, Sk) tensor reaches device
// memory.
//
// Replaces no TPU kernel: the JAX package takes this gradient by XLA's
// autodiff of its grouped attention (src/repro/models/common.py,
// attn_grouped), bf16-operand einsums. The port's other backward, in
// PyTorch ops (kernels/ops.py, FlashAttentionFunction), builds the whole
// (B KV, g Sq, Sk) f32 score matrix a layer and passes over it some eight
// times; it stays for f32 and d = 256 calls and on the CPU.
//
// The maths, with s = q.k scaled by 1/sqrt(d) and log2(e) (base 2, as the
// forward), lse the forward's row log-sum-exp in base 2, D = rowsum(dO o O):
//     P = 2^(s - lse) where the mask keeps (q, k), else 0,
//     dV = P^T dO,   dP = dO V^T,   dS = P o (dP - D),
//     dQ = dS K / sqrt(d),   dK = dS^T Q / sqrt(d),
// dK and dV summed over the g = H / KV q heads of a kv head's group.
//
// What bounds it on the card: operations. hymba-1.5b's layer at 2 x 2,048
// tokens (25 q / 5 kv heads of 64) keeps 1.57 M (q, k) pairs a head in a
// 1,024-token window layer and 2.10 M in a global one; each product over
// them is 2 * 50 * 64 FLOP a pair: 10.1 and 13.4 GFLOP. The two kernels do
// seven (S and dP in each, dV, dK and dQ): 70.5 and 94.0 GFLOP, 71 and 95 us
// at 989 TFLOP/s bf16, against 30 MB of q, k, v, O, dO and the gradients
// (9 us at 3.35 TB/s).
//
// Design. Both kernels are the forward's shape: one CTA of one consumer
// warpgroup and one producer warp, 64-row tiles in swizzled panels fed by
// TMA into a ring of 2-3 stages, wgmma m64n64k16 (m64n32k16 at d 32) with
// f32 sums, mask tests only on the tiles at a mask's edge, tiles the mask
// drops whole never visited (the forward's tests, read from either side).
// Every product takes bf16 operands: q, k, v and dO as they are, P and dS
// rounded from f32 in registers as the A operand, as the forward rounds P
// before PV. LSE, D, the exponentials and dS's arithmetic are f32.
// * dQ (flash_bwd_dq_kernel): one CTA per (q tile, q head, batch), in the
//   forward's order. Its prologue computes D for its 64 rows from O and dO
//   (two threads a row, 16-byte loads) and stores it for the dK/dV kernel.
//   Q and dO stay in shared memory; the producer streams the K and V tiles
//   the rows reach. Per tile: S = Q K^T and dP = dO V^T (both operands in
//   shared memory), P and dS on the accumulator fragments, dQ += dS K with
//   dS from registers and K read transposed, as the forward reads V.
// * dK/dV (flash_bwd_dkv_kernel): one CTA per (key tile, kv head, batch),
//   the first key tiles (the ones every causal row reaches) first. K and V
//   stay in shared memory; the producer streams, head by head of the group
//   and tile by tile, the q tiles that reach the key tile, each with its
//   rows' LSE and D (two 256-byte bulk copies). Per tile: S^T = K Q^T and
//   dP^T = V dO^T, P^T and dS^T on the fragments (a thread's columns are q
//   rows, their LSE and D read from shared memory), dV += P^T dO and
//   dK += dS^T Q with dO and Q read transposed. dK and dV stay in f32
//   registers across the whole group, so the GQA sum needs no atomics.
// No float atomics anywhere and every sum in a fixed order: two calls give
// the same bits. Each gradient is stored once, in bf16, in the model's
// (B, S, N, d) layout.
#include "flash_tc.cuh"

namespace repro {

template <int D>
struct BwdLayout {
  using L = TcLayout<D>;
  static constexpr int STAGES = D <= 64 ? 3 : 2;
  static constexpr int ROWS = 4 * kTcRows;        // a tile's f32 LSE or D, bytes
  // dQ: Q, dO, the K and V rings, the tile's D, mbarriers, 1 KB alignment
  static constexpr int DQ_SMEM = L::TILE * (2 + 2 * STAGES) + ROWS + 8 * (2 * STAGES + 1) + 1024;
  // dK/dV: K, V, the Q and dO rings with their LSE and D, mbarriers, alignment
  static constexpr int DKV_SMEM =
      L::TILE * (2 + 2 * STAGES) + 2 * ROWS * STAGES + 8 * (2 * STAGES + 1) + 1024;
  static constexpr int DQ_MIN_BLOCKS = D <= 32 ? 3 : 2;
  // dK and dV: 2 * D / 2 f32 accumulators a thread beside S^T and dP^T
  static constexpr int DKV_MIN_BLOCKS = D <= 64 ? 2 : 1;
};

struct FlashBwdParams {
  const __nv_bfloat16* o;
  const __nv_bfloat16* dout;
  const float* lse;    // (batch, heads, sq_pad): the forward's row log-sum-exp, base 2
  float* delta;        // (batch, heads, sq_pad): D, written by the dQ kernel
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int64_t os[3], dos[3], dqs[3], dks[3], dvs[3];  // (batch, head, seq) strides, elements
  int heads, kv_heads, batch, sq, sk, sq_pad, q_per_kv;
  float scale, scale_log2;
  int causal, window;
};

// the forward's mask: key kj of query qi is kept
__device__ __forceinline__ bool kept(const FlashBwdParams& p, int qi, int kj) {
  return kj < p.sk && !(p.causal && kj > qi) && !(p.window > 0 && kj <= qi - p.window);
}

// the tile pair (q tile at q0, key tile at k0) holds a masked or missing entry
__device__ __forceinline__ bool edge_pair(const FlashBwdParams& p, int q0, int k0) {
  return q0 + kTcRows > p.sq || k0 + kTcRows > p.sk ||
         (p.causal && k0 + kTcRows - 1 > q0) ||
         (p.window > 0 && k0 <= q0 + kTcRows - 1 - p.window);
}

// zero `acc`, then acc = A B^T over d: A and B two 64-row tiles (K-major)
template <int D>
__device__ __forceinline__ void tile_product(float (&acc)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = TcLayout<D>::k_off(kk);
    wgmma_64_ss(acc, tile_desc<D>(a + off), tile_desc<D>(b + off), kk > 0);
  }
}

// acc[n] += A X over the 64 rows of X: A (64 x 64 rows) bf16 fragments in
// registers, X a 64-row tile read transposed (MN-major), its d columns in
// chunks of 64 (32 at d 32)
template <int D, int NCHUNK, int NO>
__device__ __forceinline__ void rows_product(float (&acc)[NCHUNK][NO], const uint32_t (&a)[4][4],
                                             uint32_t x) {
  using L = TcLayout<D>;
#pragma unroll
  for (int n = 0; n < NCHUNK; ++n) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t desc = tile_desc<D>(x + n * L::PANEL + kk * 16 * L::RB);
      if constexpr (NO == 32)
        wgmma_64_rs(acc[n], a[kk], desc);
      else
        wgmma_32_rs(acc[n], a[kk], desc);
    }
  }
}

// an accumulator fragment rounded to bf16: the A operand of the k16 steps
__device__ __forceinline__ void pack_fragment(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 4; ++h) a[kk][h] = pack_bf16(x[8 * kk + 2 * h], x[8 * kk + 2 * h + 1]);
}

// rows row0 and row0 + 8 of a 64 x D accumulator, times `scale`, in bf16 at
// `base` (row stride `rs`) for rows below `n_rows`
template <int NCHUNK, int NO>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int64_t rs, int row0, int n_rows,
                                           int quad, float scale,
                                           const float (&acc)[NCHUNK][NO]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= n_rows) continue;
    __nv_bfloat16* dst = base + row * rs;
#pragma unroll
    for (int n = 0; n < NCHUNK; ++n)
#pragma unroll
      for (int jb = 0; jb < NO / 4; ++jb)
        *reinterpret_cast<uint32_t*>(dst + n * 64 + jb * 8 + quad * 2) =
            pack_bf16(acc[n][jb * 4 + r * 2] * scale, acc[n][jb * 4 + r * 2 + 1] * scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, BwdLayout<D>::DQ_MIN_BLOCKS)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, const FlashBwdParams p) {
  using L = TcLayout<D>;
  constexpr int NST = BwdLayout<D>::STAGES;
  constexpr int NCHUNK = D >= 64 ? D / 64 : 1;
  constexpr int NO = D >= 64 ? 32 : 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u;
  const uint32_t s_do = s_q + L::TILE;
  const uint32_t s_k = s_do + L::TILE;
  const uint32_t s_v = s_k + NST * L::TILE;
  const uint32_t s_delta = s_v + NST * L::TILE;
  const uint32_t bar_full = s_delta + BwdLayout<D>::ROWS;
  const uint32_t bar_empty = bar_full + 8 * NST;
  const uint32_t bar_q = bar_empty + 8 * NST;
  float* delta_sm = reinterpret_cast<float*>(smem_raw + (s_delta - raw));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_qt = p.heads * p.batch;
  const int qt = gridDim.x / per_qt - 1 - blockIdx.x / per_qt;
  const int head = blockIdx.x % p.heads, b = blockIdx.x / p.heads % p.batch;
  const int g = head / p.q_per_kv;
  const int q0 = qt * kTcRows;
  const int n_kt = (p.sk + kTcRows - 1) / kTcRows;
  const int kt_end = p.causal ? min(n_kt, (q0 + kTcRows - 1) / kTcRows + 1) : n_kt;
  const int first = q0 - p.window - (kTcRows - 1);
  const int kt_begin = (p.window > 0 && first >= 0) ? first / kTcRows + 1 : 0;
  const int n_tiles = max(kt_end - kt_begin, 0);
  const size_t row_base = (size_t(b) * p.heads + head) * p.sq_pad + q0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kTcConsumers);
    }
    mbar_init(bar_q, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kTcConsumers / 32) {
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, 2 * L::TILE);
      for (int pn = 0; pn < L::NPANEL; ++pn) {
        tma_load_4d(s_q + pn * L::PANEL, &tq, bar_q, pn * L::PW, q0, head, b);
        tma_load_4d(s_do + pn * L::PANEL, &tdo, bar_q, pn * L::PW, q0, head, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NST;
        mbar_wait(bar_empty + 8 * s, ((i / NST) & 1) ^ 1);
        mbar_arrive_expect_tx(bar_full + 8 * s, 2 * L::TILE);
        const int k0 = (kt_begin + i) * kTcRows;
        for (int pn = 0; pn < L::NPANEL; ++pn) {
          tma_load_4d(s_k + s * L::TILE + pn * L::PANEL, &tk, bar_full + 8 * s, pn * L::PW, k0,
                      g, b);
          tma_load_4d(s_v + s * L::TILE + pn * L::PANEL, &tv, bar_full + 8 * s, pn * L::PW, k0,
                      g, b);
        }
      }
    }
    return;
  }

  // D of the tile's rows, two threads a row, each over half of d; rows past
  // Sq get 0, so the dK/dV kernel's padding rows add nothing
  {
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const int qi = q0 + r;
    float acc = 0.f;
    if (qi < p.sq) {
      const uint4* orow = reinterpret_cast<const uint4*>(
          p.o + b * p.os[0] + head * p.os[1] + qi * p.os[2] + half * (D / 2));
      const uint4* drow = reinterpret_cast<const uint4*>(
          p.dout + b * p.dos[0] + head * p.dos[1] + qi * p.dos[2] + half * (D / 2));
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const uint4 ov = orow[c], dv = drow[c];
        const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 of = __bfloat1622float2(o2[j]), df = __bfloat1622float2(d2[j]);
          acc = fmaf(of.x, df.x, acc);
          acc = fmaf(of.y, df.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      delta_sm[r] = acc;
      p.delta[row_base + r] = acc;
    }
  }
  named_barrier_sync(1, kTcConsumers);

  const int quad = lane & 3;
  const int row0 = warp * 16 + (lane >> 2);
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse[r] = p.lse[row_base + row0 + 8 * r];
    delta[r] = delta_sm[row0 + 8 * r];
  }
  float dq[NCHUNK][NO];
#pragma unroll
  for (int n = 0; n < NCHUNK; ++n)
#pragma unroll
    for (int i = 0; i < NO; ++i) dq[n][i] = 0.f;

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % NST;
    const uint32_t k_tile = s_k + s * L::TILE, v_tile = s_v + s * L::TILE;
    mbar_wait(bar_full + 8 * s, (i / NST) & 1);

    float sc[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    tile_product<D>(sc, s_q, k_tile);
    tile_product<D>(dp, s_do, v_tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);

    // dS in place of S: this thread's columns are keys k0 + 8 jb + 2 quad + e
    const int k0 = (kt_begin + i) * kTcRows;
    const bool edge = edge_pair(p, q0, k0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + row0 + 8 * r;
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        const int idx = (t >> 1) * 4 + r * 2 + (t & 1);
        float pj = fast_exp2(fmaf(sc[idx], p.scale_log2, -lse[r]));
        if (edge && !kept(p, qi, k0 + (t >> 1) * 8 + quad * 2 + (t & 1))) pj = 0.f;
        sc[idx] = pj * (dp[idx] - delta[r]);
      }
    }
    uint32_t ds[4][4];
    pack_fragment(ds, sc);
#pragma unroll
    for (int n = 0; n < NCHUNK; ++n) fence_regs(dq[n]);
    wgmma_fence();
    rows_product<D>(dq, ds, k_tile);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < NCHUNK; ++n) fence_regs(dq[n]);
    mbar_arrive(bar_empty + 8 * s);
  }

  store_rows(p.dq + b * p.dqs[0] + head * p.dqs[1] + q0 * p.dqs[2], p.dqs[2], row0, p.sq - q0,
             quad, p.scale, dq);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, BwdLayout<D>::DKV_MIN_BLOCKS)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, const FlashBwdParams p) {
  using L = TcLayout<D>;
  constexpr int NST = BwdLayout<D>::STAGES;
  constexpr int ROWS = BwdLayout<D>::ROWS;
  constexpr int NCHUNK = D >= 64 ? D / 64 : 1;
  constexpr int NO = D >= 64 ? 32 : 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_k = (raw + 1023) & ~1023u;
  const uint32_t s_v = s_k + L::TILE;
  const uint32_t s_q = s_v + L::TILE;
  const uint32_t s_do = s_q + NST * L::TILE;
  const uint32_t s_rows = s_do + NST * L::TILE;     // per stage: LSE, then D
  const uint32_t bar_full = s_rows + 2 * ROWS * NST;
  const uint32_t bar_empty = bar_full + 8 * NST;
  const uint32_t bar_kv = bar_empty + 8 * NST;
  const float* rows_sm = reinterpret_cast<const float*>(smem_raw + (s_rows - raw));

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // the first key tiles are the ones every causal row reaches: they start first
  const int per_kt = p.kv_heads * p.batch;
  const int kt = blockIdx.x / per_kt;
  const int kvh = blockIdx.x % p.kv_heads, b = blockIdx.x / p.kv_heads % p.batch;
  const int k0 = kt * kTcRows;
  // the q tiles that reach this key tile: the forward's skip tests turned round
  const int n_qt = p.sq_pad / kTcRows;
  const int qt_begin = p.causal ? kt : 0;
  const int qt_end = p.window > 0 ? min(n_qt, (k0 + kTcRows - 2 + p.window) / kTcRows + 1) : n_qt;
  const int nq = max(qt_end - qt_begin, 0);
  const int n_iter = nq * p.q_per_kv;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kTcConsumers);
    }
    mbar_init(bar_kv, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kTcConsumers / 32) {
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * L::TILE);
      for (int pn = 0; pn < L::NPANEL; ++pn) {
        tma_load_4d(s_k + pn * L::PANEL, &tk, bar_kv, pn * L::PW, k0, kvh, b);
        tma_load_4d(s_v + pn * L::PANEL, &tv, bar_kv, pn * L::PW, k0, kvh, b);
      }
      // the group's q heads in order, each over its q tiles in order
      for (int i = 0; i < n_iter; ++i) {
        const int s = i % NST;
        mbar_wait(bar_empty + 8 * s, ((i / NST) & 1) ^ 1);
        mbar_arrive_expect_tx(bar_full + 8 * s, 2 * L::TILE + 2 * ROWS);
        const int head = kvh * p.q_per_kv + i / nq;
        const int q0 = (qt_begin + i % nq) * kTcRows;
        for (int pn = 0; pn < L::NPANEL; ++pn) {
          tma_load_4d(s_q + s * L::TILE + pn * L::PANEL, &tq, bar_full + 8 * s, pn * L::PW, q0,
                      head, b);
          tma_load_4d(s_do + s * L::TILE + pn * L::PANEL, &tdo, bar_full + 8 * s, pn * L::PW,
                      q0, head, b);
        }
        const size_t row = (size_t(b) * p.heads + head) * p.sq_pad + q0;
        bulk_load(s_rows + s * 2 * ROWS, p.lse + row, ROWS, bar_full + 8 * s);
        bulk_load(s_rows + s * 2 * ROWS + ROWS, p.delta + row, ROWS, bar_full + 8 * s);
      }
    }
    return;
  }

  // this thread's accumulator rows are keys k0 + row0 and k0 + row0 + 8; its
  // columns (of S^T and dP^T) q rows 8 jb + 2 quad + {0, 1} of the q tile
  const int quad = lane & 3;
  const int row0 = warp * 16 + (lane >> 2);
  float dk[NCHUNK][NO], dv[NCHUNK][NO];
#pragma unroll
  for (int n = 0; n < NCHUNK; ++n)
#pragma unroll
    for (int i = 0; i < NO; ++i) dk[n][i] = dv[n][i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int i = 0; i < n_iter; ++i) {
    const int s = i % NST;
    const uint32_t q_tile = s_q + s * L::TILE, do_tile = s_do + s * L::TILE;
    const float* lse = rows_sm + s * 2 * kTcRows;
    const float* delta = lse + kTcRows;
    mbar_wait(bar_full + 8 * s, (i / NST) & 1);

    float st[32], dpt[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    tile_product<D>(st, s_k, q_tile);
    tile_product<D>(dpt, s_v, do_tile);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);

    // P^T in place of S^T, dS^T in place of dP^T
    const int q0 = (qt_begin + i % nq) * kTcRows;
    const bool edge = edge_pair(p, q0, k0);
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {
      const int c = jb * 8 + quad * 2;
      const float2 l2 = *reinterpret_cast<const float2*>(lse + c);
      const float2 d2 = *reinterpret_cast<const float2*>(delta + c);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int kj = k0 + row0 + 8 * r;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = jb * 4 + r * 2 + e;
          const int qi = q0 + c + e;
          float pt = fast_exp2(fmaf(st[idx], p.scale_log2, -(e ? l2.y : l2.x)));
          if (edge && !(qi < p.sq && kept(p, qi, kj))) pt = 0.f;
          st[idx] = pt;
          dpt[idx] = pt * (dpt[idx] - (e ? d2.y : d2.x));
        }
      }
    }
    uint32_t pa[4][4], ds[4][4];
    pack_fragment(pa, st);
    pack_fragment(ds, dpt);
#pragma unroll
    for (int n = 0; n < NCHUNK; ++n) {
      fence_regs(dv[n]);
      fence_regs(dk[n]);
    }
    wgmma_fence();
    rows_product<D>(dv, pa, do_tile);
    rows_product<D>(dk, ds, q_tile);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < NCHUNK; ++n) {
      fence_regs(dv[n]);
      fence_regs(dk[n]);
    }
    mbar_arrive(bar_empty + 8 * s);
  }

  store_rows(p.dk + b * p.dks[0] + kvh * p.dks[1] + k0 * p.dks[2], p.dks[2], row0, p.sk - k0,
             quad, p.scale, dk);
  store_rows(p.dv + b * p.dvs[0] + kvh * p.dvs[1] + k0 * p.dvs[2], p.dvs[2], row0, p.sk - k0,
             quad, 1.f, dv);
}

template <typename K>
static cudaError_t allow_smem(K kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <int D>
static cudaError_t launch_bwd(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                              const CUtensorMap& tdo, const FlashBwdParams& p,
                              cudaStream_t stream) {
  using B = BwdLayout<D>;
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<D>, B::DQ_SMEM);
  if (err == cudaSuccess) err = allow_smem(flash_bwd_dkv_kernel<D>, B::DKV_SMEM);
  if (err != cudaSuccess) return err;
  // dQ first: its prologue writes the D that the dK/dV kernel reads
  flash_bwd_dq_kernel<D><<<p.sq_pad / kTcRows * p.heads * p.batch, kTcThreads, B::DQ_SMEM,
                           stream>>>(tq, tk, tv, tdo, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int n_kt = (p.sk + kTcRows - 1) / kTcRows;
  flash_bwd_dkv_kernel<D><<<n_kt * p.kv_heads * p.batch, kTcThreads, B::DKV_SMEM, stream>>>(
      tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

}  // namespace repro

// K2's backward: the dQ kernel, then the dK/dV kernel, on the stream.
// strides: 24 int64 values, (batch, head, seq) strides in elements of q, k,
// v, o, dout, dq, dk and dv, each (batch, seq, heads, d) bf16 with its
// head-dim axis contiguous, 16-byte aligned rows (the tensor maps' rule and
// the prologue's 16-byte loads); lse and delta are (b, h, sq_pad) f32 with
// sq_pad the 64-row tiles' rows, lse the training forward's
// (repro_flash_attention_bf16_lse), delta scratch that the dQ kernel fills.
// d is 32, 64 or 128.
extern "C" int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, const float* lse,
                                         float* delta, void* dq, void* dk, void* dv,
                                         const int64_t* strides, int b, int h, int kv, int sq,
                                         int sk, int d, float scale, int causal, int window,
                                         void* stream) {
  if (kv <= 0 || h % kv != 0 || sq <= 0 || sk <= 0) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, tdo;
  if (!repro::encode_tile_map(&tq, q, d, sq, h, b, strides) ||
      !repro::encode_tile_map(&tk, k, d, sk, kv, b, strides + 3) ||
      !repro::encode_tile_map(&tv, v, d, sk, kv, b, strides + 6) ||
      !repro::encode_tile_map(&tdo, dout, d, sq, h, b, strides + 12))
    return cudaErrorInvalidValue;
  repro::FlashBwdParams p;
  p.o = static_cast<const __nv_bfloat16*>(o);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  for (int i = 0; i < 3; ++i) {
    p.os[i] = strides[9 + i];
    p.dos[i] = strides[12 + i];
    p.dqs[i] = strides[15 + i];
    p.dks[i] = strides[18 + i];
    p.dvs[i] = strides[21 + i];
  }
  p.heads = h;
  p.kv_heads = kv;
  p.batch = b;
  p.sq = sq;
  p.sk = sk;
  p.sq_pad = (sq + repro::kTcRows - 1) / repro::kTcRows * repro::kTcRows;
  p.q_per_kv = h / kv;
  p.scale = scale;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.causal = causal;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return repro::launch_bwd<32>(tq, tk, tv, tdo, p, s);
    case 64: return repro::launch_bwd<64>(tq, tk, tv, tdo, p, s);
    case 128: return repro::launch_bwd<128>(tq, tk, tv, tdo, p, s);
    default: return cudaErrorInvalidValue;
  }
}
