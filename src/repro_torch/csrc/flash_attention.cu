// Forward attention with causal and sliding-window masks and GQA, for Hopper:
// two hand-written kernels, chosen by element type.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel): online softmax over key tiles, f32
// accumulator and row statistics, masked scores set to -1e30, fully masked
// tiles skipped, output acc / max(l, 1e-30) rounded to nearest even in q's
// type. GQA is by index: q head h reads kv head h / q_per_kv, with no
// repeated K/V in memory. Tensors are read through their strides, so the
// model's (B, S, H, d) layout needs no transpose copy, and any length works:
// rows past Sq are not stored and keys past Sk weigh 0 (the TPU kernel
// asserts divisibility instead).
//
// What bounds it on the card. llama-13b's 32-token prefill (B 1, H = KV =
// 40, d 128) moves 4*B*H*S*d*2 bytes = 1.3 MB and does 4*d*B*H*S(S+1)/2 =
// 10.8 MFLOP: bytes bound it (0.39 us), and at that size launch latency and
// the first loads' latency bound both. hymba-1.5b's 2,048-token prefill
// (B 1, 25 q / 5 kv heads, d 64) does 13.4 GFLOP in a global layer and 10.1
// in a 1,024-token window layer against 15.7 MB: the tensor cores bound it
// (13.6 and 10.2 us at 989 TFLOP/s bf16), and f32 CUDA cores could not go
// below 13.4 GFLOP / 67 TFLOP/s = 200 us.
//
// bf16: the tensor cores (flash_tc_kernel). One CTA per (64-row q tile, q
// head, batch): one consumer warpgroup and one producer warp. The producer
// fills a ring of 2-3 stages of K and V tiles (64 keys) in shared memory
// with TMA (cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPointByVersion, so nothing links libcuda), completion
// counted in bytes on an mbarrier per stage; the consumers free a stage on
// a second mbarrier. Tiles are stored in panels of 64 columns (32 at d 32)
// with the 128-byte (64-byte) swizzle that wgmma reads without bank
// conflicts. S = Q K^T is wgmma m64n64k16 with both operands in shared
// memory, summed in f32. The online softmax runs on the accumulator
// fragments in registers, in base 2 with the scale folded into the
// exponent's FMA: a row's 64 scores lie on the 4 threads of a quad, so its
// max takes two shuffles per tile and its sum two at the end. P is rounded to bf16 in registers and is the A operand of
// wgmma m64n64k16 (m64n32k16 at d 32) against the V tile, which is read
// transposed from the same layout; the output stays in f32 registers,
// rescaled by alpha per tile. Masks are applied only on the tiles that need
// them (the causal diagonal, the window's edge, the ragged end). Q arrives
// once by TMA; out-of-range rows and keys arrive as zeros. The grid is one
// dimension, every head's last q tile first: the longest causal rows start
// first and the short ones fill the tail. The training forward is the
// instantiation kLse = true of the same kernel: it also stores each row's
// log-sum-exp (base 2, f32), from which the backward kernels
// (flash_attention_bwd.cu) recompute P; the serving prefill launches
// kLse = false, whose code has no such store.
//
// f32: the CUDA cores (flash_f32_kernel). The tensor cores take f32 only
// rounded to tf32 (about 1e-3 relative), which would break the f32 checks
// (1e-4 normwise over two layers, 2e-5 per element), so f32 keeps this
// kernel: one block of 4 warps per (q tile of 32 rows, head, batch); the
// block keeps its Q tile in shared memory and walks the K/V tiles of 32
// keys in order, skipping tiles wholly above the diagonal or outside the
// window. Each warp owns 8 query rows; lane j scores key j of the tile for
// all 8 rows at once, so the row max and sum are warp shuffles, and each
// lane accumulates d/32 output columns of the 8 rows, reusing each V load 8
// times. K rows are padded by one float in shared memory so the 32 lanes
// read 32 banks.
#include "flash_tc.cuh"

namespace repro {

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------
struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t qs[3], ks[3], vs[3], os[3];  // strides of axes (batch, head, seq)
  int sq, sk, q_per_kv;
  float scale;
  int causal, window;
};

constexpr int kFlashBQ = 32;
constexpr int kFlashBK = 32;
constexpr int kFlashWarps = 4;

template <int D>
constexpr int flash_smem_bytes() {
  return (kFlashBQ * D + kFlashBK * (D + 1) + kFlashBK * D) * 4;
}

template <int D>
__global__ void __launch_bounds__(kFlashWarps * 32)
flash_f32_kernel(const FlashParams p) {
  constexpr int BQ = kFlashBQ, BK = kFlashBK;
  constexpr int RPW = BQ / kFlashWarps;  // query rows per warp
  constexpr int CPL = D / 32;            // output columns per lane
  constexpr int KSTRIDE = D + 1;
  extern __shared__ float smem[];
  float* s_q = smem;                  // BQ x D
  float* s_k = s_q + BQ * D;          // BK x (D + 1)
  float* s_v = s_k + BK * KSTRIDE;    // BK x D

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int qt = blockIdx.x, head = blockIdx.y, b = blockIdx.z;
  const int g = head / p.q_per_kv;
  const float* q = static_cast<const float*>(p.q) + b * p.qs[0] + head * p.qs[1];
  const float* k = static_cast<const float*>(p.k) + b * p.ks[0] + g * p.ks[1];
  const float* v = static_cast<const float*>(p.v) + b * p.vs[0] + g * p.vs[1];
  float* o = static_cast<float*>(p.o) + b * p.os[0] + head * p.os[1];
  const int q0 = qt * BQ;

#pragma unroll 8
  for (int idx = threadIdx.x; idx < BQ * D; idx += kFlashWarps * 32) {
    const int r = idx / D, c = idx % D;
    s_q[idx] = q0 + r < p.sq ? (q[(q0 + r) * p.qs[2] + c]) : 0.f;
  }

  float acc[RPW][CPL];
  float m[RPW], l[RPW];
#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int t = 0; t < CPL; ++t) acc[rr][t] = 0.f;
  }

  const int n_kt = (p.sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    // skip tiles strictly above the causal diagonal / strictly outside the
    // window (the same test as the TPU kernel; uniform across the block)
    if (p.causal && k0 > q0 + BQ - 1) continue;
    if (p.window > 0 && k0 + BK - 1 <= q0 - p.window) continue;

    __syncthreads();  // the previous tile is no longer read
#pragma unroll 8
    for (int idx = threadIdx.x; idx < BK * D; idx += kFlashWarps * 32) {
      const int r = idx / D, c = idx % D;
      const bool in = k0 + r < p.sk;
      s_k[r * KSTRIDE + c] = in ? (k[(k0 + r) * p.ks[2] + c]) : 0.f;
      s_v[idx] = in ? (v[(k0 + r) * p.vs[2] + c]) : 0.f;
    }
    __syncthreads();

    const int kj = k0 + lane;
    const bool exists = kj < p.sk;
    // scores of the warp's RPW rows against key `lane`: one K load feeds
    // RPW independent FMA chains
    const float* krow = s_k + lane * KSTRIDE;
    const float* qrows = s_q + warp * RPW * D;
    float sc[RPW];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) sc[rr] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float kc = krow[c];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) sc[rr] = fmaf(qrows[rr * D + c], kc, sc[rr]);
    }
    float pj[RPW];
#pragma unroll
    for (int rr = 0; rr < RPW; ++rr) {
      const int qi = q0 + warp * RPW + rr;
      float s = sc[rr] * p.scale;
      bool keep = true;
      if (p.causal) keep = kj <= qi;
      if (p.window > 0) keep = keep && kj > qi - p.window;
      if (!keep) s = kNegInf;

      const float m_cur = warp_max(exists ? s : kNegInf);
      const float m_new = fmaxf(m[rr], m_cur);
      const float alpha = expf(m[rr] - m_new);
      pj[rr] = exists ? expf(s - m_new) : 0.f;
      l[rr] = l[rr] * alpha + warp_sum(pj[rr]);
      m[rr] = m_new;
#pragma unroll
      for (int t = 0; t < CPL; ++t) acc[rr][t] *= alpha;
    }
    // PV: each V load is reused by the warp's RPW rows
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float vv[CPL];
#pragma unroll
      for (int t = 0; t < CPL; ++t) vv[t] = s_v[j * D + lane + 32 * t];
#pragma unroll
      for (int rr = 0; rr < RPW; ++rr) {
        const float pb = __shfl_sync(0xffffffffu, pj[rr], j);
#pragma unroll
        for (int t = 0; t < CPL; ++t) acc[rr][t] = fmaf(pb, vv[t], acc[rr][t]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < RPW; ++rr) {
    const int qi = q0 + warp * RPW + rr;
    if (qi >= p.sq) continue;
    const float inv = 1.f / fmaxf(l[rr], 1e-30f);
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      o[qi * p.os[2] + lane + 32 * t] = acc[rr][t] * inv;
    }
  }
}


template <int D>
static cudaError_t launch_f32(const FlashParams& p, int b, int h, cudaStream_t stream) {
  constexpr int kSmem = flash_smem_bytes<D>();
  // above 48 KB dynamic shared memory needs an opt-in, which is per device:
  // set it on every launch (a cheap host call), not once per process
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.sq + kFlashBQ - 1) / kFlashBQ, h, b);
  flash_f32_kernel<D><<<grid, kFlashWarps * 32, kSmem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
struct FlashTcParams {
  void* o;
  int64_t os[3];       // strides of o's axes (batch, head, seq)
  int heads, batch, sq, sk, q_per_kv;
  float scale_log2;    // 1/sqrt(d) * log2(e): the softmax runs in base 2
  int causal, window;
  float* lse;          // training only: (batch, heads, 64-row tiles * 64) f32, each row's
                       // log-sum-exp in base 2 of its scaled scores, for the backward
};

// The online softmax of one 64 x 64 score tile on the accumulator
// fragments, in base 2: this thread holds columns 8 jb + 2 quad + {0, 1} of
// rows qi and qi + 8, and the other three threads of its quad the rest of
// those rows. Leaves P in `sc`, the rescale of the running output in
// `alpha`. Inner tiles take the scale into the exponent's FMA; tiles on a
// mask's edge (EDGE) scale first and mask to -1e30 as the TPU kernel does,
// keys past Sk to weight 0.
template <bool EDGE>
__device__ __forceinline__ void softmax_tile(float (&sc)[32], float (&m_run)[2], float (&l_run)[2],
                                             float (&alpha)[2], const FlashTcParams& p, int k0,
                                             int qi0, int quad) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qi0 + 8 * r;
    float x[16];
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int jb = t >> 1, e = t & 1;
      x[t] = sc[jb * 4 + r * 2 + e];
      if (EDGE) {
        const int kj = k0 + jb * 8 + quad * 2 + e;
        x[t] *= p.scale_log2;
        if (kj >= p.sk)
          x[t] = __int_as_float(0xff800000);  // -inf past the keys: weight 0
        else if ((p.causal && kj > qi) || (p.window > 0 && kj <= qi - p.window))
          x[t] = kNegInf;
      }
    }
    float mx[8];  // the row max as a tree
#pragma unroll
    for (int t = 0; t < 8; ++t) mx[t] = fmaxf(x[t], x[t + 8]);
#pragma unroll
    for (int t = 0; t < 4; ++t) mx[t] = fmaxf(mx[t], mx[t + 4]);
    float m = fmaxf(fmaxf(mx[0], mx[2]), fmaxf(mx[1], mx[3]));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const float m_new = fmaxf(m_run[r], EDGE ? m : m * p.scale_log2);
    alpha[r] = fast_exp2(m_run[r] - m_new);
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const float pj = fast_exp2(EDGE ? x[t] - m_new : fmaf(x[t], p.scale_log2, -m_new));
      sc[(t >> 1) * 4 + r * 2 + (t & 1)] = pj;
      sum[t & 3] += pj;
    }
    // this thread's share of the row sum; the quad adds them up at the end
    l_run[r] = l_run[r] * alpha[r] + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
    m_run[r] = m_new;
  }
}

// kLse, the training forward's instantiation, also stores each row's
// log-sum-exp m + log2(l) (+inf for a row that kept no key, so that the
// backward's P = 2^(s - lse) is 0 there) for every row of its tile, the
// padding past Sq too; the serving prefill launches kLse = false.
template <int D, bool kLse = false>
__global__ void __launch_bounds__(kTcThreads, TcLayout<D>::MIN_BLOCKS)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const FlashTcParams p) {
  using L = TcLayout<D>;
  constexpr int NST = L::STAGES;
  constexpr int KSTEPS = D / 16;                 // k16 steps of S = Q K^T
  constexpr int KPP = L::PW / 16;                // of them in one panel
  constexpr int NCHUNK = D >= 64 ? D / 64 : 1;   // PV products of N = 64 (N = 32 at d 32)
  constexpr int NO = D >= 64 ? 32 : 16;          // accumulator floats per thread per chunk
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s_q = (raw + 1023) & ~1023u;    // swizzle atoms need 1 KB alignment
  const uint32_t s_k = s_q + L::TILE;
  const uint32_t s_v = s_k + NST * L::TILE;
  const uint32_t bar_full = s_v + NST * L::TILE;  // NST of each, 8 bytes apiece
  const uint32_t bar_empty = bar_full + 8 * NST;
  const uint32_t bar_q = bar_empty + 8 * NST;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // blocks run in index order: every head's last q tile (the longest causal
  // rows) first, so the short ones fill the tail
  const int per_qt = p.heads * p.batch;
  const int qt = gridDim.x / per_qt - 1 - blockIdx.x / per_qt;
  const int head = blockIdx.x % p.heads, b = blockIdx.x / p.heads % p.batch;
  const int g = head / p.q_per_kv;
  const int q0 = qt * kTcRows;
  // the key tiles this q tile needs: the TPU kernel's skip tests
  const int n_kt = (p.sk + kTcRows - 1) / kTcRows;
  const int kt_end = p.causal ? min(n_kt, (q0 + kTcRows - 1) / kTcRows + 1) : n_kt;
  const int first = q0 - p.window - (kTcRows - 1);
  const int kt_begin = (p.window > 0 && first >= 0) ? first / kTcRows + 1 : 0;
  const int n_tiles = max(kt_end - kt_begin, 0);

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
    // producer: one lane issues every load
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_q, L::TILE);
      for (int pn = 0; pn < L::NPANEL; ++pn)
        tma_load_4d(s_q + pn * L::PANEL, &tq, bar_q, pn * L::PW, q0, head, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % NST;
        mbar_wait(bar_empty + 8 * s, ((i / NST) & 1) ^ 1);  // a fresh stage passes at once
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

  // consumers: this thread's accumulator rows are row0 and row0 + 8 of the
  // tile; its columns are 8 * jb + 2 * quad + {0, 1} for each 8-column block jb
  const int quad = lane & 3;
  const int row0 = warp * 16 + (lane >> 2);
  float o[NCHUNK][NO];
#pragma unroll
  for (int n = 0; n < NCHUNK; ++n)
#pragma unroll
    for (int i = 0; i < NO; ++i) o[n][i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % NST;
    const uint32_t k_tile = s_k + s * L::TILE, v_tile = s_v + s * L::TILE;
    mbar_wait(bar_full + 8 * s, (i / NST) & 1);

    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const uint32_t off = (kk / KPP) * L::PANEL + (kk % KPP) * 32;
      wgmma_64_ss(sc, wgmma_desc(s_q + off, 8 * L::RB, 8 * L::RB, L::SWIZZLE),
                  wgmma_desc(k_tile + off, 8 * L::RB, 8 * L::RB, L::SWIZZLE), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    const int k0 = (kt_begin + i) * kTcRows;
    const bool edge = k0 + kTcRows > p.sk || (p.causal && k0 + kTcRows - 1 > q0) ||
                      (p.window > 0 && k0 <= q0 + kTcRows - 1 - p.window);
    float alpha[2];
    if (edge)
      softmax_tile<true>(sc, m_run, l_run, alpha, p, k0, q0 + row0, quad);
    else
      softmax_tile<false>(sc, m_run, l_run, alpha, p, k0, q0 + row0, quad);
#pragma unroll
    for (int n = 0; n < NCHUNK; ++n)
#pragma unroll
      for (int jb = 0; jb < NO / 4; ++jb) {
        o[n][jb * 4] *= alpha[0];
        o[n][jb * 4 + 1] *= alpha[0];
        o[n][jb * 4 + 2] *= alpha[1];
        o[n][jb * 4 + 3] *= alpha[1];
      }

    // P in bf16: the S fragment of keys 16 kk .. 16 kk + 15 is the A
    // fragment of the k16 step kk
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int h = 0; h < 4; ++h) pa[kk][h] = pack_bf16(sc[8 * kk + 2 * h], sc[8 * kk + 2 * h + 1]);
#pragma unroll
    for (int n = 0; n < NCHUNK; ++n) fence_regs(o[n]);
    wgmma_fence();
#pragma unroll
    for (int n = 0; n < NCHUNK; ++n) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = wgmma_desc(v_tile + n * L::PANEL + kk * 16 * L::RB, 8 * L::RB,
                                       8 * L::RB, L::SWIZZLE);
        if constexpr (NO == 32)
          wgmma_64_rs(o[n], pa[kk], dv);
        else
          wgmma_32_rs(o[n], pa[kk], dv);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int n = 0; n < NCHUNK; ++n) fence_regs(o[n]);
    mbar_arrive(bar_empty + 8 * s);
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.os[0] + head * p.os[1];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + row0 + 8 * r;
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if constexpr (kLse) {
      if (quad == 0)
        p.lse[(size_t(b) * p.heads + head) * (gridDim.x / per_qt * kTcRows) + qi] =
            l > 0.f ? m_run[r] + log2f(l) : __int_as_float(0x7f800000);
    }
    if (qi >= p.sq) continue;
    l = fmaxf(l, 1e-30f);
    __nv_bfloat16* orow = out + qi * p.os[2];
#pragma unroll
    for (int n = 0; n < NCHUNK; ++n)
#pragma unroll
      for (int jb = 0; jb < NO / 4; ++jb) {
        const int col = n * 64 + jb * 8 + quad * 2;
        *reinterpret_cast<uint32_t*>(orow + col) =
            pack_bf16(o[n][jb * 4 + r * 2] / l, o[n][jb * 4 + r * 2 + 1] / l);
      }
  }
}

template <int D, bool kLse>
static cudaError_t launch_tc(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                             const FlashTcParams& p, int b, int h, cudaStream_t stream) {
  constexpr int kSmem = TcLayout<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc_kernel<D, kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_tc_kernel<D, kLse>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int n_qt = (p.sq + kTcRows - 1) / kTcRows;
  flash_tc_kernel<D, kLse><<<n_qt * h * b, kTcThreads, kSmem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// The bf16 launch behind both entry points: the serving prefill's (lse
// null) and the training forward's.
static int flash_bf16(const void* q, const void* k, const void* v, void* o,
                      const int64_t* strides, int b, int h, int kv, int sq, int sk, int d,
                      float scale, int causal, int window, float* lse, void* stream) {
  if (kv <= 0 || h % kv != 0) return cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!encode_tile_map(&tq, q, d, sq, h, b, strides) ||
      !encode_tile_map(&tk, k, d, sk, kv, b, strides + 3) ||
      !encode_tile_map(&tv, v, d, sk, kv, b, strides + 6))
    return cudaErrorInvalidValue;
  FlashTcParams p;
  p.o = o;
  for (int i = 0; i < 3; ++i) p.os[i] = strides[9 + i];
  p.heads = h;
  p.batch = b;
  p.sq = sq;
  p.sk = sk;
  p.q_per_kv = h / kv;
  p.scale_log2 = scale * 1.4426950408889634f;
  p.causal = causal;
  p.window = window;
  p.lse = lse;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lse != nullptr) {
    switch (d) {
      case 32: return launch_tc<32, true>(tq, tk, tv, p, b, h, s);
      case 64: return launch_tc<64, true>(tq, tk, tv, p, b, h, s);
      case 128: return launch_tc<128, true>(tq, tk, tv, p, b, h, s);
      default: return cudaErrorInvalidValue;  // the backward kernels take d <= 128
    }
  }
  switch (d) {
    case 32: return launch_tc<32, false>(tq, tk, tv, p, b, h, s);
    case 64: return launch_tc<64, false>(tq, tk, tv, p, b, h, s);
    case 128: return launch_tc<128, false>(tq, tk, tv, p, b, h, s);
    case 256: return launch_tc<256, false>(tq, tk, tv, p, b, h, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro

// strides: 12 int64 values, (batch, head, seq) strides of q, k, v and o in
// elements; the head-dim axis of each must be contiguous.
extern "C" int repro_flash_attention_f32(const float* q, const float* k, const float* v,
                                         float* o, const int64_t* strides, int b, int h, int kv,
                                         int sq, int sk, int d, float scale, int causal,
                                         int window, void* stream) {
  if (kv <= 0 || h % kv != 0) return cudaErrorInvalidValue;
  repro::FlashParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.sq = sq;
  p.sk = sk;
  p.q_per_kv = h / kv;
  p.scale = scale;
  p.causal = causal;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return repro::launch_f32<32>(p, b, h, s);
    case 64: return repro::launch_f32<64>(p, b, h, s);
    case 128: return repro::launch_f32<128>(p, b, h, s);
    case 256: return repro::launch_f32<256>(p, b, h, s);
    default: return cudaErrorInvalidValue;
  }
}

// The same interface for bf16, on the tensor cores. Every pointer must be
// 16-byte aligned and every stride of an axis longer than 1 a multiple of 8
// elements (the tensor maps' rule); o is written with 4-byte stores.
extern "C" int repro_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                          const int64_t* strides, int b, int h, int kv, int sq,
                                          int sk, int d, float scale, int causal, int window,
                                          void* stream) {
  return repro::flash_bf16(q, k, v, o, strides, b, h, kv, sq, sk, d, scale, causal, window,
                           nullptr, stream);
}

// The training forward: the same, and each row's log-sum-exp in base 2 into
// lse, (b, h, 64-row tiles * 64) f32, for the backward
// (flash_attention_bwd.cu). d is 32, 64 or 128.
extern "C" int repro_flash_attention_bf16_lse(const void* q, const void* k, const void* v,
                                              void* o, const int64_t* strides, int b, int h,
                                              int kv, int sq, int sk, int d, float scale,
                                              int causal, int window, float* lse,
                                              void* stream) {
  return repro::flash_bf16(q, k, v, o, strides, b, h, kv, sq, sk, d, scale, causal, window, lse,
                           stream);
}
