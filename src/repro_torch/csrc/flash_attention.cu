// Forward attention with causal and sliding-window masks and GQA, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (_flash_kernel): online softmax over key tiles, f32
// accumulator and row statistics, masked scores set to -1e30, fully masked
// tiles skipped, output acc / max(l, 1e-30) in q's type. GQA is by index:
// q head h reads kv head h / q_per_kv, with no repeated K/V in memory.
//
// What bounds it on the card: at the serving path's prefill (B=1, H=KV=40,
// S=32, d=128) it moves 4*B*H*S*d*2 bytes = 1.3 MB and does
// 4*d*B*H*S*(S+1)/2 = 10.8 MFLOP, so bytes bound it (0.39 us against
// 0.011 us at 989 TFLOP/s) and, at that size, launch latency bounds both.
// At long prompts the causal FLOPs grow as S^2 and the tensor cores become
// the limit; this first kernel uses the CUDA cores in f32 and leaves wgmma
// and TMA to later work.
//
// Design: one block of 4 warps per (q tile of 32 rows, head, batch). The
// block keeps its Q tile in shared memory and walks the K/V tiles of 32 keys
// in order (the loop takes the place of the TPU grid's sequential kv axis),
// skipping tiles wholly above the diagonal or outside the window. Each warp
// owns 8 query rows; lane j scores key j of the tile for all 8 rows at once
// (8 independent FMA chains per K load), so the row max and sum are warp
// shuffles, and each lane accumulates d/32 output columns of the 8 rows,
// reusing each V load 8 times. K rows are padded by one float in shared
// memory so the 32 lanes read 32 banks.
// Ragged edges are masked (rows past Sq are not stored, keys past Sk weigh
// 0), so any prompt length works; the TPU kernel asserts divisibility.
// Tensors are read through their strides (last axis contiguous), so the
// model's (B, S, H, d) layout needs no transpose copy.
#include "common.cuh"

namespace repro {

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

template <typename T, int D>
__global__ void __launch_bounds__(kFlashWarps * 32)
flash_kernel(const FlashParams p) {
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
  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + head * p.qs[1];
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + g * p.ks[1];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + g * p.vs[1];
  T* o = static_cast<T*>(p.o) + b * p.os[0] + head * p.os[1];
  const int q0 = qt * BQ;

#pragma unroll 8
  for (int idx = threadIdx.x; idx < BQ * D; idx += kFlashWarps * 32) {
    const int r = idx / D, c = idx % D;
    s_q[idx] = q0 + r < p.sq ? to_f32(q[(q0 + r) * p.qs[2] + c]) : 0.f;
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
      s_k[r * KSTRIDE + c] = in ? to_f32(k[(k0 + r) * p.ks[2] + c]) : 0.f;
      s_v[idx] = in ? to_f32(v[(k0 + r) * p.vs[2] + c]) : 0.f;
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
      o[qi * p.os[2] + lane + 32 * t] = from_f32<T>(acc[rr][t] * inv);
    }
  }
}

template <typename T, int D>
static cudaError_t launch(const FlashParams& p, int b, int h, cudaStream_t stream) {
  constexpr int kSmem = flash_smem_bytes<D>();
  // above 48 KB dynamic shared memory needs an opt-in, which is per device:
  // set it on every launch (a cheap host call), not once per process
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((p.sq + kFlashBQ - 1) / kFlashBQ, h, b);
  flash_kernel<T, D><<<grid, kFlashWarps * 32, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_d(const FlashParams& p, int b, int h, int d,
                              cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(p, b, h, s);
    case 64: return launch<T, 64>(p, b, h, s);
    case 128: return launch<T, 128>(p, b, h, s);
    case 256: return launch<T, 256>(p, b, h, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro

// strides: 12 int64 values, (batch, head, seq) strides of q, k, v and o in
// elements; the head-dim axis of each must be contiguous.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, const int64_t* strides, int b,
                                     int h, int kv, int sq, int sk, int d,
                                     float scale, int causal, int window,
                                     int dtype, void* stream) {
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
  switch (dtype) {
    case repro::kF32: return repro::dispatch_d<float>(p, b, h, d, s);
    case repro::kBF16: return repro::dispatch_d<__nv_bfloat16>(p, b, h, d, s);
    default: return cudaErrorInvalidValue;
  }
}
