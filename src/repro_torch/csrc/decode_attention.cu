// Decode attention for Hopper: one query token per sequence against its KV
// cache, with GQA.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (_decode_kernel): all q heads of one KV group form one
// tile, online softmax across key tiles with f32 statistics, slots at or
// past cache_len masked and tiles wholly past it skipped, output
// acc / max(l, 1e-30) in q's type. cache_len is read on the card from an
// int32 tensor (the TPU kernel's scalar prefetch), so a decode step needs no
// host synchronisation; a cache_len at or past S counts every slot valid.
//
// What bounds it on the card: bytes. Each key of the valid cache is read
// once for its q_per_kv heads: 2 * B * KV * min(len, S) * d * 2 bytes
// against 4 * B * H * min(len, S) * d FLOPs, about q_per_kv operations per
// byte. At the serving path's decode (B=4, KV=40, S=256, d=128, bf16) that
// is 21 MB per layer, 6.3 us at 3.35 TB/s.
//
// Design: one block of 8 warps per (kv head, batch). The block walks the
// valid cache in tiles of 64 keys. Scores: each warp takes 8 whole keys of
// the tile and issues all their loads before reducing (lanes read a K row
// coalesced along d), and a shuffle reduction gives the dot product with
// each of the group's q heads (q in shared memory). Softmax: warp r updates
// head r's max and sum over the tile (two keys per lane). PV: each thread
// owns one output column of every head over 1/G of the tile's keys
// (G = 256 / d key groups, so no thread idles when q_per_kv is 1), reading V
// rows coalesced along d; the G partial sums meet once in shared memory at
// the end. The caches are read in place through their strides, so the
// model's (L, B, S, KV, d) cache needs no transpose copy.
#include "common.cuh"

namespace repro {

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* cache_len;
  int64_t qs[2], os[2];         // strides of q and o axes (batch, head)
  int64_t ks[3], vs[3];         // strides of cache axes (batch, kv head, seq)
  int s, q_per_kv;
  float scale;
};

constexpr int kDecodeThreads = 256;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kDecodeBK = 64;
constexpr int kMaxQPerKV = 8;

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads)
decode_kernel(const DecodeParams p) {
  constexpr int CPL = D / 32;                       // K columns per lane
  constexpr int KPW = kDecodeBK / kDecodeWarps;     // keys per warp per tile
  constexpr int G = kDecodeThreads / D;             // key groups in PV
  __shared__ float s_q[kMaxQPerKV][D];
  __shared__ float s_p[kMaxQPerKV][kDecodeBK];      // scores, then weights
  __shared__ float s_m[kMaxQPerKV], s_l[kMaxQPerKV], s_alpha[kMaxQPerKV];
  __shared__ float s_red[G][kMaxQPerKV][D];         // PV partial sums

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x, b = blockIdx.y;
  const int qpk = p.q_per_kv;
  const int len = *p.cache_len;
  const int n_valid = len < 0 ? 0 : (len < p.s ? len : p.s);

  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + (int64_t)g * qpk * p.qs[1];
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + g * p.ks[1];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + g * p.vs[1];
  T* o = static_cast<T*>(p.o) + b * p.os[0] + (int64_t)g * qpk * p.os[1];

  for (int idx = threadIdx.x; idx < qpk * D; idx += kDecodeThreads) {
    const int r = idx / D, c = idx % D;
    s_q[r][c] = to_f32(q[r * p.qs[1] + c]);
  }
  if (threadIdx.x < kMaxQPerKV) {
    s_m[threadIdx.x] = kNegInf;
    s_l[threadIdx.x] = 0.f;
  }
  // PV: thread owns output column `col` of every head, over the keys
  // j = kg, kg + G, ... of each tile
  const int col = threadIdx.x % D, kg = threadIdx.x / D;
  float acc[kMaxQPerKV];
#pragma unroll
  for (int r = 0; r < kMaxQPerKV; ++r) acc[r] = 0.f;
  __syncthreads();

  for (int k0 = 0; k0 < n_valid; k0 += kDecodeBK) {
    // scores: the warp loads all KPW of its keys first (lanes along d), then
    // reduces each against every head of the group
    float kv[KPW][CPL];
#pragma unroll
    for (int jj = 0; jj < KPW; ++jj) {
      const int kj = k0 + warp + jj * kDecodeWarps;
      const T* krow = k + kj * p.ks[2];
#pragma unroll
      for (int t = 0; t < CPL; ++t) kv[jj][t] = kj < n_valid ? to_f32(krow[lane + 32 * t]) : 0.f;
    }
    for (int r = 0; r < qpk; ++r) {
      float qv[CPL];
#pragma unroll
      for (int t = 0; t < CPL; ++t) qv[t] = s_q[r][lane + 32 * t];
#pragma unroll
      for (int jj = 0; jj < KPW; ++jj) {
        float d = 0.f;
#pragma unroll
        for (int t = 0; t < CPL; ++t) d = fmaf(qv[t], kv[jj][t], d);
        d = warp_sum(d);
        if (lane == 0) s_p[r][warp + jj * kDecodeWarps] = d * p.scale;
      }
    }
    __syncthreads();
    // online softmax: warp r owns head r
    if (warp < qpk) {
      const int r = warp;
      const bool v0 = k0 + lane < n_valid, v1 = k0 + lane + 32 < n_valid;
      const float s0 = v0 ? s_p[r][lane] : kNegInf;
      const float s1 = v1 ? s_p[r][lane + 32] : kNegInf;
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float alpha = expf(m_prev - m_new);
      const float p0 = v0 ? expf(s0 - m_new) : 0.f;
      const float p1 = v1 ? expf(s1 - m_new) : 0.f;
      s_p[r][lane] = p0;
      s_p[r][lane + 32] = p1;
      const float tile_sum = warp_sum(p0 + p1);
      if (lane == 0) {
        s_l[r] = s_l[r] * alpha + tile_sum;
        s_m[r] = m_new;
        s_alpha[r] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMaxQPerKV; ++r) {
      if (r < qpk) acc[r] *= s_alpha[r];
    }
    const int n_tile = min(kDecodeBK, n_valid - k0);
#pragma unroll 4
    for (int j = kg; j < n_tile; j += G) {
      const float vv = to_f32(v[(k0 + j) * p.vs[2] + col]);
#pragma unroll
      for (int r = 0; r < kMaxQPerKV; ++r) {
        if (r < qpk) acc[r] = fmaf(s_p[r][j], vv, acc[r]);
      }
    }
    __syncthreads();  // s_p is rewritten by the next tile
  }

  // reduce the G key groups' partial sums, then normalise
#pragma unroll
  for (int r = 0; r < kMaxQPerKV; ++r) {
    if (r < qpk) s_red[kg][r][col] = acc[r];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < qpk * D; idx += kDecodeThreads) {
    const int r = idx / D, c = idx % D;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < G; ++i) sum += s_red[i][r][c];
    o[r * p.os[1] + c] = from_f32<T>(sum / fmaxf(s_l[r], 1e-30f));
  }
}

template <typename T, int D>
static cudaError_t launch(const DecodeParams& p, int b, int kv, cudaStream_t stream) {
  const dim3 grid(kv, b);
  decode_kernel<T, D><<<grid, kDecodeThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t dispatch_d(const DecodeParams& p, int b, int kv, int d,
                              cudaStream_t s) {
  switch (d) {
    case 32: return launch<T, 32>(p, b, kv, s);
    case 64: return launch<T, 64>(p, b, kv, s);
    case 128: return launch<T, 128>(p, b, kv, s);
    case 256: return launch<T, 256>(p, b, kv, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro

// strides: 10 int64 values in elements: q (batch, head), o (batch, head),
// k cache (batch, kv head, seq), v cache (batch, kv head, seq); the head-dim
// axis of each must be contiguous. cache_len: one int32 on the card.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      void* o, const int* cache_len,
                                      const int64_t* strides, int b, int h,
                                      int kv, int s, int d, float scale,
                                      int dtype, void* stream) {
  if (kv <= 0 || h % kv != 0 || h / kv > repro::kMaxQPerKV) return cudaErrorInvalidValue;
  repro::DecodeParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.cache_len = cache_len;
  p.qs[0] = strides[0];
  p.qs[1] = strides[1];
  p.os[0] = strides[2];
  p.os[1] = strides[3];
  for (int i = 0; i < 3; ++i) {
    p.ks[i] = strides[4 + i];
    p.vs[i] = strides[7 + i];
  }
  p.s = s;
  p.q_per_kv = h / kv;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32: return repro::dispatch_d<float>(p, b, kv, d, st);
    case repro::kBF16: return repro::dispatch_d<__nv_bfloat16>(p, b, kv, d, st);
    default: return cudaErrorInvalidValue;
  }
}
