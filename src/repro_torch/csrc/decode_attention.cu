// Decode attention for Hopper: one query token per sequence against its KV
// cache, with GQA, split over the cache (flash-decoding).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (_decode_kernel): all q heads of one KV group form one
// tile, online softmax across key blocks with f32 statistics, slots at or
// past cache_len masked and blocks wholly past it skipped, output
// acc / max(l, 1e-30) in q's type (0 where cache_len <= 0, as no block
// runs). cache_len is read on the card from an int32 tensor (the TPU
// kernel's scalar prefetch), so a decode step needs no host
// synchronisation; a cache_len at or past S counts every slot valid.
//
// What bounds it on the card: bytes. Each key of the valid cache is read
// once for its q_per_kv heads: 2 * B * KV * min(len, S) * d * 2 bytes
// against 4 * B * H * min(len, S) * d FLOPs, at most q_per_kv (8) operations
// a byte, far below the card's ridge of about 295. llama-13b's decode (B 4,
// KV 40, S 256, d 128, bf16) reads 21 MB per layer, 6.3 us at 3.35 TB/s;
// hymba-1.5b's global layer (B 4, KV 5, S 2,048, d 64) 10.5 MB, 3.1 us. The
// only way to the bound is many bytes in flight on every SM: one block per
// (kv head, batch) gave llama-13b 160 blocks walking 4 tiles in order, and
// hymba-1.5b 20 blocks on 132 SMs.
//
// Design: the grid is (n_split, KV, B); block `split` owns the C cache
// slots [split * C, split * C + C), C chosen by the wrapper so the grid holds
// at least two waves of blocks with at most 32 KB of K and V each
// (decode_attention.py::split_plan). A block reads cache_len, returns at
// once if its chunk starts at or past min(cache_len, S), and otherwise
// issues every 16-byte cp.async of its chunk's K rows, then of its V rows
// (32 KB at C 64, d 128, bf16), before it computes; the scores and the
// softmax wait for K alone. The rows sit 16 bytes apart in shared memory so
// ldmatrix reads them without bank conflicts.
//
// The products. bf16 runs both on the tensor cores with warp-level
// mma.sync m16n8k16 (f32 sums), the group's q heads padded to 8: S^T =
// K Q^T over 16-key tiles, and O^T = V^T P^T over 16-column tiles, V^T
// by transposing ldmatrix loads and P rounded to bf16 (about 2^-9 relative
// per weight; the row sums stay f32). On the CUDA cores the per-head
// arithmetic, not the bytes, bounds the grouped case: on an H100 the f32
// kernel takes 13.6 us over hymba-1.5b's cache with one q head per kv head
// and 25.1 us with its five (attention_sweep.py). f32 stays there all the
// same, since the f32 checks need f32 products (tensor cores take f32 only
// as tf32): lanes split a key's d across 16-byte reads, shuffles sum them,
// and each thread accumulates a column pair of every head over a share of
// the keys. Softmax over the chunk, in f32 for both: warp w takes heads w,
// w + 4. MHA (one q head per kv head) has its own instantiation, with one
// head's registers and loop steps.
//
// The merge. A block whose chunk is the only one writes the output;
// otherwise it writes its partial (m, l, acc) in f32 to the wrapper's
// scratch, and the last block of its (kv head, batch) to finish, found by
// an atomic ticket (release and acquire in one atomic), merges the partials
// in split order (rescaled by exp(m_i - m)), staging them by 16-byte copies
// into its K and V area, and resets the ticket for the next launch. The
// merge is deterministic (no atomics on sums), and a call is one launch.
// The caches are read in place through their strides, so the model's
// (L, B, S, KV, d) cache needs no transpose copy.
#include "common.cuh"
#include "hopper.cuh"

namespace repro {

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* cache_len;
  // scratch: acc [B][KV][n_split][q_per_kv][D], then (m, l) [B][KV][n_split][q_per_kv]
  float* part;
  int* ticket;                  // [B * KV], 0 between launches
  int64_t qs[2], os[2];         // strides of q and o axes (batch, head)
  int64_t ks[3], vs[3];         // strides of cache axes (batch, kv head, seq)
  int s, q_per_kv, chunk, n_split;
  float scale;
};

constexpr int kDecodeThreads = 128;
constexpr int kDecodeWarps = kDecodeThreads / 32;
constexpr int kMaxQPerKV = 8;

// Q: the most q heads per kv head the instantiation serves, 1 (MHA) or
// kMaxQPerKV; it sizes the per-head registers and loops
template <typename T, int D, int Q>
struct DecodeLayout {
  // bf16: the two products on the tensor cores (mma.sync m16n8k16, the
  // group's heads padded to 8); f32: on the CUDA cores
  static constexpr bool TC = sizeof(T) == 2;
  static constexpr int VEC = 16 / sizeof(T);        // elements per 16-byte copy
  static constexpr int CPR = D / VEC;                // copies per cache row
  static constexpr int RS = D + VEC;                 // row stride in shared memory: 16 bytes
                                                     // of padding keep ldmatrix conflict-free
  static constexpr int LPK = CPR < 32 ? CPR : 32;    // f32 scores: lanes per key
  static constexpr int CPL = CPR / LPK;              // ... copies per lane
  static constexpr int KPW = 32 / LPK;               // ... keys per warp pass
  static constexpr int PAIRS = D / 2;                // f32 PV: column pairs
  static constexpr int GROUPS = TC ? 1 : kDecodeThreads / PAIRS;  // PV partial sums per output
  static constexpr int EPT = (Q * D + kDecodeThreads - 1) / kDecodeThreads;  // merged outputs per thread
  // K and V chunks (also the merge's staging area); bf16: the q heads and P
  // (8 rows each, the MMAs' width); per q head: scores, the PV partial sums,
  // m and l, and each split's m and l for the merge. Sized by the call's
  // q_per_kv, so MHA keeps more blocks on an SM.
  static int smem(int chunk, int n_split, int qpk) {
    return 2 * chunk * RS * int(sizeof(T)) + (TC ? 8 * RS * 2 + 8 * (chunk + 8) * 2 : 0) +
           qpk * (chunk * 4 + GROUPS * D * 4 + 2 * 4 + 2 * n_split * 4);
  }
};

// atomicAdd with release and acquire semantics at GPU scope
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;\n" : "=r"(old) : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ void load16(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
}
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }

template <typename T, int D, int Q>
__global__ void __launch_bounds__(kDecodeThreads)
decode_split_kernel(const DecodeParams p) {
  using L = DecodeLayout<T, D, Q>;
  constexpr int RS = L::RS;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int s_last;
  const int C = p.chunk;
  const int PS = C + 8;                                  // row stride of P (bf16)
  T* s_k = reinterpret_cast<T*>(smem);
  T* s_v = s_k + C * RS;
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(s_v + C * RS);  // bf16: [8][RS]
  __nv_bfloat16* s_pb = s_q + (L::TC ? 8 * RS : 0);                      // bf16: [8][PS]
  const int qpk = p.q_per_kv;
  float* s_p = reinterpret_cast<float*>(s_pb + (L::TC ? 8 * PS : 0));  // [qpk][C] scores, then P
  float* s_red = s_p + qpk * C;                        // [GROUPS][qpk][D]
  float* s_m = s_red + L::GROUPS * qpk * D;
  float* s_l = s_m + qpk;
  float* s_mw = s_l + qpk;                             // [n_split][qpk] m, then weights
  float* s_lw = s_mw + p.n_split * qpk;                // [n_split][qpk] l

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g4 = lane >> 2, t4 = lane & 3;             // mma fragment row and column pair
  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int bg = b * gridDim.y + g;
  const int len = *p.cache_len;
  const int n_valid = len < 0 ? 0 : (len < p.s ? len : p.s);
  const int n_active = (n_valid + C - 1) / C;
  T* o = static_cast<T*>(p.o) + b * p.os[0] + int64_t(g) * qpk * p.os[1];
  if (n_active == 0) {  // no valid slot: acc 0 over max(l, 1e-30)
    if (split == 0)
      for (int idx = tid; idx < qpk * D; idx += kDecodeThreads)
        o[(idx / D) * p.os[1] + idx % D] = from_f32<T>(0.f);
    return;
  }
  if (split >= n_active) return;
  const int c0 = split * C;
  const int n_keys = min(C, n_valid - c0);
  const int n16 = (n_keys + 15) & ~15;                 // keys in whole 16-key MMA steps

  // every copy of the chunk first: K, then V
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + g * p.ks[1] + int64_t(c0) * p.ks[2];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + g * p.vs[1] + int64_t(c0) * p.vs[2];
  for (int idx = tid; idx < n_keys * L::CPR; idx += kDecodeThreads) {
    const int r = idx / L::CPR, c = (idx % L::CPR) * L::VEC;
    cp_async16(smem_u32(s_k + r * RS + c), k + r * p.ks[2] + c);
  }
  cp_async_commit();
  for (int idx = tid; idx < n_keys * L::CPR; idx += kDecodeThreads) {
    const int r = idx / L::CPR, c = (idx % L::CPR) * L::VEC;
    cp_async16(smem_u32(s_v + r * RS + c), v + r * p.vs[2] + c);
  }
  cp_async_commit();

  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + int64_t(g) * qpk * p.qs[1];
  // f32: the group's q heads in registers while the copies fly; lane
  // (kl, cl) takes key kl of a pass and holds the columns of copies cl,
  // cl + LPK, ...
  const int kl = lane / L::LPK, cl = lane % L::LPK;
  float qv[L::TC ? 1 : Q][L::CPL * L::VEC];
  if constexpr (L::TC) {
    // the MMAs read 8 heads and whole 16-key steps: q's heads past q_per_kv
    // are 0, V's rows past the chunk's keys are 0 (P is 0 there, and 0 times
    // stale shared memory could be NaN), P is 0 past the keys and heads
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int idx = tid; idx < (n16 - n_keys) * L::CPR; idx += kDecodeThreads)
      *reinterpret_cast<uint4*>(s_v + (n_keys + idx / L::CPR) * RS + (idx % L::CPR) * L::VEC) = zero;
    for (int idx = tid; idx < 8 * D; idx += kDecodeThreads) {
      const int r = idx / D, c = idx % D;
      s_q[r * RS + c] = r < qpk ? q[r * p.qs[1] + c] : __float2bfloat16_rn(0.f);
    }
    for (int idx = tid; idx < 8 * n16; idx += kDecodeThreads) {
      const int r = idx / n16, j = idx % n16;
      if (r >= qpk || j >= n_keys) s_pb[r * PS + j] = __float2bfloat16_rn(0.f);
    }
  } else {
#pragma unroll
    for (int r = 0; r < Q; ++r)
#pragma unroll
      for (int c = 0; c < L::CPL; ++c)
#pragma unroll
        for (int e = 0; e < L::VEC; ++e)
          qv[r][c * L::VEC + e] =
              r < qpk ? to_f32(q[r * p.qs[1] + (cl + c * L::LPK) * L::VEC + e]) : 0.f;
  }
  cp_async_wait<1>();  // K has landed; V may still be in flight
  __syncthreads();

  // scores
  if constexpr (L::TC) {
    // S^T (16 keys x 8 heads) = K (16 keys x d) Q^T (d x 8 heads), warp w
    // taking the 16-key tiles w, w + 4, ...
    uint32_t qb[D / 16][2];
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      ldmatrix_x2(qb[ks], smem_u32(s_q + (lane & 7) * RS + ks * 16 + ((lane >> 3) & 1) * 8));
    for (int mt = warp; mt < n16 / 16; mt += kDecodeWarps) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, smem_u32(s_k + (mt * 16 + (lane & 15)) * RS + ks * 16 + (lane >> 4) * 8));
        mma_16816(c, a, qb[ks]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // c[e] is key mt * 16 + g4 (+8), head 2 t4 (+1)
        const int j = mt * 16 + g4 + (e >> 1) * 8, r = 2 * t4 + (e & 1);
        if (r < qpk && j < n_keys) s_p[r * C + j] = c[e] * p.scale;
      }
    }
  } else {
    for (int j0 = warp * L::KPW; j0 < n_keys; j0 += kDecodeWarps * L::KPW) {
      const int j = j0 + kl;
      float dot[Q];
#pragma unroll
      for (int r = 0; r < Q; ++r) dot[r] = 0.f;
      if (j < n_keys) {
#pragma unroll
        for (int c = 0; c < L::CPL; ++c) {
          float kf[L::VEC];
          load16(reinterpret_cast<const float*>(s_k) + j * RS + (cl + c * L::LPK) * L::VEC, kf);
#pragma unroll
          for (int r = 0; r < Q; ++r) {
            if (r < qpk) {
#pragma unroll
              for (int e = 0; e < L::VEC; ++e) dot[r] = fmaf(qv[r][c * L::VEC + e], kf[e], dot[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < Q; ++r) {
        if (r >= qpk) break;
#pragma unroll
        for (int off = L::LPK / 2; off > 0; off >>= 1)
          dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
        if (cl == 0 && j < n_keys) s_p[r * C + j] = dot[r] * p.scale;
      }
    }
  }
  __syncthreads();

  // softmax over the chunk; every slot in it is valid
  for (int r = warp; r < qpk; r += kDecodeWarps) {
    float mx = kNegInf;
    for (int j = lane; j < n_keys; j += 32) mx = fmaxf(mx, s_p[r * C + j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < n_keys; j += 32) {
      const float e = expf(s_p[r * C + j] - mx);
      if constexpr (L::TC)
        s_pb[r * PS + j] = __float2bfloat16_rn(e);
      else
        s_p[r * C + j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      s_m[r] = mx;
      s_l[r] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // PV
  if constexpr (L::TC) {
    // O^T (16 columns x 8 heads) = V^T (16 columns x keys) P^T (keys x 8
    // heads), warp w taking the 16-column tiles w, w + 4, ...: V^T by
    // transposing loads of V's rows
    for (int mt = warp; mt < D / 16; mt += kDecodeWarps) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int ks = 0; ks < n16 / 16; ++ks) {
        uint32_t a[4], pb[2];
        ldmatrix_x4_trans(a, smem_u32(s_v + (ks * 16 + (lane & 7) + ((lane >> 4) << 3)) * RS +
                                      mt * 16 + ((lane >> 3) & 1) * 8));
        ldmatrix_x2(pb, smem_u32(s_pb + (lane & 7) * PS + ks * 16 + ((lane >> 3) & 1) * 8));
        mma_16816(c, a, pb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {  // c[e] is column mt * 16 + g4 (+8), head 2 t4 (+1)
        const int r = 2 * t4 + (e & 1);
        if (r < qpk) s_red[r * D + mt * 16 + g4 + (e >> 1) * 8] = c[e];
      }
    }
  } else {
    // column pair pc of every head over keys kg, kg + GROUPS, ...
    const int pc = tid % L::PAIRS, kg = tid / L::PAIRS;
    const float* vf = reinterpret_cast<const float*>(s_v);
    float a0[Q], a1[Q];
#pragma unroll
    for (int r = 0; r < Q; ++r) a0[r] = a1[r] = 0.f;
    for (int j = kg; j < n_keys; j += L::GROUPS) {
      const float2 vv = load2(vf + j * RS + 2 * pc);
#pragma unroll
      for (int r = 0; r < Q; ++r) {
        if (r < qpk) {
          const float w = s_p[r * C + j];
          a0[r] = fmaf(w, vv.x, a0[r]);
          a1[r] = fmaf(w, vv.y, a1[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < Q; ++r) {
      if (r < qpk) {
        s_red[(kg * qpk + r) * D + 2 * pc] = a0[r];
        s_red[(kg * qpk + r) * D + 2 * pc + 1] = a1[r];
      }
    }
  }
  __syncthreads();

  const int64_t slot = (int64_t(bg) * p.n_split + split) * qpk;  // this block's partial
  float* part_acc = p.part;
  float* part_ml = p.part + int64_t(gridDim.z) * gridDim.y * p.n_split * qpk * D;
  for (int idx = tid; idx < qpk * D; idx += kDecodeThreads) {
    const int r = idx / D, c = idx % D;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < L::GROUPS; ++i) acc += s_red[(i * qpk + r) * D + c];
    if (n_active == 1)
      o[r * p.os[1] + c] = from_f32<T>(acc / fmaxf(s_l[r], 1e-30f));
    else
      part_acc[(slot + r) * D + c] = acc;
  }
  if (n_active == 1) return;
  if (tid < qpk) {
    part_ml[(slot + tid) * 2] = s_m[tid];
    part_ml[(slot + tid) * 2 + 1] = s_l[tid];
  }
  // publish the partial and take a ticket: the barrier orders the block's
  // writes before thread 0's release, and the last block acquires the other
  // blocks' partials by the same atomic
  __syncthreads();
  if (tid == 0) s_last = atomic_add_acq_rel(p.ticket + bg, 1) == n_active - 1;
  __syncthreads();
  if (!s_last) return;

  // merge. The partial sums are staged by 16-byte copies into the K and V
  // area, as many splits a round as it holds, the first round in flight
  // while every split's m and l are read and each head's weights
  // exp(m_i - m) are worked out; then each output element sums acc_i and
  // l_i times its weight in split order.
  const int64_t first = int64_t(bg) * p.n_split * qpk;  // split 0's slot
  float* stage = reinterpret_cast<float*>(smem);
  const int per_split = qpk * D;                        // floats
  const int splits_per_round = (2 * C * RS * int(sizeof(T))) / (per_split * 4);
  auto stage_round = [&](int i0) {
    const int n = min(splits_per_round, n_active - i0);
    const float* src = part_acc + (first + int64_t(i0) * qpk) * D;
    for (int off = tid * 4; off < n * per_split; off += kDecodeThreads * 4)
      cp_async16(smem_u32(stage + off), src + off);
    cp_async_commit();
  };
  stage_round(0);
  for (int idx = tid; idx < n_active * qpk; idx += kDecodeThreads) {
    const int i = idx / qpk, r = idx % qpk;
    s_mw[idx] = __ldcg(part_ml + (first + idx) * 2);  // idx = i * qpk + r
    s_lw[idx] = __ldcg(part_ml + (first + idx) * 2 + 1);
  }
  __syncthreads();
  for (int r = warp; r < qpk; r += kDecodeWarps) {
    float mx = kNegInf;
    for (int i = lane; i < n_active; i += 32) mx = fmaxf(mx, s_mw[i * qpk + r]);
    mx = warp_max(mx);
    for (int i = lane; i < n_active; i += 32) s_mw[i * qpk + r] = expf(s_mw[i * qpk + r] - mx);
  }
  float acc[L::EPT], lsum[L::EPT];
#pragma unroll
  for (int t = 0; t < L::EPT; ++t) acc[t] = lsum[t] = 0.f;
  for (int i0 = 0; i0 < n_active; i0 += splits_per_round) {
    if (i0 > 0) {
      __syncthreads();  // the last round is summed
      stage_round(i0);
    }
    cp_async_wait<0>();
    __syncthreads();
    const int n = min(splits_per_round, n_active - i0);
#pragma unroll
    for (int t = 0; t < L::EPT; ++t) {
      const int idx = tid + t * kDecodeThreads;
      if (idx < per_split) {
        const int r = idx / D;
        for (int u = 0; u < n; ++u) {
          const float w = s_mw[(i0 + u) * qpk + r];
          acc[t] = fmaf(stage[u * per_split + idx], w, acc[t]);
          lsum[t] = fmaf(s_lw[(i0 + u) * qpk + r], w, lsum[t]);
        }
      }
    }
  }
#pragma unroll
  for (int t = 0; t < L::EPT; ++t) {
    const int idx = tid + t * kDecodeThreads;
    if (idx < per_split)
      o[(idx / D) * p.os[1] + idx % D] = from_f32<T>(acc[t] / fmaxf(lsum[t], 1e-30f));
  }
  if (tid == 0) p.ticket[bg] = 0;  // ready for the next launch
}

template <typename T, int D, int Q>
static cudaError_t launch(const DecodeParams& p, int b, int kv, cudaStream_t stream) {
  const int smem = DecodeLayout<T, D, Q>::smem(p.chunk, p.n_split, p.q_per_kv);
  cudaError_t err = cudaFuncSetAttribute(
      decode_split_kernel<T, D, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(decode_split_kernel<T, D, Q>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.n_split, kv, b);
  decode_split_kernel<T, D, Q><<<grid, kDecodeThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
static cudaError_t dispatch_q(const DecodeParams& p, int b, int kv, cudaStream_t s) {
  return p.q_per_kv == 1 ? launch<T, D, 1>(p, b, kv, s) : launch<T, D, kMaxQPerKV>(p, b, kv, s);
}

template <typename T>
static cudaError_t dispatch_d(const DecodeParams& p, int b, int kv, int d, cudaStream_t s) {
  switch (d) {
    case 32: return dispatch_q<T, 32>(p, b, kv, s);
    case 64: return dispatch_q<T, 64>(p, b, kv, s);
    case 128: return dispatch_q<T, 128>(p, b, kv, s);
    case 256: return dispatch_q<T, 256>(p, b, kv, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace repro

// strides: 10 int64 values in elements: q (batch, head), o (batch, head),
// k cache (batch, kv head, seq), v cache (batch, kv head, seq); the head-dim
// axis of each must be contiguous, the caches 16-byte aligned with a seq
// stride of whole 16-byte copies. cache_len: one int32 on the card. part:
// B * KV * n_split * (h / kv) * (d + 2) floats of scratch; ticket: B * KV
// int32, zero, left zero. chunk: cache slots per block, a multiple of 32;
// n_split = ceil(s / chunk).
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v, void* o,
                                      const int* cache_len, float* part, int* ticket,
                                      const int64_t* strides, int b, int h, int kv, int s,
                                      int d, int chunk, int n_split, float scale, int dtype,
                                      void* stream) {
  if (kv <= 0 || h % kv != 0 || h / kv > repro::kMaxQPerKV || chunk <= 0 || chunk % 32 != 0 ||
      n_split != (s + chunk - 1) / chunk)
    return cudaErrorInvalidValue;
  repro::DecodeParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.cache_len = cache_len;
  p.part = part;
  p.ticket = ticket;
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
  p.chunk = chunk;
  p.n_split = n_split;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case repro::kF32: return repro::dispatch_d<float>(p, b, kv, d, st);
    case repro::kBF16: return repro::dispatch_d<__nv_bfloat16>(p, b, kv, d, st);
    default: return cudaErrorInvalidValue;
  }
}
