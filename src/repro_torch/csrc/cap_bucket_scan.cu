// Cap-bucket scan of the what-if power-cap replay, for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/run_replay.py::cap_bucket_scan
// (_cap_scan_kernel): k[g, b, c] = #{sorted_p[g, b, :] > caps[g, b, c]},
// i.e. Np - bisect_right(row, cap), over float64 rows sorted ascending
// (NaN last, as torch.sort orders them) and front-padded with -inf.
// float64 in, int32 out, exact. A NaN cap counts Np, as the Pallas
// kernel's fixed-trip bisection does (it never moves on a NaN; searchsorted
// counts 0 there).
//
// What bounds it on the card: bytes at best, each row's real samples, each
// distinct cap and each count moved once (a few operations a byte). What
// held the first version back was latency: one thread per (row, cap)
// walked 14 dependent probes through the L2. With the row in shared
// memory the Pallas probe (lo, hi, mid and its guards) is still some 14
// instructions, most on the half-rate integer pipe; the halving below is
// four (an address add, the load, the compare, a select). What is left is
// the shared-memory loads themselves, about 13 a (row, cap) of 8 bytes
// each, and a block's two round trips before its first probe.
//
// Design: a block takes one row and a contiguous tile of its caps (the
// launch plan's `tiles` blocks a row, next to each other in the grid so they
// share the row's trip from HBM). Each thread searches CAPS caps at once (a
// template parameter), so that independent probes are in flight; a warp
// takes 32 neighbouring caps a slot, so caps are read and counts written
// coalesced. The search is the branchless halving
// `pos += t[pos + half] <= cap ? half : 0`, whose halvings depend on the
// length alone, so all lanes of a block take the same ones; on a sorted row
// it gives bisect_right exactly. Two branches, chosen by the plan:
//
// * row (rows that fit in shared memory, up to 29,055 doubles): one probe a
//   thread finds the end of the -inf padding within a step (one global round
//   trip), the row from there on (s0) is staged with 16-byte cp.async (an
//   8-byte copy before the first 16-byte boundary and after the last where
//   needed), and the search runs over the staged part only:
//   k = Np - (s0 + #{row[s0:] <= cap}), or Np for a NaN cap.
// * tree (wider rows): the top `levels` of the search's probe tree, the
//   values the first probes can read, sit in shared memory in breadth-first
//   order (2^levels doubles, gathered once a block); the probes below read
//   the row in global memory. The search runs over the whole row.
//
// The caps are read through their strides (the power-cap evaluator passes
// an [S, C] table expanded over each stream's four buckets with stride 0).
// The plan is computed in Python (kernels/run_replay.py::launch_plan) and
// taken here as given.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {

constexpr int kCapScanMaxThreads = 256;

struct CapScanParams {
  const double* sorted_p;
  const double* caps;
  int32_t* out;
  int64_t rows_per_group, c;
  int64_t caps_stride_group, caps_stride_row, caps_stride_col;
  int n, levels, tiles;
};

// Count of t[0, m) <= cap, for t ascending and m >= 1: the branchless
// halving whose steps depend on m alone, so that every lane of a block
// runs the same ones; CAPS searches interleaved. `at(i)` reads t[i].
template <int CAPS, typename At>
__device__ __forceinline__ void upper_bound(uint32_t (&pos)[CAPS], uint32_t len,
                                            const double (&cap)[CAPS], At at) {
  while (len > 1) {
    const uint32_t half = len >> 1;
#pragma unroll
    for (int g = 0; g < CAPS; ++g) pos[g] += at(pos[g] + half) <= cap[g] ? half : 0u;
    len -= half;
  }
#pragma unroll
  for (int g = 0; g < CAPS; ++g) pos[g] += at(pos[g]) <= cap[g] ? 1u : 0u;
}

// The same over t in shared memory at byte address t0 (len >= 1), each
// search carried as the byte address of its position: a probe is one add,
// one load, one compare and one select. Returns the counts in pos.
template <int CAPS>
__device__ __forceinline__ void upper_bound_shared(uint32_t (&pos)[CAPS], uint32_t t0,
                                                   uint32_t len, const double (&cap)[CAPS]) {
  uint32_t a[CAPS];
#pragma unroll
  for (int g = 0; g < CAPS; ++g) a[g] = t0;
  while (len > 1) {
    const uint32_t half = len >> 1;
    const uint32_t step = half * 8;
#pragma unroll
    for (int g = 0; g < CAPS; ++g) {
      const uint32_t q = a[g] + step;
      a[g] = ld_shared_f64(q) <= cap[g] ? q : a[g];
    }
    len -= half;
  }
#pragma unroll
  for (int g = 0; g < CAPS; ++g)
    pos[g] = ((a[g] - t0) >> 3) + (ld_shared_f64(a[g]) <= cap[g] ? 1u : 0u);
}

template <int CAPS, bool TREE>
__global__ void __launch_bounds__(kCapScanMaxThreads)
cap_bucket_scan_kernel(const CapScanParams p) {
  // row branch: the row from a 16-byte boundary at or below the padding's
  // end (n + 1 doubles at most); tree branch: the probe tree, node j at [j]
  extern __shared__ __align__(16) double smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int64_t row = blockIdx.x / p.tiles;
  const int tile = static_cast<int>(blockIdx.x - row * p.tiles);
  const int n = p.n;
  const double* sp = p.sorted_p + row * static_cast<int64_t>(n);

  // this block's caps: a tile of the row's, in rounds of nt * CAPS; the
  // first round's loads go out before the staging, each next round's
  // before the current round's search
  const int64_t grp = row / p.rows_per_group;
  const int64_t in_grp = row - grp * p.rows_per_group;
  const double* caps = p.caps + grp * p.caps_stride_group + in_grp * p.caps_stride_row;
  int32_t* out = p.out + row * p.c;
  const int64_t per_tile = (p.c + p.tiles - 1) / p.tiles;
  const int64_t c0 = tile * per_tile;
  const int64_t c1 = c0 + per_tile < p.c ? c0 + per_tile : p.c;
  const int64_t round = static_cast<int64_t>(nt) * CAPS;
  double cap[CAPS];
  auto load_caps = [&](int64_t r0, double (&dst)[CAPS]) {
#pragma unroll
    for (int g = 0; g < CAPS; ++g) {
      const int64_t col = r0 + g * nt + tid;
      dst[g] = col < c1 ? caps[col * p.caps_stride_col] : 0.0;
    }
  };
  load_caps(c0, cap);

  int s0 = 0, base = 0;  // row branch: smem[i - base] holds row[i] for i >= s0
  if constexpr (!TREE) {
    // The padding's end, within a step: one probe a thread. Everything
    // below s0 is -inf; what -inf the rest still holds is <= every cap
    // that is not NaN, so the search over row[s0, n) counts it.
    const int step = (n + nt - 1) / nt;
    const int coarse = __syncthreads_count(tid * step < n && sp[tid * step] == -INFINITY);
    s0 = coarse ? (coarse - 1) * step + 1 : 0;
    // Stage row[s0, n): 16-byte copies from the first element on that
    // grid, one 8-byte copy before it and after the last where needed.
    const int mis = (reinterpret_cast<uintptr_t>(sp + s0) & 15) ? 1 : 0;
    base = s0 - mis;
    const int q0 = s0 + mis;
    const int chunks = q0 < n ? (n - q0) / 2 : 0;
    for (int k = tid; k < chunks; k += nt)
      cp_async16(smem_u32(smem + (q0 - base) + 2 * k), sp + q0 + 2 * k);
    cp_async_commit();
    if (tid == 0 && mis && s0 < n) smem[s0 - base] = sp[s0];
    const int last = q0 + 2 * chunks;
    if (tid == nt - 1 && last < n) smem[last - base] = sp[last];
    cp_async_wait<0>();
  } else {
    // node j of the tree holds the probe that the path j's bits (below its
    // top bit, right for 1) leads to
    for (uint32_t j = tid + 1; j < (1u << p.levels); j += nt) {
      uint32_t pos = 0, len = n;
      for (int b = 30 - __clz(j); b >= 0; --b) {
        const uint32_t half = len >> 1;
        if ((j >> b) & 1) pos += half;
        len -= half;
      }
      smem[j] = sp[pos + (len >> 1)];
    }
  }
  __syncthreads();

  for (int64_t r0 = c0; r0 < c1; r0 += round) {
    double next[CAPS];
    load_caps(r0 + round, next);  // past the tile: nothing read
    uint32_t pos[CAPS];
#pragma unroll
    for (int g = 0; g < CAPS; ++g) pos[g] = 0;
    if constexpr (!TREE) {
      // row[s0, n); every entry below s0 is -inf, <= a cap that is not NaN
      if (s0 < n) upper_bound_shared(pos, smem_u32(smem + (s0 - base)), n - s0, cap);
#pragma unroll
      for (int g = 0; g < CAPS; ++g) pos[g] = isnan(cap[g]) ? 0u : s0 + pos[g];
    } else {
      uint32_t node[CAPS], len = n;
#pragma unroll
      for (int g = 0; g < CAPS; ++g) node[g] = 1;
      for (int it = 0; it < p.levels; ++it) {
        const uint32_t half = len >> 1;
#pragma unroll
        for (int g = 0; g < CAPS; ++g) {
          const bool right = smem[node[g]] <= cap[g];
          pos[g] += right ? half : 0u;
          node[g] = 2 * node[g] + (right ? 1u : 0u);
        }
        len -= half;
      }
      // a NaN cap moves no probe: 0
      upper_bound(pos, len, cap, [&](uint32_t i) { return __ldg(sp + i); });
    }
#pragma unroll
    for (int g = 0; g < CAPS; ++g) {
      const int64_t col = r0 + g * nt + tid;
      if (col < c1) out[col] = n - static_cast<int32_t>(pos[g]);
      cap[g] = next[g];
    }
  }
}

template <int CAPS, bool TREE>
static cudaError_t launch(const CapScanParams& p, int64_t blocks, int threads, int smem_bytes,
                          cudaStream_t stream) {
  // room for as many blocks as their shared memory allows
  cudaError_t err = cudaFuncSetAttribute(cap_bucket_scan_kernel<CAPS, TREE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(cap_bucket_scan_kernel<CAPS, TREE>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  cap_bucket_scan_kernel<CAPS, TREE>
      <<<static_cast<unsigned>(blocks), threads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace repro

// The launch plan (kernels/run_replay.py::launch_plan), taken as given:
// `tree` the branch, `levels` of the probe tree staged (tree branch),
// `threads` a block, `caps_per_thread` searched at once, `tiles` blocks a
// row, `smem_bytes` of dynamic shared memory.
extern "C" int repro_cap_bucket_scan(const void* sorted_p, const void* caps, void* out,
                                     int64_t groups, int64_t rows_per_group, int64_t n,
                                     int64_t c, int64_t caps_stride_group,
                                     int64_t caps_stride_row, int64_t caps_stride_col,
                                     int tree, int levels, int threads, int caps_per_thread,
                                     int tiles, int smem_bytes, void* stream) {
  const int64_t rows = groups * rows_per_group;
  if (rows <= 0 || c <= 0 || n <= 0) return cudaSuccess;
  const int64_t blocks = rows * tiles;
  if (tiles < 1 || blocks >= (int64_t(1) << 31) || n >= (int64_t(1) << 31) ||
      threads < 32 || threads > repro::kCapScanMaxThreads || threads % 32 || levels < 0 ||
      levels > 30 || (int64_t(1) << levels) > 2 * n)
    return cudaErrorInvalidValue;
  repro::CapScanParams p;
  p.sorted_p = static_cast<const double*>(sorted_p);
  p.caps = static_cast<const double*>(caps);
  p.out = static_cast<int32_t*>(out);
  p.rows_per_group = rows_per_group;
  p.c = c;
  p.caps_stride_group = caps_stride_group;
  p.caps_stride_row = caps_stride_row;
  p.caps_stride_col = caps_stride_col;
  p.n = static_cast<int>(n);
  p.levels = levels;
  p.tiles = tiles;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (caps_per_thread * 2 + (tree ? 1 : 0)) {
    case 2: return repro::launch<1, false>(p, blocks, threads, smem_bytes, st);
    case 8: return repro::launch<4, false>(p, blocks, threads, smem_bytes, st);
    case 16: return repro::launch<8, false>(p, blocks, threads, smem_bytes, st);
    case 3: return repro::launch<1, true>(p, blocks, threads, smem_bytes, st);
    case 9: return repro::launch<4, true>(p, blocks, threads, smem_bytes, st);
    case 17: return repro::launch<8, true>(p, blocks, threads, smem_bytes, st);
    default: return cudaErrorInvalidValue;
  }
}
