// Algorithm-1 cooldown chain of the what-if downscale replay, for Hopper.
//
// Replaces a TPU path that is not Pallas: the jitted lax.scan at
// src/repro/whatif/backend.py:479 and the vectorized passes around it in
// _downscale_kernel (backend.py:428). For every stream s and every unique
// (trigger, cooldown) pair c it walks the stream's low-activity runs in
// order, carrying the busy timestamp of the last fired run; a run fires iff
//   valid & len > trig & ts_last >= last_busy + y      (last_busy = -inf
// at first). A fired run resolves its trigger row, max(trig, the
// searchsorted of last_busy + y in the run's timestamps), by the reference's
// 4-probe window, and adds to n_down, n_rest (if not the trailing run), the
// throttled samples and the four clip-saving planes, read from the
// resident-sample and saving prefix tables at the trigger row and the run's
// end.
//
// What bounds it on the card: bytes. Per (s, c) and run the work is a
// compare, and a fired run some 40 operations and 10 gathers; the least
// traffic is the run tables, the prefix tables, the pairs and the seven
// [S, C] results, each moved once, at a few operations per byte, under the
// ~20 per byte at which even the H100's float32 rate would take over. The
// JAX version materialises [K, S, C] int64 and float64 temporaries; this
// kernel keeps the chain, the trigger rows and the sums on chip, so its
// traffic is the inputs and the results.
//
// That bound is far off in practice: the chain is sequential, and each
// fired run costs ten gathers at data-dependent rows. The design keeps the
// chain on chip and takes what it can off it:
//
// * One block per (stream, tile of pairs), stream-major, so one stream's
//   blocks run together and its prefix tables stay in the 50 MB L2. The
//   block stages the stream's run table in shared memory, in chunks of a
//   fixed number of runs (any K), with coalesced loads: s0, len, busy, the
//   trailing flag, each run's last timestamp ts_last, computed once here
//   (NaN for a padded run, which then never compares true), and the five
//   prefix values at the run's end, which every pair that fires the run
//   needs: half the gathers, made once per block instead of once per fire.
// * A group of L lanes (a warp, or a quarter of one where K <= 8) walks
//   one pair's chain a window of L runs at a time. Each lane reads its run
//   of the window from shared memory once: eligible (len > trig), ts_last,
//   and busy + y, the cooldown's end if that run fires. Then, until no lane
//   votes, __ballot_sync(eligible && after the last fire && ts_last >= t)
//   and __ffs give the next fired run, and a shuffle hands its busy + y to
//   the group as the new t. A fire costs a ballot and a shuffle, not a
//   shared-memory round trip; a window with no fire one ballot. These are
//   the same double comparisons in the same run order as the plain
//   version, so the decisions and counts are bit-identical.
// * A fire is handed to one lane of the group (fire i to lane i mod L).
//   When every lane holds one, and at a chunk's end, the lanes resolve
//   their fires' trigger rows and start their five gathers together, so a
//   warp waits for one gather latency per L fires, and other warps walk
//   meanwhile (four blocks of 8 warps an SM, at most 64 registers a thread:
//   squeezing to five or six spills and runs slower). The sums are per lane
//   in fire order, then a fixed xor-shuffle tree over the group:
//   deterministic, and within 1e-9 relative of the reference (only the
//   order of the float sums differs).
//
// The timestamps are fl(ts_first + fl(dt * i)) exactly as StreamIR.ts() and
// the NumPy oracle compute them, so every multiply-add is written with
// __dmul_rn/__dadd_rn, which nvcc never contracts into an FMA (a fused ts
// would move a fire decision by an ulp and break the bit-identical counts).
// The -inf start of last_busy is clipped in double before the int64 cast,
// which would be undefined on -inf. Offsets into the [S, N1] and
// [S, 4, N1] tables are int64.
#include "common.cuh"

namespace repro {

// bytes of shared memory per staged run: s0, len, busy, ts_last, the
// resident-sample and four saving prefixes at the run's end, the trailing flag
constexpr int kRunBytes = 8 + 8 + 8 + 8 + 8 + 4 * 8 + 1;
constexpr int kThreads = 256;            // 8 warps a block
constexpr int kMinBlocks = 4;            // blocks an SM holds: at most 64 registers

template <int L>
__device__ __forceinline__ int64_t group_sum(int64_t v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, static_cast<long long>(v), o);
  return v;
}

template <int L>
__device__ __forceinline__ double group_sum(double v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// L lanes per pair (8 or 32); blockDim.x = kThreads; gridDim.x =
// S * tiles, stream-major; dynamic shared memory = chunk * kRunBytes.
template <int L>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
downscale_chain_kernel(const int64_t* __restrict__ lr_s0,
                       const int64_t* __restrict__ lr_len,
                       const double* __restrict__ lr_busy,
                       const uint8_t* __restrict__ lr_valid,
                       const uint8_t* __restrict__ lr_trail,
                       const int64_t* __restrict__ cum_res,
                       const double* __restrict__ ds_cum,
                       const double* __restrict__ ts_first, double dt,
                       const int64_t* __restrict__ trig,
                       const double* __restrict__ y, int64_t s_dim,
                       int64_t k_dim, int64_t n1, int64_t c_dim, int chunk,
                       int tiles, int64_t* __restrict__ ints,
                       double* __restrict__ flts) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* sh_s0 = reinterpret_cast<int64_t*>(smem);
  int64_t* sh_len = sh_s0 + chunk;
  int64_t* sh_res_e = sh_len + chunk;
  double* sh_busy = reinterpret_cast<double*>(sh_res_e + chunk);
  double* sh_ts = sh_busy + chunk;
  double* sh_ds_e = sh_ts + chunk;                 // [4][chunk]
  uint8_t* sh_trail = reinterpret_cast<uint8_t*>(sh_ds_e + 4 * chunk);

  constexpr int G = 32 / L;                     // pairs per warp
  constexpr unsigned kGroupBits = L == 32 ? 0xffffffffu : (1u << L) - 1u;
  const int64_t s = blockIdx.x / tiles;
  const int tile = blockIdx.x - static_cast<int>(s) * tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = lane / L, gl = lane % L;
  const int64_t c = (static_cast<int64_t>(tile) * (blockDim.x >> 5) + warp) * G + group;
  const bool active = c < c_dim;
  // a pair past C walks with a trigger no run passes, and writes nothing
  const int64_t tr = active ? trig[c] : 0x7fffffffffffffffLL;
  const double yc = active ? y[c] : 0.0;
  const double tsf = ts_first[s];
  const int64_t* res = cum_res + s * n1;
  const double* ds = ds_cum + s * 4 * n1;
  const double qnan = __longlong_as_double(0x7ff8000000000000LL);

  // the cooldown's end, last_busy + y (last_busy = -inf at first)
  double t = __dadd_rn(__longlong_as_double(0xfff0000000000000LL), yc);
  int fires = 0;                 // the group's count (the same in every lane)
  int n_rest = 0;                // this lane's share of the sums
  int64_t thr = 0;
  double sav[4] = {0.0, 0.0, 0.0, 0.0};
  int held = 0;                  // fires handed out since the last batch
  int my_k = 0;                  // this lane's fire: run in the chunk ...
  double my_tcd = 0.0;           // ... and the cooldown end it fired at

  // Resolves the fires the group's lanes hold, one each, and adds their
  // gathers to the lane's sums. Run by every lane of the group together.
  auto batch = [&]() {
    if (gl < held) {
      const int64_t s0 = sh_s0[my_k], len = sh_len[my_k];
      // trigger row: float-predicted crossing, clipped to [0, len] in
      // double, then resolved exactly by 4 probes
      const double rel = __dsub_rn(__ddiv_rn(__dsub_rn(my_tcd, tsf), dt),
                                   static_cast<double>(s0));
      const double lo_f = fmin(fmax(floor(rel) - 1.0, 0.0), static_cast<double>(len));
      const int64_t lo = static_cast<int64_t>(lo_f);
      int64_t cnt = 0;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const double ts_j = __dadd_rn(tsf, __dmul_rn(dt, static_cast<double>(s0 + lo + w)));
        cnt += (lo + w < len) && (ts_j < my_tcd);
      }
      const int64_t g = s0 + (lo + cnt > tr ? lo + cnt : tr);
      const int64_t res_g = res[g];
      double ds_g[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) ds_g[p] = ds[p * n1 + g];
      n_rest += !sh_trail[my_k];
      thr += sh_res_e[my_k] - res_g;
#pragma unroll
      for (int p = 0; p < 4; ++p)
        sav[p] = __dadd_rn(sav[p], __dsub_rn(sh_ds_e[p * chunk + my_k], ds_g[p]));
    }
    held = 0;
  };

  for (int64_t c0 = 0; c0 < k_dim; c0 += chunk) {
    const int n = static_cast<int>(k_dim - c0 < chunk ? k_dim - c0 : chunk);
    __syncthreads();             // every warp is done with the last chunk
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int64_t off = s * k_dim + c0 + i;
      const int64_t s0 = lr_s0[off], len = lr_len[off];
      const bool valid = lr_valid[off];
      sh_s0[i] = s0;
      sh_len[i] = len;
      sh_busy[i] = lr_busy[off];
      sh_ts[i] = valid ? __dadd_rn(tsf, __dmul_rn(dt, static_cast<double>(s0 + len - 1))) : qnan;
      sh_trail[i] = lr_trail[off];
      sh_res_e[i] = valid ? res[s0 + len] : 0;
#pragma unroll
      for (int p = 0; p < 4; ++p) sh_ds_e[p * chunk + i] = valid ? ds[p * n1 + s0 + len] : 0.0;
    }
    __syncthreads();

    // windows of L runs, every group of the warp in step
    for (int k = 0; k < n; k += L) {
      const int r = k + gl;
      const bool in = r < n;
      const bool eligible = in && sh_len[r] > tr;
      const double ts = in ? sh_ts[r] : qnan;
      const double t_if = in ? __dadd_rn(sh_busy[r], yc) : 0.0;   // t if run r fires
      int last = -1;             // the group's last fire in this window
      while (true) {
        const unsigned bal = __ballot_sync(0xffffffffu, eligible && gl > last && ts >= t);
        if (!bal) break;
        const unsigned mine = (bal >> (group * L)) & kGroupBits;
        const int f = mine ? __ffs(static_cast<int>(mine)) - 1 : 0;
        const double t_next = __shfl_sync(0xffffffffu, t_if, group * L + f);
        if (mine) {
          if (gl == held) {
            my_k = k + f;
            my_tcd = t;
          }
          ++held;
          ++fires;
          t = t_next;
          last = f;
          if (held == L) batch();
        }
      }
    }
    if (held) batch();           // the table of this chunk is about to go
  }

  const int64_t rest = group_sum<L>(static_cast<int64_t>(n_rest));
  thr = group_sum<L>(thr);
#pragma unroll
  for (int p = 0; p < 4; ++p) sav[p] = group_sum<L>(sav[p]);
  if (gl == 0 && active) {
    const int64_t lanes = s_dim * c_dim;
    const int64_t idx = s * c_dim + c;
    ints[idx] = fires;
    ints[lanes + idx] = rest;
    ints[2 * lanes + idx] = thr;
#pragma unroll
    for (int p = 0; p < 4; ++p) flts[p * lanes + idx] = sav[p];
  }
}

template <int L>
static cudaError_t launch(const void* lr_s0, const void* lr_len, const void* lr_busy,
                          const void* lr_valid, const void* lr_trail,
                          const void* cum_res, const void* ds_cum,
                          const void* ts_first, double dt, const void* trig,
                          const void* y, int64_t s_dim, int64_t k_dim, int64_t n1,
                          int64_t c_dim, int chunk, int tiles, void* ints, void* flts,
                          cudaStream_t stream) {
  const int64_t blocks = s_dim * tiles;
  const size_t smem = static_cast<size_t>(chunk) * kRunBytes;
  if (blocks >= (int64_t(1) << 31) || smem > 48 * 1024) return cudaErrorInvalidValue;
  downscale_chain_kernel<L><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      static_cast<const int64_t*>(lr_s0), static_cast<const int64_t*>(lr_len),
      static_cast<const double*>(lr_busy), static_cast<const uint8_t*>(lr_valid),
      static_cast<const uint8_t*>(lr_trail), static_cast<const int64_t*>(cum_res),
      static_cast<const double*>(ds_cum), static_cast<const double*>(ts_first), dt,
      static_cast<const int64_t*>(trig), static_cast<const double*>(y), s_dim, k_dim,
      n1, c_dim, chunk, tiles, static_cast<int64_t*>(ints), static_cast<double*>(flts));
  return cudaGetLastError();
}

}  // namespace repro

// The launch plan (lanes per pair, runs per staged chunk, tiles of pairs
// per stream) comes from the Python wrapper's replay_plan; a plan the
// kernel cannot take is refused with cudaErrorInvalidValue.
extern "C" int repro_downscale_replay(
    const void* lr_s0, const void* lr_len, const void* lr_busy,
    const void* lr_valid, const void* lr_trail, const void* cum_res,
    const void* ds_cum, const void* ts_first, double dt, const void* trig,
    const void* y, int64_t s_dim, int64_t k_dim, int64_t n1, int64_t c_dim,
    void* ints, void* flts, int lanes, int chunk, int tiles, void* stream) {
  if (s_dim * c_dim <= 0) return cudaSuccess;
  if (lanes <= 0 || chunk < 32 || chunk % 32 ||
      static_cast<int64_t>(tiles) * (repro::kThreads / lanes) < c_dim)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (lanes) {
#define REPRO_K7(L)                                                                   \
  case L:                                                                             \
    return repro::launch<L>(lr_s0, lr_len, lr_busy, lr_valid, lr_trail, cum_res,      \
                            ds_cum, ts_first, dt, trig, y, s_dim, k_dim, n1, c_dim,   \
                            chunk, tiles, ints, flts, s);
    REPRO_K7(8)
    REPRO_K7(32)
#undef REPRO_K7
    default:
      return cudaErrorInvalidValue;
  }
}
