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
// What bounds it on the card: bytes. Per (s, c) lane and run the work is a
// compare and an add, and a fired run some 40 operations and 10 gathers;
// the least traffic is the run tables, the prefix tables, the pairs and the
// seven [S, C] results, each moved once, at a few operations per byte,
// under the ~20 per byte at which even the H100's float32 rate would take
// over. The JAX version materialises [K, S, C] int64 and float64
// temporaries (hundreds of MB each at the 10^4-config grid); this kernel
// keeps the chain, the trigger rows and the sums in registers, so its
// traffic is the inputs and the results only.
//
// Design: one thread per (stream, pair); neighbouring threads take
// neighbouring pairs of one stream, so the run-table loads of a warp are
// one broadcast and the results are written coalesced. The prefix tables
// are gathered at data-dependent rows; one stream's tables are a few
// hundred KB and stay in L2 while its lanes run. Sums run in run order per
// lane with no atomics, so results are deterministic (they differ from the
// reference's reduction order only in float rounding, within 1e-9
// relative). The timestamps are fl(ts_first + fl(dt * i)) exactly as
// StreamIR.ts() and the NumPy oracle compute them, so every multiply-add is
// written with __dmul_rn/__dadd_rn, which nvcc never contracts into an FMA
// (a fused ts would move a fire decision by an ulp and break the
// bit-identical counts). The -inf start of last_busy is clipped in double
// before the int64 cast, which would be undefined on -inf.
#include "common.cuh"

namespace repro {

__global__ void __launch_bounds__(256)
downscale_replay_kernel(const int64_t* __restrict__ lr_s0,
                        const int64_t* __restrict__ lr_len,
                        const double* __restrict__ lr_busy,
                        const uint8_t* __restrict__ lr_valid,
                        const uint8_t* __restrict__ lr_trail,
                        const int64_t* __restrict__ cum_res,
                        const double* __restrict__ ds_cum,
                        const double* __restrict__ ts_first, double dt,
                        const int64_t* __restrict__ trig,
                        const double* __restrict__ y, int64_t s_dim,
                        int64_t k_dim, int64_t n1, int64_t c_dim,
                        int64_t* __restrict__ ints, double* __restrict__ flts) {
  const int64_t lanes = s_dim * c_dim;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= lanes) return;
  const int64_t s = idx / c_dim;
  const int64_t c = idx - s * c_dim;
  const int64_t* s0_row = lr_s0 + s * k_dim;
  const int64_t* len_row = lr_len + s * k_dim;
  const double* busy_row = lr_busy + s * k_dim;
  const uint8_t* valid_row = lr_valid + s * k_dim;
  const uint8_t* trail_row = lr_trail + s * k_dim;
  const int64_t* res = cum_res + s * n1;
  const double* ds = ds_cum + s * 4 * n1;
  const double tsf = ts_first[s];
  const int64_t tr = trig[c];
  const double yc = y[c];

  double last_busy = __longlong_as_double(0xfff0000000000000LL);  // -inf
  int64_t n_down = 0, n_rest = 0, thr = 0;
  double sav[4] = {0.0, 0.0, 0.0, 0.0};
  for (int64_t k = 0; k < k_dim; ++k) {
    if (!valid_row[k]) continue;
    const int64_t len = len_row[k];
    if (!(len > tr)) continue;
    const int64_t s0 = s0_row[k];
    const int64_t e0 = s0 + len;
    const double ts_last = __dadd_rn(tsf, __dmul_rn(dt, static_cast<double>(e0 - 1)));
    const double t_cd = __dadd_rn(last_busy, yc);
    if (!(ts_last >= t_cd)) continue;
    // trigger row: float-predicted crossing, clipped to [0, len] in double,
    // then resolved exactly by 4 probes
    const double rel = __dsub_rn(__ddiv_rn(__dsub_rn(t_cd, tsf), dt),
                                 static_cast<double>(s0));
    const double lo_f = fmin(fmax(floor(rel) - 1.0, 0.0), static_cast<double>(len));
    const int64_t lo = static_cast<int64_t>(lo_f);
    int64_t cnt = 0;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const double ts_j = __dadd_rn(tsf, __dmul_rn(dt, static_cast<double>(s0 + lo + w)));
      cnt += (lo + w < len) && (ts_j < t_cd);
    }
    const int64_t g = s0 + (lo + cnt > tr ? lo + cnt : tr);
    ++n_down;
    n_rest += !trail_row[k];
    thr += res[e0] - res[g];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      sav[p] += ds[p * n1 + e0] - ds[p * n1 + g];
    }
    last_busy = busy_row[k];
  }
  ints[idx] = n_down;
  ints[lanes + idx] = n_rest;
  ints[2 * lanes + idx] = thr;
#pragma unroll
  for (int p = 0; p < 4; ++p) flts[p * lanes + idx] = sav[p];
}

}  // namespace repro

extern "C" int repro_downscale_replay(
    const void* lr_s0, const void* lr_len, const void* lr_busy,
    const void* lr_valid, const void* lr_trail, const void* cum_res,
    const void* ds_cum, const void* ts_first, double dt, const void* trig,
    const void* y, int64_t s_dim, int64_t k_dim, int64_t n1, int64_t c_dim,
    void* ints, void* flts, void* stream) {
  constexpr int kThreads = 256;
  const int64_t lanes = s_dim * c_dim;
  if (lanes <= 0) return cudaSuccess;
  const int64_t blocks = (lanes + kThreads - 1) / kThreads;
  if (blocks >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  repro::downscale_replay_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(lr_s0), static_cast<const int64_t*>(lr_len),
      static_cast<const double*>(lr_busy), static_cast<const uint8_t*>(lr_valid),
      static_cast<const uint8_t*>(lr_trail), static_cast<const int64_t*>(cum_res),
      static_cast<const double*>(ds_cum), static_cast<const double*>(ts_first), dt,
      static_cast<const int64_t*>(trig), static_cast<const double*>(y), s_dim,
      k_dim, n1, c_dim, static_cast<int64_t*>(ints), static_cast<double*>(flts));
  return cudaGetLastError();
}
