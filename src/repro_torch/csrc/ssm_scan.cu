// Mamba selective scan for Hopper.
//
// Replaces the TPU kernel src/repro/kernels/ssm_scan.py::ssm_scan
// (_ssm_kernel, :24): per batch row and inner channel i, with an f32 state
// h of N entries,
//     h_t = exp(dt_t * a_i) * h_{t-1} + dt_t * B_t * u_t,   y_t = C_t . h_t,
// y without the D-skip term (the caller adds u * D), and the final state.
// The state starts from h0 when one is given, else from zeros.
//
// What bounds it on the card: bytes. Per (row, step, channel) it reads u
// and dt (8 bytes) and writes y (4 bytes) for ~8 N operations, and it reads
// and writes the (B, I, N) f32 state once. At hymba-1.5b's decode step (B = 4,
// S = 1, I = 3200, N = 16) that is 0.82 MB of state in and 0.82 MB out plus
// 0.15 MB of u, dt and y: 0.60 us at 3.35 TB/s. At its 32-token prefill
// (B = 1) u, dt and y are 1.2 MB (0.49 us); at the 2,048-token prefill of the
// logit check 78.6 MB (23 us). The recurrence is one FMA deep per step
// (exp(dt a) and dt B u do not depend on h), so what the card can do is
// stream the bytes and issue the exps. One thread per (row, channel) would
// run 12,800 threads at the decode step, read each state entry with a
// scalar load 64 bytes from its neighbour's, and use 25 SMs at a B = 1
// prefill: too few loads in flight, and too few threads.
//
// Design: the TPU kernel evaluates each chunk in a closed form with (C, C)
// pair terms in log space, to feed the TPU's matrix unit. Here the
// sequential recurrence is exact (the oracle's own form) and each state
// entry keeps its arithmetic, h = expf(dt a) h + (dt B) u. The state is
// spread over threads: a thread owns G in {1, 2, 4} consecutive entries of
// one (row, channel), so L = N / G lanes hold a channel (a template
// parameter, picked by the launch plan from B I: G = 4 at the decode step,
// 51,200 threads; G = 2 at a B = 1 prefill, 25,600). Because h is (B, I, N)
// contiguous and a is (I, N), neighbouring lanes read and write neighbouring
// G entries: h0, h_out and a move as coalesced 16-byte (G = 4) or 8-byte
// (G = 2) vectors. G = 1 is also the scalar path, which reads a through its
// strides.
//
// y_t = C_t . h_t is each lane's G-term partial summed over the channel's L
// lanes. A lane computes its partials for L steps in a row (the exps do not
// wait on h, so they overlap), then the L lanes reduce-scatter them by
// __shfl_xor_sync: L - 1 shuffles for L steps, after which lane l holds step
// l's sum, where a butterfly per step would take log2(L) shuffles a step.
// Steps left over (all of a decode step) take the butterfly. A block of 128
// threads stages B_t and C_t for a tile of steps, and u_t and dt_t for its
// channels, in shared memory by cp.async, the next tile's copies in flight
// while this tile is computed (two buffers), and collects the tile's y
// there, so u, dt and y move coalesced along i. The y sums are in a fixed
// order: two calls give the same bits. The final state is stored before the
// last tile's y, so the two stores overlap.
//
// The final state may be written over the initial one (h_out == h0): each
// thread reads its own G entries before it writes them.
#include "common.cuh"
#include "hopper.cuh"

namespace repro {

struct SsmParams {
  const float* u;
  const float* dt;
  const float* a;
  const float* b;
  const float* c;
  const float* h0;  // may be null: start from zeros
  float* y;         // (B, S, I) contiguous
  float* h_out;     // (B, I, N) contiguous
  int64_t us[3], dts[3], bs[3], cs[3];  // strides of (batch, seq, last axis)
  int64_t as[2];                        // strides of a (channel, state)
  int s, di;
  int steps;                            // steps a tile
};

constexpr int kSsmThreads = 128;  // a block (the launch plan's BLOCK_THREADS)

template <int N, int G>
__global__ void __launch_bounds__(kSsmThreads)
ssm_scan_kernel(const SsmParams p) {
  constexpr int L = N / G;                     // lanes a channel
  constexpr int CH = kSsmThreads / L;          // channels a block
  // two buffers of [steps][N] B and C and [steps][CH] u and dt, then the
  // tile's y: the launch plan's smem_bytes (kernels/ssm_scan.py)
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tile = p.steps * (2 * N + 2 * CH); // one buffer's floats
  float* s_y = smem + 2 * tile;                // [steps][CH]

  const int64_t row = blockIdx.y;
  const int i0 = blockIdx.x * CH;
  const int cl = threadIdx.x / L;              // this lane's channel in the block
  const int lane = threadIdx.x % L;            // and its place among the channel's lanes
  const int n0 = lane * G;                     // its first state entry
  const int i = i0 + cl;
  const bool live = i < p.di;
  const int64_t hoff = (row * p.di + i) * N + n0;

  // dead lanes (past I) run on zeros so that every lane takes the shuffles
  float a[G], h[G];
#pragma unroll
  for (int g = 0; g < G; ++g) a[g] = h[g] = 0.f;
  if (live) {
    if (p.h0 != nullptr) load_floats<G>(h, p.h0 + hoff);
    if constexpr (G == 1) {
      a[0] = p.a[i * p.as[0] + n0 * p.as[1]];
    } else {  // the plan takes G > 1 only for a contiguous, aligned a
      load_floats<G>(a, p.a + static_cast<int64_t>(i) * N + n0);
    }
  }
  const float* u = p.u + row * p.us[0];
  const float* dt = p.dt + row * p.dts[0];
  const float* bm = p.b + row * p.bs[0];
  const float* cm = p.c + row * p.cs[0];
  float* y = p.y + row * p.s * p.di;

  // a buffer holds [steps][N] of B, then of C, then [steps][CH] of u, of dt
  auto stage = [&](float* buf, int t0) {
    const int steps = min(p.steps, p.s - t0);
    for (int idx = threadIdx.x; idx < steps * N; idx += kSsmThreads) {
      const int64_t t = t0 + idx / N;
      const int n = idx % N;
      cp_async4(smem_u32(buf + idx), bm + t * p.bs[1] + n * p.bs[2]);
      cp_async4(smem_u32(buf + p.steps * N + idx), cm + t * p.cs[1] + n * p.cs[2]);
    }
    float* bu = buf + 2 * p.steps * N;
    float* bdt = bu + p.steps * CH;
    for (int idx = threadIdx.x; idx < steps * CH; idx += kSsmThreads) {
      const int64_t t = t0 + idx / CH;
      const int ii = i0 + idx % CH;
      if (ii < p.di) {
        cp_async4(smem_u32(bu + idx), u + t * p.us[1] + ii * p.us[2]);
        cp_async4(smem_u32(bdt + idx), dt + t * p.dts[1] + ii * p.dts[2]);
      } else {
        bu[idx] = 0.f;
        bdt[idx] = 0.f;
      }
    }
    cp_async_commit();
  };
  if (p.s > 0) stage(smem, 0);

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
    __syncthreads();  // this tile has landed, from every thread's copies
    const float* s_b = smem + cur * tile;
    const float* s_c = s_b + p.steps * N;
    const float* s_u = s_c + p.steps * N;
    const float* s_dt = s_u + p.steps * CH;
    // one step's partial over this lane's G entries
    auto step = [&](int t) {
      const float dtv = s_dt[t * CH + cl];
      const float uv = s_u[t * CH + cl];
      float bt[G], ct[G];
      load_floats<G>(bt, s_b + t * N + n0);
      load_floats<G>(ct, s_c + t * N + n0);
      float yp = 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        h[g] = expf(dtv * a[g]) * h[g] + dtv * bt[g] * uv;
        yp = fmaf(h[g], ct[g], yp);
      }
      return yp;
    };
    // whole batches of L steps, whose exps and loads overlap, then a
    // reduce-scatter over the channel's lanes: lane l ends with step tb + l
    int tb = 0;
    for (; tb + L <= steps; tb += L) {
      float part[L][1];
#pragma unroll
      for (int j = 0; j < L; ++j) part[j][0] = step(tb + j);
      reduce_scatter<L / 2, 1>(part, lane);
      s_y[(tb + lane) * CH + cl] = part[0][0];
    }
    // the rest (all of a decode step) one at a time, summed by a butterfly
    for (; tb < steps; ++tb) {
      const float yt = lanes_sum<L, 1>(step(tb));
      if (lane == 0) s_y[tb * CH + cl] = yt;
    }
    // the final state goes out before the tile's y, to overlap the two
    if (last && live) store_floats<G>(p.h_out + hoff, h);
    __syncthreads();  // the tile's y is complete and its inputs are read
    for (int idx = threadIdx.x; idx < steps * CH; idx += kSsmThreads) {
      const int ii = i0 + idx % CH;
      if (ii < p.di) y[static_cast<int64_t>(t0 + idx / CH) * p.di + ii] = s_y[idx];
    }
  }
  if (p.s == 0 && live) store_floats<G>(p.h_out + hoff, h);
}

template <int N, int G>
static cudaError_t launch(const SsmParams& p, int bsz, int smem_bytes, cudaStream_t stream) {
  constexpr int CH = kSsmThreads / (N / G);
  const dim3 grid((p.di + CH - 1) / CH, bsz);
  ssm_scan_kernel<N, G><<<grid, kSsmThreads, smem_bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace repro

// strides: 14 int64 values in elements: (batch, seq, channel) of u and dt,
// (batch, seq, state) of b and c, then (channel, state) of a. All inputs are
// float32; h0 may be null. The launch plan (kernels/ssm_scan.py::launch_plan),
// taken as given: `group` state entries a thread (1, 2 or 4; above 1, a must
// be contiguous and a, h0 and h_out 16-byte aligned), `steps` a tile and
// `smem_bytes` of shared memory for it.
extern "C" int repro_ssm_scan(const void* u, const void* dt, const void* a,
                              const void* b, const void* c, const void* h0,
                              void* y, void* h_out, const int64_t* strides,
                              int bsz, int s, int di, int n, int group, int steps,
                              int smem_bytes, void* stream) {
  repro::SsmParams p;
  p.u = static_cast<const float*>(u);
  p.dt = static_cast<const float*>(dt);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const float*>(b);
  p.c = static_cast<const float*>(c);
  p.h0 = static_cast<const float*>(h0);
  p.y = static_cast<float*>(y);
  p.h_out = static_cast<float*>(h_out);
  for (int i = 0; i < 3; ++i) {
    p.us[i] = strides[i];
    p.dts[i] = strides[3 + i];
    p.bs[i] = strides[6 + i];
    p.cs[i] = strides[9 + i];
  }
  p.as[0] = strides[12];
  p.as[1] = strides[13];
  p.s = s;
  p.di = di;
  p.steps = steps;
  if (steps < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n * 10 + group) {
    case 81: return repro::launch<8, 1>(p, bsz, smem_bytes, st);
    case 82: return repro::launch<8, 2>(p, bsz, smem_bytes, st);
    case 84: return repro::launch<8, 4>(p, bsz, smem_bytes, st);
    case 161: return repro::launch<16, 1>(p, bsz, smem_bytes, st);
    case 162: return repro::launch<16, 2>(p, bsz, smem_bytes, st);
    case 164: return repro::launch<16, 4>(p, bsz, smem_bytes, st);
    default: return cudaErrorInvalidValue;
  }
}
