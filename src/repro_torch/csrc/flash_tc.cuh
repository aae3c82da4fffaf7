// What K2's tensor-core forward (flash_attention.cu) and its backward
// (flash_attention_bwd.cu) share: the 64-row tiles, their shared-memory
// layout in swizzled panels, the bf16 packing of an accumulator fragment as
// a wgmma A operand, and the TMA tensor maps of the model's bf16
// (batch, rows, heads, d) tensors.
#pragma once

#include <stdio.h>

#include "common.cuh"
#include "hopper.cuh"

namespace repro {

constexpr int kTcRows = 64;                     // rows of a q tile = keys of a key tile
constexpr int kTcConsumers = 128;               // one warpgroup
constexpr int kTcThreads = kTcConsumers + 32;   // and one producer warp

template <int D>
struct TcLayout {
  static constexpr int PW = D < 64 ? D : 64;       // elements in a panel row
  static constexpr int RB = PW * 2;                // its bytes: the swizzle span
  static constexpr int PANEL = kTcRows * RB;       // one panel of a 64-row tile
  static constexpr int NPANEL = D / PW;
  static constexpr int TILE = PANEL * NPANEL;      // a 64-row tile, 64 * D * 2 bytes
  static constexpr int STAGES = D <= 64 ? 3 : 2;
  static constexpr uint32_t SWIZZLE = RB == 128 ? 1 : 2;  // descriptor code: 128 B, 64 B
  // Q, the K and V rings, 2 * STAGES + 1 mbarriers, and room to align to 1 KB
  static constexpr int SMEM = TILE * (1 + 2 * STAGES) + 8 * (2 * STAGES + 1) + 1024;
  static constexpr int MIN_BLOCKS = D >= 256 ? 1 : (D == 128 ? 2 : 3);
  // a k16 step's A operand at `kk`: its 16 columns in their panel
  __host__ __device__ static constexpr uint32_t k_off(int kk) {
    return (kk / (PW / 16)) * PANEL + (kk % (PW / 16)) * 32;
  }
};

// the descriptor of a 64-row tile's panel as wgmma reads it: K-major at
// tile + k_off(kk) (the A or B operand of a product over d), or MN-major at
// tile + n * PANEL + kk * 16 * RB (the B operand of a product over the rows)
template <int D>
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  using L = TcLayout<D>;
  return wgmma_desc(addr, 8 * L::RB, 8 * L::RB, L::SWIZZLE);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                         cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(ptr);
  }();
  return fn;
}

// A bf16 (batch, rows, heads, d) view, element strides (batch, head, seq),
// as a 4-D tensor map of 64-row boxes one panel wide, swizzled as wgmma reads
// them. Rows and heads past the ends load as zeros.
static bool encode_tile_map(CUtensorMap* map, const void* base, int d, int rows, int heads,
                            int batch, const int64_t* st) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) {
    fprintf(stderr, "repro: cuTensorMapEncodeTiled not found in the driver\n");
    return false;
  }
  // The encoder needs a current context on the calling thread. A thread
  // that has made no runtime call yet has none (autograd's device thread,
  // where a backward may launch first, on device 0); setting the current
  // device binds its primary context.
  int device;
  if (cudaGetDevice(&device) != cudaSuccess || cudaSetDevice(device) != cudaSuccess) {
    fprintf(stderr, "repro: no current device to encode a tensor map on\n");
    return false;
  }
  const int pw = d < 64 ? d : 64;
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(rows), cuuint64_t(heads),
                              cuuint64_t(batch)};
  // a dimension of size 1 is never stepped: give it a legal stride
  const cuuint64_t strides[3] = {rows > 1 ? cuuint64_t(st[2]) * 2 : cuuint64_t(d) * 2,
                                 heads > 1 ? cuuint64_t(st[1]) * 2 : cuuint64_t(d) * 2,
                                 batch > 1 ? cuuint64_t(st[0]) * 2 : cuuint64_t(d) * 2};
  const cuuint32_t box[4] = {cuuint32_t(pw), cuuint32_t(kTcRows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        pw * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) fprintf(stderr, "repro: cuTensorMapEncodeTiled failed (CUresult %d)\n", int(r));
  return r == CUDA_SUCCESS;
}

}  // namespace repro
