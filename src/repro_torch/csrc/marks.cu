// Empty named kernels that mark, on the card's timeline, where each part of
// the train step begins: the forward, the backward, the update (the clip and
// the optimizer), and the step's end. A profiler names every kernel of a
// replayed CUDA graph but not the part of the step it belongs to; a capture
// records these launches as nodes of the graph, so every replay carries them
// and the trace shows them as repro::mark_forward, repro::mark_backward,
// repro::mark_update and repro::mark_done.
#include <cuda_runtime.h>

namespace repro {

__global__ void mark_forward() {}
__global__ void mark_backward() {}
__global__ void mark_update() {}
__global__ void mark_done() {}

}  // namespace repro

// which: 0 forward, 1 backward, 2 update, 3 done (kernels/marks.py's MARKS).
extern "C" int repro_mark(int which, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: repro::mark_forward<<<1, 1, 0, s>>>(); break;
    case 1: repro::mark_backward<<<1, 1, 0, s>>>(); break;
    case 2: repro::mark_update<<<1, 1, 0, s>>>(); break;
    case 3: repro::mark_done<<<1, 1, 0, s>>>(); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
