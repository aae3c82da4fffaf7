#!/usr/bin/env python3
"""Card times of the port's attention kernels around their design choices,
on one NVIDIA GPU (an H100):

    python3 attention_sweep.py

* decode attention (K3) on llama-13b's cache (4, 256, 40, 128) over
  cache lengths, from one chunk to four;
* K3 on hymba-1.5b's global cache (4, 2048, 5, 64) at 1, 5 and 8 q heads
  per kv head, at each chunk size of the split plan, in bf16 (products on
  the tensor cores) and f32 (CUDA cores);
* prefill attention (K2) in bf16 at llama-13b's 32-token bucket and
  hymba-1.5b's 2,048-token prefill, against its f32 CUDA-core kernel on
  the same values.

Each time is the card time per call of 100 calls captured in one CUDA graph
(``chip_smoke.graph_ms``), the caches rotated over 8 layers past the L2.
Prints one line per case and, last, the card's name and power limit.
Builds the kernels first, as ``chip_smoke.py`` does. Imports nothing of JAX.
"""
from __future__ import annotations

import json
import sys

import chip_smoke as cs


def main() -> int:
    sys.path.insert(0, str(cs.ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(7)
    layers = 8

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    def decode_ms(q, kc, vc, n):
        it = iter(range(1 << 62))
        return cs.graph_ms(lambda: (lambda i: ops.decode_attention(q, kc[i], vc[i], n))(
            next(it) % layers))

    def show(case, ms):
        print(json.dumps({"case": case, "ms": ms}), flush=True)

    kc, vc = rnd(layers, 4, 256, 40, 128), rnd(layers, 4, 256, 40, 128)
    q = rnd(4, 1, 40, 128)
    for cl in (0, 16, 64, 65, 128, 256):
        n = torch.full((), cl, dtype=torch.int32, device=dev)
        show(f"K3 llama-13b cache (4, 256, 40, 128) bf16, len {cl}", decode_ms(q, kc, vc, n))
    del kc, vc

    plan = da.split_plan
    for dtype in (torch.bfloat16, torch.float32):
        kc, vc = rnd(layers, 4, 2048, 5, 64, dtype=dtype), rnd(layers, 4, 2048, 5, 64, dtype=dtype)
        n = torch.full((), 2048, dtype=torch.int32, device=dev)
        for h in (5, 25, 40):
            q = rnd(4, 1, h, 64, dtype=dtype)
            for chunk in (32, 64, 128):
                da.split_plan = lambda b, kv, s, d, itemsize, c=chunk: (c, -(-s // c))
                try:
                    ms = decode_ms(q, kc, vc, n)
                finally:
                    da.split_plan = plan
                show(f"K3 hymba-1.5b cache (4, 2048, 5, 64) {str(dtype)[6:]}, {h // 5} q heads "
                     f"per kv head, C {chunk}" + (" (the plan's)" if plan(
                         4, 5, 2048, 64, kc.element_size())[0] == chunk else ""), ms)
        del kc, vc

    for s, h, kv, d, window in ((32, 40, 40, 128, 0), (2048, 25, 5, 64, 0),
                                (2048, 25, 5, 64, 1024)):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = rnd(1, s, h, d, dtype=dtype), rnd(1, s, kv, d, dtype=dtype), \
                rnd(1, s, kv, d, dtype=dtype)
            kernel = "tensor cores" if dtype == torch.bfloat16 else "CUDA cores"
            show(f"K2 (1, {s}, {h}/{kv}, {d}) {str(dtype)[6:]} ({kernel}), window {window}",
                 cs.graph_ms(lambda: ops.flash_attention(q, k, v, window=window), 20))
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
