"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), each beside
its plain PyTorch version.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version. Each kernel module counts its launches in
a plain integer ``LAUNCHES``; prefill attention also counts, in
``WGMMA_LAUNCHES``, the launches that took its tensor-core kernel.

The serving path runs RMSNorm, prefill attention and decode attention, and,
for hymba and RWKV-6, the Mamba selective scan and the WKV recurrence; the
what-if replay (:mod:`repro_torch.whatif.backend`) runs the cap-bucket scan
and the Algorithm-1 cooldown chain.
"""
from repro_torch.kernels import (decode_attention, downscale_replay,
                                 flash_attention, rmsnorm, run_replay, rwkv6_scan,
                                 ssm_scan)

#: the kernel modules, by kernel name
KERNEL_MODULES = {
    "rmsnorm": rmsnorm,
    "flash_attention": flash_attention,
    "decode_attention": decode_attention,
    "cap_bucket_scan": run_replay,
    "downscale_replay": downscale_replay,
    "ssm_scan": ssm_scan,
    "wkv6": rwkv6_scan,
}


def launch_counts() -> dict[str, int]:
    return {name: mod.LAUNCHES for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.LAUNCHES = 0
    flash_attention.WGMMA_LAUNCHES = 0
