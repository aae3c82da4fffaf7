"""The serving path's kernels: hand-written CUDA for Hopper (``csrc/``),
each beside its plain PyTorch version (``ref``).

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version. Each kernel module counts its launches in
a plain integer ``LAUNCHES``.
"""
from repro_torch.kernels import decode_attention, flash_attention, rmsnorm

#: the kernel modules of the serving path, by kernel name
KERNEL_MODULES = {
    "rmsnorm": rmsnorm,
    "flash_attention": flash_attention,
    "decode_attention": decode_attention,
}


def launch_counts() -> dict[str, int]:
    return {name: mod.LAUNCHES for name, mod in KERNEL_MODULES.items()}


def reset_launch_counts() -> None:
    for mod in KERNEL_MODULES.values():
        mod.LAUNCHES = 0
