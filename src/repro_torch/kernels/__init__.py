"""The port's kernels: hand-written CUDA for Hopper (``csrc/``), each beside
its plain PyTorch version.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version. Given ``meta`` tensors (the dry-run,
``launch/dryrun.py``), RMSNorm and the two attentions run their plain
versions, and the selective scan and the WKV recurrence (forward and
backward) return outputs of the right shape and charge what their plain
versions would count in closed form (``_build.charge_meta``); no launch is
counted. The cap-bucket scan and the cooldown chain refuse ``meta``. Each kernel module counts its launches in
a plain integer ``LAUNCHES``, and the selective scan's and the WKV
recurrence's backward kernels theirs in ``BWD_LAUNCHES``; prefill attention
also counts, in ``WGMMA_LAUNCHES``, the launches that took its tensor-core
kernel, and its two backward kernels in ``BWD_DQ_LAUNCHES`` and
``BWD_DKV_LAUNCHES`` (keys ``flash_attention_bwd_dq`` and
``flash_attention_bwd_dkv`` of :func:`launch_counts`).

The serving path runs RMSNorm, prefill attention and decode attention, and,
for hymba and RWKV-6, the Mamba selective scan and the WKV recurrence; the
what-if replay (:mod:`repro_torch.whatif.backend`) runs the cap-bucket scan
and the Algorithm-1 cooldown chain. Training runs RMSNorm, prefill attention,
the selective scan and the WKV recurrence inside autograd Functions
(:mod:`repro_torch.kernels.ops`), the last two with their backward kernels,
and prefill attention with its own in bf16 at head dims up to 128.

A wrapper called while a CUDA graph is captured records its kernel into the
graph and launches nothing, and a replay launches the graph's kernels
without calling any wrapper. :func:`captured_launches` and
:func:`count_replay` keep the counts true across both.

:func:`mark` launches the empty kernels that mark the train step's parts
on the card's timeline (:mod:`repro_torch.kernels.marks`); they are counted
nowhere.

A kernel that cannot be built, loaded or launched raises
:class:`KernelError` (a ``RuntimeError``).
"""
from __future__ import annotations

import contextlib
from typing import Iterator

from repro_torch.kernels import (decode_attention, downscale_replay,
                                 flash_attention, rmsnorm, run_replay, rwkv6_scan,
                                 ssm_scan)
from repro_torch.kernels._build import KernelError  # noqa: F401
from repro_torch.kernels.marks import mark  # noqa: F401

#: the kernel modules, by kernel name
KERNEL_MODULES = {
    "rmsnorm": rmsnorm,
    "flash_attention": flash_attention,
    "decode_attention": decode_attention,
    "cap_bucket_scan": run_replay,
    "downscale_replay": downscale_replay,
    "ssm_scan": ssm_scan,
    "wkv6": rwkv6_scan,
    "ssm_scan_bwd": ssm_scan,
    "wkv6_bwd": rwkv6_scan,
    "flash_attention_bwd_dq": flash_attention,
    "flash_attention_bwd_dkv": flash_attention,
}
#: the counter of each kernel whose module counts it elsewhere than in ``LAUNCHES``
COUNTERS = {"ssm_scan_bwd": "BWD_LAUNCHES", "wkv6_bwd": "BWD_LAUNCHES",
            "flash_attention_bwd_dq": "BWD_DQ_LAUNCHES",
            "flash_attention_bwd_dkv": "BWD_DKV_LAUNCHES"}
#: the key of ``flash_attention.WGMMA_LAUNCHES`` in a graph's launch record
WGMMA = "flash_attention_wgmma"


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, COUNTERS.get(name, "LAUNCHES"))
            for name, mod in KERNEL_MODULES.items()}


def _add(name: str, n: int) -> None:
    attr = COUNTERS.get(name, "LAUNCHES")
    mod = KERNEL_MODULES[name]
    setattr(mod, attr, getattr(mod, attr) + n)


def reset_launch_counts() -> None:
    for name, n in launch_counts().items():
        _add(name, -n)
    flash_attention.WGMMA_LAUNCHES = 0


def _counters() -> dict[str, int]:
    return {**launch_counts(), WGMMA: flash_attention.WGMMA_LAUNCHES}


def count_replay(launches: dict[str, int], times: int = 1) -> None:
    """Add a graph's launches (from :func:`captured_launches`) to the
    counters, once per replay."""
    for name, n in launches.items():
        if name == WGMMA:
            flash_attention.WGMMA_LAUNCHES += n * times
        else:
            _add(name, n * times)


@contextlib.contextmanager
def captured_launches() -> Iterator[dict[str, int]]:
    """Wrap a CUDA-graph capture. On exit the yielded dict holds every
    counter's calls made inside the block (the graph's launches per replay,
    ``WGMMA`` among them), and those calls are taken back out of the
    counters, since a capture launches nothing."""
    before = _counters()
    launches: dict[str, int] = {}
    try:
        yield launches
    finally:
        launches.update({k: n - before[k] for k, n in _counters().items()})
        count_replay(launches, -1)
