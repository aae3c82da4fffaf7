"""The run-level replay's cap-bucket scan: the CUDA kernel
``csrc/cap_bucket_scan.cu`` on the card, :func:`cap_bucket_scan_plain` on the
CPU.

Replaces the TPU kernel ``src/repro/kernels/run_replay.py::cap_bucket_scan``
(``_cap_scan_kernel``). The power-cap evaluator reduces every cap to ``k =
#{p > cap}`` against a stream's sorted per-state power bucket; clipped
energy, throttle count and the cube-law penalty are then gathers into prefix
sums (:mod:`repro_torch.whatif.backend`).

Rows may be front-padded with ``-inf`` to a common width: ``-inf <= cap``
always, so the padding only shifts the insertion point and ``Np - insertion``
still counts exactly the real samples above the cap. ``caps`` is read
through its strides, so a ``[S, C]`` cap table ``expand``-ed over the four
buckets of each stream is never materialised.

On the card a block takes one row and a tile of its caps; :func:`launch_plan`
picks the branch (the row from its padding's end staged in shared memory,
or, for a row too wide for it, the top of the search's probe tree), the
tiles a row and the caps a thread.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.kernels import _build

#: launches of the CUDA kernel in this process
LAUNCHES = 0

#: threads a block, at most (``csrc/cap_bucket_scan.cu::kCapScanMaxThreads``)
THREADS = 256
#: caps a thread searches at once (a template parameter), largest first
CAPS = (8, 4, 1)
#: shared memory a block can have on an H100 (227 KB; past 48 KB by opting in)
SMEM_MAX = 232_448
#: levels of the probe tree a block of the tree branch stages: 2^12 doubles
TREE_LEVELS = 12
#: tiles a row the plan weighs
TILES = (1, 2, 4, 8, 16, 32)
#: caps a tile holds, at least
MIN_TILE_CAPS = 256
#: an H100: SMs, shared memory an SM gives its blocks (228 KB, 1 KB of it
#: reserved for each block) and threads an SM holds
SMS = 132
SM_SMEM = 233_472
BLOCK_RESERVED_SMEM = 1024
SM_THREADS = 2048


def _iters(n: int) -> int:
    return max(int(n).bit_length(), 1)


def cap_bucket_scan_plain(sorted_p: torch.Tensor, caps: torch.Tensor) -> torch.Tensor:
    """``Np - bisect_right(sorted_p[..., :], caps[..., c])`` as int32, by the
    same fixed-trip bisection as the kernel: ``lo`` converges to the
    insertion point in ``bit_length(Np)`` halvings, and lanes already done
    keep ``lo == hi``."""
    n = sorted_p.shape[-1]
    if n == 0:
        return torch.zeros(caps.shape, dtype=torch.int32, device=caps.device)
    lo = torch.zeros(caps.shape, dtype=torch.int64, device=caps.device)
    hi = torch.full(caps.shape, n, dtype=torch.int64, device=caps.device)
    for _ in range(_iters(n)):
        cont = lo < hi
        mid = torch.clamp((lo + hi) // 2, max=n - 1)
        right = cont & (torch.gather(sorted_p, -1, mid) <= caps)
        lo = torch.where(right, mid + 1, lo)
        hi = torch.where(cont & ~right, mid, hi)
    return (n - lo).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class CapScanPlan:
    """One launch: ``branch`` "row" (the row from its padding's end staged
    in shared memory, every probe answered there; ``levels`` 0) or "tree"
    (the first ``levels`` probes answered from the staged top of the probe
    tree, the rest from the row in global memory); ``tiles`` blocks a row,
    each a contiguous tile of the row's caps; ``threads`` a block, each
    searching ``caps`` caps at once; ``smem_bytes`` of dynamic shared
    memory."""
    branch: str
    threads: int
    caps: int
    tiles: int
    levels: int
    smem_bytes: int


def row_smem_bytes(n: int) -> int:
    """Shared memory of the row branch: ``n + 1`` doubles (the staged part
    starts on a 16-byte boundary, one element early at most), on the
    16-byte grid."""
    return 16 * ((n + 2) // 2)


def blocks_per_sm(threads: int, smem_bytes: int) -> int:
    """Blocks of this shape an H100 SM holds at once, by shared memory and
    threads."""
    return min(SM_SMEM // (smem_bytes + BLOCK_RESERVED_SMEM), SM_THREADS // threads)


@functools.lru_cache(maxsize=1024)       # a few shapes a process; a plan is frozen
def launch_plan(n: int, c: int, rows: int, tiles: int | None = None,
                branch: str | None = None, caps: int | None = None) -> CapScanPlan:
    """The plan for ``rows`` rows of ``n`` samples and ``c`` caps each.
    ``branch`` is "row" wherever the row fits in :data:`SMEM_MAX`, else
    "tree". ``tiles`` (one of :data:`TILES`) is by default the most that
    still run every block in one wave of the card and leave each tile
    :data:`MIN_TILE_CAPS` caps: each tile stages its row again, and a
    second wave waits for the first. A tile's caps go to at most
    :data:`THREADS` threads, each taking the most of :data:`CAPS` that still
    leave the tile two warps. (Within 3% of the fastest plan
    ``chip_smoke.py`` weighs at each of the seven padding buckets of the
    10^4-config ``evaluate`` on an H100.) ``tiles``, ``branch`` and ``caps``
    may be given, to measure other plans."""
    fits = row_smem_bytes(n) <= SMEM_MAX
    if branch is None:
        branch = "row" if fits else "tree"
    if branch not in ("row", "tree") or (branch == "row" and not fits):
        raise ValueError(f"branch {branch!r} cannot take a row of {n} samples")
    if branch == "row":
        levels, smem = 0, row_smem_bytes(n)
    else:
        levels = min(TREE_LEVELS, (n - 1).bit_length())     # the search's halvings
        smem = max(16, 8 << levels)                         # on the 16-byte grid

    if caps is not None and caps not in CAPS:
        raise ValueError(f"caps {caps} not in {CAPS}")

    def shape(t: int) -> tuple[int, int]:
        tile_caps = -(-c // t)
        g = caps or next((g for g in CAPS if tile_caps >= 64 * g), 1)
        return min(THREADS, 32 * -(-tile_caps // (32 * g))), g

    if tiles is None:
        most = max(1, c // MIN_TILE_CAPS)
        tiles = max([t for t in TILES if t <= most
                     and rows * t <= SMS * blocks_per_sm(shape(t)[0], smem)], default=1)
    if tiles not in TILES:
        raise ValueError(f"tiles {tiles} not in {TILES}")
    threads, caps = shape(tiles)
    return CapScanPlan(branch, threads, caps, tiles, levels, smem)


def cap_bucket_scan(sorted_p: torch.Tensor, caps: torch.Tensor,
                    plan: CapScanPlan | None = None) -> torch.Tensor:
    """``k[..., c] = #{sorted_p[..., :] > caps[..., c]}``.

    ``sorted_p``: ``[R, Np]`` or ``[G, B, Np]`` float64, each row ascending;
    ``caps``: float64 of the same leading shape with ``C`` last, any strides
    (an expanded view is fine). Returns int32 of ``caps``' shape, contiguous:
    exactly :func:`cap_bucket_scan_plain`'s counts (``Np`` for a NaN cap)
    for rows sorted ascending as ``torch.sort`` sorts them (NaN last); on
    the card, a row out of order gives counts of no defined value.
    ``plan`` (:func:`launch_plan` by default) is for measuring other plans.
    """
    global LAUNCHES
    if sorted_p.dim() not in (2, 3) or caps.dim() != sorted_p.dim() \
            or caps.shape[:-1] != sorted_p.shape[:-1]:
        raise ValueError(f"sorted_p {tuple(sorted_p.shape)} and caps "
                         f"{tuple(caps.shape)} must share their leading axes")
    if sorted_p.dtype != torch.float64 or caps.dtype != torch.float64:
        raise ValueError(f"float64 inputs only, got {sorted_p.dtype} {caps.dtype}")
    if sorted_p.device.type == "cpu" and caps.device.type == "cpu":
        return cap_bucket_scan_plain(sorted_p, caps)
    _build.require_cuda(sorted_p, caps)
    _build.refuse_grad("cap_bucket_scan (K4)", sorted_p, caps)
    if not sorted_p.is_contiguous():
        raise ValueError("sorted_p must be contiguous")
    sp3 = sorted_p if sorted_p.dim() == 3 else sorted_p[None]
    caps3 = caps if caps.dim() == 3 else caps[None]
    g, b, n = sp3.shape
    c = caps3.shape[-1]
    if n >= 2**31 or c >= 2**31:
        raise ValueError(f"unsupported row width {n} or cap count {c}")
    out = torch.empty(caps3.shape, dtype=torch.int32, device=caps.device)
    if out.numel() == 0 or n == 0:
        return out.zero_().reshape(caps.shape)
    if plan is None:
        plan = launch_plan(n, c, g * b)
    err = _build.library().repro_cap_bucket_scan(
        sp3.data_ptr(), caps3.data_ptr(), out.data_ptr(), g, b, n, c,
        *caps3.stride(), int(plan.branch == "tree"), plan.levels,
        plan.threads, plan.caps, plan.tiles, plan.smem_bytes, _build.stream_ptr(caps))
    _build.check(err, "cap_bucket_scan")
    LAUNCHES += 1
    return out.reshape(caps.shape)
