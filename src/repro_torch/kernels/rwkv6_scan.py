"""RWKV-6 WKV recurrence: the CUDA kernel ``csrc/wkv6.cu`` on the card,
:func:`wkv6_plain` on the CPU.

Replaces the TPU kernel ``src/repro/kernels/rwkv6_scan.py::wkv6``. Unlike
it, the recurrence may start from a carried state ``state0`` (a decode step
is a scan of one step), any length works, and r, k, v, w are read through
their strides, so head-major views of the model's (B, S, H, K) projections
need no copy. ``state_out`` receives the final state and may be ``state0``
itself.

On the card a (batch row, head) is split by column slice over
``slices`` blocks, and a thread owns a quad of columns over ``rows`` rows of
its slice; :func:`launch_plan` picks both from the shape.

:func:`wkv6_backward` is the recurrence's gradient: the CUDA kernel
``csrc/wkv6_bwd.cu`` on the card, :func:`wkv6_backward_plain` on the CPU. It
replaces no TPU kernel (the JAX package differentiates its ``lax.scan``);
``kernels.ops.Wkv6Function`` runs the two under autograd. Its launch plan is
:func:`backward_plan`: column slices of 16 over a cluster, the state kept
every 16 steps.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build, ref

#: launches of the CUDA kernel in this process
LAUNCHES = 0
#: launches of the backward's CUDA kernel in this process
BWD_LAUNCHES = 0

#: head sizes the kernel is compiled for
HEAD_SIZES = (16, 32, 64)
#: column slices a (row, head) may be split into, fewest first
SLICES = (1, 2)
#: blocks the plan aims for: two on each of the H100's 132 SMs. The fewest
#: slices that give this many are taken, else the most.
TARGET_BLOCKS = 2 * 132
#: rows a thread may own, fewest first
ROWS = (1, 2, 4, 8)
#: threads a block, at most
BLOCK_THREADS = 128
#: steps a tile stages in shared memory, at most
TILE_STEPS = 32
#: shared memory a block may take without opting in
SMEM_LIMIT = 48 * 1024
#: columns a block of the backward holds (``csrc/wkv6_bwd.cu::kWkvBwdCols``):
#: a (row, head) is K / 16 blocks, one thread-block cluster, and a block is
#: 4 K threads, one a (state row, quad of columns)
BWD_COLS = 16
#: steps between the states the backward keeps (``kWkvBwdChunk``), and the
#: steps whose sums it takes at once (``kWkvBwdRound``)
BWD_CHUNK = 16
BWD_ROUND = 8


def wkv6_plain(r, k, v, w, u, state0=None, state_out=None):
    y, state = ref.wkv6_reference(r, k, v, w, u, state0)
    if state_out is not None:
        state = state_out.copy_(state)
    return y, state


def _rows_merge(t: torch.Tensor) -> bool:
    """Whether a step's (B, H, K) slice of ``t`` (B, H, S, K) views as
    (B H, K) without a copy: not so for head-major views of the model's
    (B, S, H, K), whose ``einsum`` copies the slice each step."""
    return t.shape[0] == 1 or t.shape[1] == 1 or t.stride(0) == t.shape[1] * t.stride(1)


def plain_cost(bsz: int, h: int, s: int, kd: int, state_out: bool,
               copies: int = 0) -> tuple[int, int]:
    """(FLOPs, HBM bytes) that ``roofline.op_count`` counts over
    :func:`wkv6_plain` on float32 inputs: a step's ``einsum`` with r_t a
    (B H, 1, K) x (B H, K, K) product (2 B H K² FLOPs; r_t, the state term
    and y_t read and written), ``copies`` (B, H, K) slices copied a step
    (r_t, where :func:`_rows_merge` fails), the stack of the S outputs, the
    copy into ``state_out``."""
    bh = bsz * h
    step = (2 + 2 * copies) * bh * kd + bh * kd * kd
    elems = s * step + (2 * bh * s * kd if s else 0) + (2 * bh * kd * kd if state_out else 0)
    return 2 * bh * s * kd * kd, 4 * elems


def backward_plain_cost(bsz: int, h: int, s: int, kd: int,
                        copies: int = 0) -> tuple[int, int]:
    """(FLOPs, HBM bytes) that ``roofline.op_count`` counts over
    :func:`wkv6_backward_plain` on float32 inputs: a step's three
    (B H, K, K) x (B H, K, 1) products (dr, dk, dv: 6 B H K² FLOPs), four
    sums (dy·v, r u k, dw, du), four copies into the gradients' rows, and
    ``copies`` (B, H, K) slices the products copy (dy_t, v_t, k_t where
    :func:`_rows_merge` fails)."""
    bh = bsz * h
    step = 4 * bh * kd * kd + (18 + 2 * copies) * bh * kd + 2 * bh + h * kd
    return 6 * bh * s * kd * kd, 4 * s * step


def _meta_wkv(r, k, v, w, u, state_out):
    """On ``meta``: the outputs' shapes (y head-major over (B, S, H, K), as
    on the card), and :func:`plain_cost` charged (``_build.charge_meta``) in
    place of walking the S steps."""
    bsz, h, s, kd = r.shape
    if any(t.dtype != torch.float32 for t in (r, k, v, w, u)):
        raise ValueError("the WKV recurrence takes float32 tensors")
    _build.charge_meta("wkv6 (plain, closed form)",
                       *plain_cost(bsz, h, s, kd, state_out is not None,
                                   copies=int(not _rows_merge(r))))
    y = r.new_empty((bsz, s, h, kd)).transpose(1, 2)
    return y, state_out if state_out is not None else r.new_empty((bsz, h, kd, kd))


@dataclasses.dataclass(frozen=True)
class WkvPlan:
    """One launch: each (row, head) split into ``slices`` blocks of
    ``K / slices`` columns; a thread owns 4 columns over ``rows`` rows, so a
    block is ``threads`` = (K / slices / 4) x (K / rows); ``steps`` a tile
    staged in shared memory, ``smem_bytes`` of it, ``blocks`` in the grid.
    The kernel takes the plan as given: its block and shared-memory layout
    follow from these numbers."""
    slices: int
    rows: int
    threads: int
    steps: int
    smem_bytes: int
    blocks: int


def _smem_bytes(steps: int, kd: int, slices: int, threads: int) -> int:
    """Two buffers of r, k, w (K each) and the slice's v (K / slices) for
    every step of a tile, each warp's partial y (K / slices) a step, and u."""
    cols = kd // slices
    return 4 * (steps * (2 * (3 * kd + cols) + threads // 32 * cols) + kd)


def launch_plan(bsz: int, h: int, s: int, kd: int, slices: int | None = None) -> WkvPlan:
    """The plan for B = ``bsz`` rows of ``h`` heads of size ``kd`` over ``s``
    steps. ``slices`` (one of :data:`SLICES`) is by default the fewest that
    give :data:`TARGET_BLOCKS` blocks, else the most; rows a thread the
    fewest that keep a block within :data:`BLOCK_THREADS` threads; the tile
    the most steps, up to
    :data:`TILE_STEPS`, whose shared memory fits in :data:`SMEM_LIMIT`, a
    whole number of the steps a warp reduces at once (its row groups) where
    it holds more than that."""
    if slices is None:
        slices = next((c for c in SLICES if bsz * h * c >= TARGET_BLOCKS), SLICES[-1])
    if slices not in SLICES or kd not in HEAD_SIZES:
        raise ValueError(f"{slices} column slices of K = {kd} are not compiled")
    quads = kd // (4 * slices)
    rows = next(r for r in ROWS if quads * kd // r <= BLOCK_THREADS)
    threads = quads * kd // rows
    steps = max(1, min(s, TILE_STEPS))
    while steps > 1 and _smem_bytes(steps, kd, slices, threads) > SMEM_LIMIT:
        steps -= 1
    group = 32 // quads
    if steps > group:
        steps -= steps % group
    return WkvPlan(slices, rows, threads, steps, _smem_bytes(steps, kd, slices, threads),
                   bsz * h * slices)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, state0: torch.Tensor | None = None,
         state_out: torch.Tensor | None = None,
         plan: WkvPlan | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: (B, H, S, K), w the per-step decay in (0, 1); u: (H, K);
    state0: (B, H, K, K) or None (zeros). All float32. Returns (y (B, H, S, K),
    final state (B, H, K, K)), the state in ``state_out`` when given.
    ``plan`` (:func:`launch_plan` by default) is for measuring other plans.

    On the card y is a head-major view of memory laid out as (B, S, H, K), so
    the model layout is one free transpose away.
    """
    global LAUNCHES
    if r.device.type == "cpu":
        return wkv6_plain(r, k, v, w, u, state0, state_out)
    if r.device.type == "meta":
        return _meta_wkv(r, k, v, w, u, state_out)
    states = [t for t in (state0, state_out) if t is not None]
    _build.require_cuda(r, k, v, w, u, *states)
    _build.refuse_grad("wkv6 (K6)", r, k, v, w, u, *states,
                       function="repro_torch.kernels.ops.Wkv6Function")
    bsz, h, s, kd = r.shape
    if (any(t.shape != r.shape for t in (k, v, w)) or u.shape != (h, kd)
            or any(t.shape != (bsz, h, kd, kd) for t in states)):
        raise ValueError(f"shapes r {tuple(r.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} w {tuple(w.shape)} u {tuple(u.shape)} "
                         f"states {[tuple(t.shape) for t in states]} do not match")
    if any(t.dtype != torch.float32 for t in (r, k, v, w, u, *states)):
        raise ValueError("the WKV recurrence takes float32 tensors")
    if kd not in HEAD_SIZES:
        raise ValueError(f"head size {kd} not in {HEAD_SIZES}")
    if any(t.stride(-1) != 1 for t in (r, k, v, w)):
        raise ValueError("the head-size axis of r, k, v, w must be contiguous")
    if not (u.is_contiguous() and all(t.is_contiguous() for t in states)):
        raise ValueError("u, state0 and state_out must be contiguous")
    if max(h, s) >= 2**31 // 4 or bsz >= 2**16:
        raise ValueError(f"unsupported shape {tuple(r.shape)}")
    y = torch.empty((bsz, s, h, kd), dtype=torch.float32, device=r.device).transpose(1, 2)
    if state_out is None:
        state_out = torch.empty((bsz, h, kd, kd), dtype=torch.float32, device=r.device)
    if bsz * h == 0:
        return y, state_out
    if plan is None:
        plan = launch_plan(bsz, h, s, kd)
    strides = (ctypes.c_int64 * 15)(*r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                    *w.stride()[:3], *y.stride()[:3])
    err = _build.library().repro_wkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if state0 is None else state0.data_ptr(), y.data_ptr(),
        state_out.data_ptr(), ctypes.addressof(strides), bsz, h, s, kd, plan.slices,
        plan.rows, plan.steps, plan.smem_bytes, _build.stream_ptr(r))
    _build.check(err, "wkv6")
    LAUNCHES += 1
    return y, state_out


def wkv6_backward_plain(r, k, v, w, u, state0, dy, dstate_out):
    return ref.wkv6_backward_reference(r, k, v, w, u, state0, dy, dstate_out)


@dataclasses.dataclass(frozen=True)
class WkvBwdPlan:
    """One launch of the backward for B = ``bsz`` rows of ``h`` heads of
    size ``kd`` over ``s`` steps: each (row, head) split into ``slices`` =
    K / :data:`BWD_COLS` blocks (a thread-block cluster), a block of
    ``threads`` = 4 K, the state kept every :data:`BWD_CHUNK` steps, the sums
    taken every :data:`BWD_ROUND`. The kernel takes it as given."""
    bsz: int
    h: int
    s: int
    kd: int

    @property
    def slices(self) -> int:
        return self.kd // BWD_COLS

    @property
    def threads(self) -> int:
        return 4 * self.kd

    @property
    def chunks(self) -> int:
        return -(-self.s // BWD_CHUNK)

    @property
    def blocks(self) -> int:
        return self.bsz * self.h * self.slices

    @property
    def smem_bytes(self) -> int:
        """Two staging buffers (r, k, w and the slice's v, dy for each step
        of a chunk), the rows' partials (4 quads of K + 2 float4 a step of a
        round), the dv terms (K x 16 + 16 a step), two buffers of slice sums
        (3 K a step), dy . v of a chunk, u: ``csrc/wkv6_bwd.cu::WkvBwdBlock``."""
        kd, cw, t, r = self.kd, BWD_COLS, BWD_CHUNK, BWD_ROUND
        return 4 * (2 * t * (3 * kd + 2 * cw) + r * 4 * 4 * (kd + 2) + r * (kd * cw + 16)
                    + 2 * r * 3 * kd + t + kd)

    @property
    def scratch_bytes(self) -> int:
        """The state entering each chunk: (B, H, chunks, K, K) floats."""
        return 4 * self.bsz * self.h * self.chunks * self.kd * self.kd


def backward_plan(bsz: int, h: int, s: int, kd: int) -> WkvBwdPlan:
    """The backward's plan for B = ``bsz`` rows of ``h`` heads of size ``kd``
    over ``s`` steps."""
    if kd not in HEAD_SIZES:
        raise ValueError(f"head size {kd} not in {HEAD_SIZES}")
    return WkvBwdPlan(bsz, h, s, kd)


def wkv6_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                  u: torch.Tensor, state0: torch.Tensor | None, dy: torch.Tensor,
                  dstate_out: torch.Tensor | None) -> tuple[torch.Tensor, ...]:
    """The gradient of :func:`wkv6` at its inputs (``state0`` None: zeros)
    given ``dy`` (B, H, S, K), the gradient of y, and ``dstate_out``
    (B, H, K, K) or None (zeros), that of the final state. All float32,
    r, k, v, w and dy read through their strides as the forward reads
    them. Returns (dr, dk, dv, dw, du, dstate0); on the card dr, dk, dv and
    dw are head-major views of memory laid out as (B, S, H, K), like the
    forward's y.

    On the card the kernel keeps the state entering every
    :data:`BWD_CHUNK`-step chunk in a scratch of
    :attr:`WkvBwdPlan.scratch_bytes`, and writes du as one partial a (batch
    row, column slice); the sum over those is taken here, in a fixed order.
    It copies r, k, v, w and dy 16 bytes at a time: an input off the 16-byte
    grid is copied onto it first."""
    global BWD_LAUNCHES
    if r.device.type == "cpu":
        return wkv6_backward_plain(r, k, v, w, u, state0, dy, dstate_out)
    if r.device.type == "meta":
        bsz, h, s, kd = r.shape
        copies = sum(not _rows_merge(t) for t in (dy, v, k))
        _build.charge_meta("wkv6_backward (plain, closed form)",
                           *backward_plain_cost(bsz, h, s, kd, copies))
        grads = [r.new_empty((bsz, s, h, kd)).transpose(1, 2) for _ in range(4)]
        return (*grads, u.new_empty(u.shape), r.new_empty((bsz, h, kd, kd)))
    states = [t for t in (state0, dstate_out) if t is not None]
    _build.require_cuda(r, k, v, w, u, dy, *states)
    _build.refuse_grad("wkv6_backward (K6')", r, k, v, w, u, dy, *states)
    bsz, h, s, kd = r.shape
    if (any(t.shape != r.shape for t in (k, v, w, dy)) or u.shape != (h, kd)
            or any(t.shape != (bsz, h, kd, kd) for t in states)):
        raise ValueError(f"shapes r {tuple(r.shape)} k {tuple(k.shape)} v "
                         f"{tuple(v.shape)} w {tuple(w.shape)} u {tuple(u.shape)} dy "
                         f"{tuple(dy.shape)} states {[tuple(t.shape) for t in states]} "
                         "do not match")
    if any(t.dtype != torch.float32 for t in (r, k, v, w, u, dy, *states)):
        raise ValueError("the WKV recurrence's backward takes float32 tensors")
    if kd not in HEAD_SIZES:
        raise ValueError(f"head size {kd} not in {HEAD_SIZES}")
    if any(t.stride(-1) != 1 for t in (r, k, v, w)):
        raise ValueError("the head-size axis of r, k, v, w must be contiguous")
    r, k, v, w, dy = (_build.on_grid(t) for t in (r, k, v, w, dy))
    if max(h, s) >= 2**31 // 4 or bsz >= 2**16 or any(
            (s - 1) * abs(x.stride(2)) + kd >= 2**31 for x in (r, k, v, w, dy)):
        raise ValueError(f"unsupported shape {tuple(r.shape)}: a (row, head)'s offsets must "
                         "fit in 32 bits")
    u = u.contiguous()
    # the kernel reads the states as float4s
    state0, dstate_out = (None if t is None else _build.aligned(t)
                          for t in (state0, dstate_out))
    f32 = dict(dtype=torch.float32, device=r.device)
    dr, dk, dv, dw = (torch.empty((bsz, s, h, kd), **f32).transpose(1, 2) for _ in range(4))
    if bsz * h == 0 or s == 0:
        return (dr, dk, dv, dw, torch.zeros((h, kd), **f32),
                torch.zeros((bsz, h, kd, kd), **f32) if dstate_out is None
                else dstate_out.clone())
    dstate0 = torch.empty((bsz, h, kd, kd), **f32)
    plan = backward_plan(bsz, h, s, kd)
    du_part = torch.empty((bsz, plan.slices, h, kd), **f32)
    scratch = torch.empty((bsz, h, plan.chunks, kd, kd), **f32)
    strides = (ctypes.c_int64 * 18)(*r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                    *w.stride()[:3], *dy.stride()[:3], *dr.stride()[:3])
    err = _build.library().repro_wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if state0 is None else state0.data_ptr(), dy.data_ptr(),
        None if dstate_out is None else dstate_out.data_ptr(), dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dw.data_ptr(), du_part.data_ptr(), dstate0.data_ptr(),
        scratch.data_ptr(), ctypes.addressof(strides), bsz, h, s, kd, plan.smem_bytes,
        _build.stream_ptr(r))
    _build.check(err, "wkv6_backward")
    BWD_LAUNCHES += 1
    return dr, dk, dv, dw, du_part.sum(dim=(0, 1)), dstate0
