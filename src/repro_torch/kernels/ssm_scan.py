"""Mamba selective scan: the CUDA kernel ``csrc/ssm_scan.cu`` on the card,
:func:`ssm_scan_plain` on the CPU.

Replaces the TPU kernel ``src/repro/kernels/ssm_scan.py::ssm_scan``. Unlike
it, the scan may start from a carried state ``h0`` (a decode step is a scan
of one step), any length works, and the inputs are read through their
strides. ``h_out`` receives the final state and may be ``h0`` itself.

On the card a thread owns ``group`` consecutive state entries of one (batch
row, channel), so ``N / group`` lanes hold a channel; :func:`launch_plan`
picks the group from the shape.

:func:`ssm_scan_backward` is the scan's gradient: the CUDA kernel
``csrc/ssm_scan_bwd.cu`` on the card, :func:`ssm_scan_backward_plain` on
the CPU. It replaces no TPU kernel (the JAX package differentiates its
``lax.scan``); ``kernels.ops.SsmScanFunction`` runs the two under autograd.
Its launch plan is :func:`backward_plan`: state entries a thread, as the
forward's, and time segments that compose their carries in a cluster.
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

#: SSM state sizes the kernel is compiled for
STATE_SIZES = (8, 16)
#: state entries a thread may own (a template parameter), largest first
GROUPS = (4, 2, 1)
#: threads the plan aims to run: a block of 128 on each of the H100's 132
#: SMs. The largest group that still gives this many is taken (G = 4 at
#: hymba-1.5b's decode step, 2 at its B = 1 prefills: the fastest of the
#: three at each, chip_smoke.py's plans sweep on an H100).
TARGET_THREADS = 132 * 128
#: threads a block (``csrc/ssm_scan.cu::kSsmThreads``)
BLOCK_THREADS = 128
#: steps a tile stages in shared memory, at most
TILE_STEPS = 32
#: shared memory a block may take without opting in
SMEM_LIMIT = 48 * 1024
#: threads a block of the backward (``csrc/ssm_scan_bwd.cu::kSsmBwdThreads``)
BWD_THREADS = 256
#: time segments the backward may split S into (one thread-block cluster),
#: fewest first
BWD_SEGMENTS = (1, 2, 4, 8)
#: the H100's SMs; the wrapper reads the count from the device
H100_SMS = 132


def ssm_scan_plain(u, dt, a, b, c, h0=None, h_out=None):
    y, h = ref.ssm_scan_reference(u, dt, a, b, c, h0)
    if h_out is not None:
        h = h_out.copy_(h)
    return y, h


def plain_cost(bsz: int, s: int, di: int, n: int, h_out: bool) -> tuple[int, int]:
    """(FLOPs, HBM bytes) that ``roofline.op_count`` counts over
    :func:`ssm_scan_plain` on float32 inputs: a step's ``einsum`` with C_t a
    (B, I, N) x (B, N, 1) product (2 B I N FLOPs; h, C_t and y_t read and
    written), the stack of the S outputs, the copy into ``h_out``."""
    step = bsz * di * n + bsz * n + bsz * di
    elems = s * step + (2 * bsz * s * di if s else 0) + (2 * bsz * di * n if h_out else 0)
    return 2 * bsz * s * di * n, 4 * elems


def backward_plain_cost(bsz: int, s: int, di: int, n: int) -> tuple[int, int]:
    """(FLOPs, HBM bytes) that ``roofline.op_count`` counts over
    :func:`ssm_scan_backward_plain` on float32 inputs: a step's three
    (B, I, N) products (dc, db, du: 6 B I N FLOPs), two sums over (B, I, N)
    (ddt, da) and four copies into the gradients' rows."""
    step = 5 * bsz * di * n + 8 * bsz * di + 7 * bsz * n + di * n
    return 6 * bsz * s * di * n, 4 * s * step


def _meta_scan(u, dt, a, b, c, h_out):
    """On ``meta``: the outputs' shapes, and :func:`plain_cost` charged
    (``_build.charge_meta``) in place of walking the S steps."""
    bsz, s, di = u.shape
    n = a.shape[-1]
    if any(t.dtype != torch.float32 for t in (u, dt, a, b, c)):
        raise ValueError("the selective scan takes float32 tensors")
    _build.charge_meta("ssm_scan (plain, closed form)", *plain_cost(bsz, s, di, n,
                                                                  h_out is not None))
    y = u.new_empty((bsz, s, di))
    return y, h_out if h_out is not None else u.new_empty((bsz, di, n))


@dataclasses.dataclass(frozen=True)
class ScanPlan:
    """One launch: ``group`` state entries a thread, ``lanes`` (N / group)
    threads a channel, ``threads`` a block (``threads // lanes`` channels),
    ``steps`` a tile staged in shared memory, ``blocks`` along the channels
    (times B in the grid)."""
    group: int
    lanes: int
    threads: int
    steps: int
    blocks: int

    @property
    def channels(self) -> int:
        return self.threads // self.lanes

    @property
    def smem_bytes(self) -> int:
        """Two buffers of B_t and C_t (N each) and u, dt of the block's
        channels for each step of a tile, and the tile's y: the layout the
        kernel takes as given."""
        n = self.lanes * self.group
        return 4 * self.steps * (2 * (2 * n + 2 * self.channels) + self.channels)


def launch_plan(bsz: int, s: int, di: int, n: int, aligned: bool,
                group: int | None = None) -> ScanPlan:
    """The plan for a scan over (``bsz``, ``s``, ``di``) with state size
    ``n``. ``group`` (one of :data:`GROUPS`) is by default the largest that
    still runs :data:`TARGET_THREADS` threads over the B I channels, so a
    small B I (a B = 1 prefill) takes a small group; it is 1, the scalar
    path, unless ``aligned`` (a contiguous and, with h0 and h_out, on the
    16-byte grid). A block holds :data:`BLOCK_THREADS` threads; a tile up
    to :data:`TILE_STEPS` steps."""
    if group is None:
        group = next((g for g in GROUPS if aligned and bsz * di * (n // g) >= TARGET_THREADS), 1)
    if group not in GROUPS or n % group or (group > 1 and not aligned):
        raise ValueError(f"group {group} cannot hold N = {n} (aligned: {aligned})")
    lanes = n // group
    return ScanPlan(group, lanes, BLOCK_THREADS, max(1, min(s, TILE_STEPS)),
                    -(-di // (BLOCK_THREADS // lanes)))


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             c: torch.Tensor, h0: torch.Tensor | None = None,
             h_out: torch.Tensor | None = None,
             plan: ScanPlan | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """u/dt: (B, S, I); a: (I, N), negative; b/c: (B, S, N); h0: (B, I, N) or
    None (zeros). All float32. Returns (y (B, S, I) without the D-skip term,
    final state (B, I, N)), the state in ``h_out`` when given. ``plan``
    (:func:`launch_plan` by default) is for measuring other plans."""
    global LAUNCHES
    if u.device.type == "cpu":
        return ssm_scan_plain(u, dt, a, b, c, h0, h_out)
    if u.device.type == "meta":
        return _meta_scan(u, dt, a, b, c, h_out)
    states = [t for t in (h0, h_out) if t is not None]
    _build.require_cuda(u, dt, a, b, c, *states)
    _build.refuse_grad("ssm_scan (K5)", u, dt, a, b, c, *states,
                       function="repro_torch.kernels.ops.SsmScanFunction")
    bsz, s, di = u.shape
    n = a.shape[-1]
    if (dt.shape != u.shape or a.shape != (di, n) or b.shape != (bsz, s, n)
            or c.shape != b.shape
            or any(t.shape != (bsz, di, n) for t in states)):
        raise ValueError(f"shapes u {tuple(u.shape)} dt {tuple(dt.shape)} a "
                         f"{tuple(a.shape)} b {tuple(b.shape)} c {tuple(c.shape)} "
                         f"states {[tuple(t.shape) for t in states]} do not match")
    if any(t.dtype != torch.float32 for t in (u, dt, a, b, c, *states)):
        raise ValueError("the selective scan takes float32 tensors")
    if n not in STATE_SIZES:
        raise ValueError(f"state size {n} not in {STATE_SIZES}")
    if not all(t.is_contiguous() for t in states):
        raise ValueError("h0 and h_out must be contiguous")
    if max(bsz, s, di) >= 2**31 or bsz >= 2**16:
        raise ValueError(f"unsupported shape {tuple(u.shape)}")
    y = torch.empty((bsz, s, di), dtype=torch.float32, device=u.device)
    if h_out is None:
        h_out = torch.empty((bsz, di, n), dtype=torch.float32, device=u.device)
    if bsz * di == 0:
        return y, h_out
    aligned = a.is_contiguous() and all(t.data_ptr() % 16 == 0 for t in (a, *states, h_out))
    if plan is None:
        plan = launch_plan(bsz, s, di, n, aligned)
    if plan.group > 1 and not aligned:
        raise ValueError(f"a plan of {plan.group} entries a thread needs a contiguous a "
                         "and 16-byte aligned a, h0 and h_out")
    strides = (ctypes.c_int64 * 14)(*u.stride(), *dt.stride(), *b.stride(),
                                    *c.stride(), *a.stride())
    err = _build.library().repro_ssm_scan(
        u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if h0 is None else h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
        ctypes.addressof(strides), bsz, s, di, n, plan.group, plan.steps, plan.smem_bytes,
        _build.stream_ptr(u))
    _build.check(err, "ssm_scan")
    LAUNCHES += 1
    return y, h_out


def ssm_scan_backward_plain(u, dt, a, b, c, h0, dy, dh_out):
    return ref.ssm_scan_backward_reference(u, dt, a, b, c, h0, dy, dh_out)


@dataclasses.dataclass(frozen=True)
class ScanBwdPlan:
    """One launch of the backward: ``group`` state entries a thread,
    ``lanes`` (N / group) threads a channel, :data:`BWD_THREADS` a block
    (``channels`` = threads // lanes), the state kept every ``chunk`` steps
    (8 at group 4, else 16), S split into ``segments`` of
    ``seg_chunks`` chunks each (a thread-block cluster along S), ``tiles``
    blocks along the channels, ``blocks`` in all. The kernel takes the plan
    as given: its block and shared-memory layout follow from these numbers."""
    bsz: int
    s: int
    di: int
    n: int
    group: int
    segments: int
    sms: int

    @property
    def lanes(self) -> int:
        return self.n // self.group

    @property
    def channels(self) -> int:
        return BWD_THREADS // self.lanes

    @property
    def chunk(self) -> int:
        return 8 if self.group == 4 else 16

    @property
    def chunks(self) -> int:
        return -(-self.s // self.chunk)

    @property
    def seg_chunks(self) -> int:
        return max(1, -(-self.chunks // self.segments))

    @property
    def tiles(self) -> int:
        return -(-self.di // self.channels)

    @property
    def blocks(self) -> int:
        return self.bsz * self.tiles * self.segments

    @property
    def smem_bytes(self) -> int:
        """Two staging buffers (u, dt, dy of the block's channels and B, C
        for each step of a chunk, the chunk's kept state and dt prefix), the
        chunk's db and dc terms (a plane of channels x N a step, padded by
        N), and its du, ddt: ``csrc/ssm_scan_bwd.cu::SsmBwdBlock``."""
        ch, n, c = self.channels, self.n, self.chunk
        buf = c * (3 * ch + 2 * n) + ch * n + ch
        return 4 * (2 * buf + 2 * c * (ch * n + n) + 2 * c * ch)

    @property
    def scratch_bytes(self) -> int:
        """The state entering each chunk: (B, chunks, I, N) floats."""
        return 4 * self.bsz * self.chunks * self.di * self.n

    @property
    def cumdt_bytes(self) -> int:
        """Each chunk's dt prefix within its segment, (B, chunks, I) floats,
        for more than one segment."""
        return 4 * self.bsz * self.chunks * self.di if self.segments > 1 else 0

    @property
    def bc_part_bytes(self) -> int:
        """db and dc, one partial a block along the channels: (2, B, tiles,
        S, N) floats."""
        return 4 * 2 * self.bsz * self.tiles * self.s * self.n


def _fill(plan: ScanBwdPlan) -> float:
    """The mean SM's blocks over the busiest SM's, blocks taken as they free
    up: the share of the card the grid keeps busy. (Whole waves of the two
    slots an SM has under-rate a grid of many short blocks, which the card
    balances as they finish: at hymba-1.5b's shape 8 segments ran 5% faster
    than 2 on an H100, 0.689 against 0.724 ms in recurrent_backward.py, both
    0.76 of such waves.)"""
    return plan.blocks / (plan.sms * -(-plan.blocks // plan.sms))


def backward_plan(bsz: int, s: int, di: int, n: int, group: int | None = None,
                  segments: int | None = None, sms: int = H100_SMS) -> ScanBwdPlan:
    """The backward's plan for (``bsz``, ``s``, ``di``) with state size ``n``
    on a card of ``sms`` SMs. ``segments`` (one of :data:`BWD_SEGMENTS`, at
    most the chunks, every segment non-empty) is by default the one whose
    grid keeps the card busiest (:func:`_fill`), the fewest on a tie;
    ``group`` (one of :data:`GROUPS`) the largest whose grid then has a
    block for every SM, else the one with the most blocks (a small B I
    takes a small group, as the forward's plan does)."""
    if n not in STATE_SIZES:
        raise ValueError(f"state size {n} not in {STATE_SIZES}")

    def with_segments(grp: int) -> ScanBwdPlan:
        if segments is not None:
            plan = ScanBwdPlan(bsz, s, di, n, grp, segments, sms)
            if segments not in BWD_SEGMENTS or (
                    segments > 1 and (segments - 1) * plan.seg_chunks >= plan.chunks):
                raise ValueError(f"{segments} segments of {plan.chunks} chunks")
            return plan
        plans = [ScanBwdPlan(bsz, s, di, n, grp, p, sms) for p in BWD_SEGMENTS]
        plans = [pl for pl in plans if pl.segments == 1
                 or (pl.segments - 1) * pl.seg_chunks < pl.chunks]
        return max(plans, key=lambda pl: (_fill(pl), -pl.segments))

    if group is not None:
        if group not in GROUPS or n % group:
            raise ValueError(f"group {group} cannot hold N = {n}")
        return with_segments(group)
    plans = [with_segments(grp) for grp in GROUPS]
    return next((pl for pl in plans if pl.blocks >= sms),
                max(plans, key=lambda pl: pl.blocks))


def ssm_scan_backward(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor, h0: torch.Tensor | None, dy: torch.Tensor,
                      dh_out: torch.Tensor | None,
                      plan: ScanBwdPlan | None = None) -> tuple[torch.Tensor, ...]:
    """The gradient of :func:`ssm_scan` at its inputs (``h0`` None: zeros)
    given ``dy`` (B, S, I), the gradient of y, and ``dh_out`` (B, I, N) or
    None (zeros), that of the final state. All float32, read as the forward
    reads them. Returns (du, ddt, da, db, dc, dh0). ``plan``
    (:func:`backward_plan` by default, on the device's SM count) is for
    measuring other plans.

    On the card the kernel keeps the state entering each chunk in a scratch
    of ``plan.scratch_bytes`` and writes db, dc as one partial a block of
    ``plan.channels`` channels and da as one a (batch row, segment); the sums
    over those are taken here, in a fixed order. It copies u, dt, b and c 16
    bytes at a time: an input off the 16-byte grid is copied onto it first,
    and an I that is no multiple of 4 is padded with channels of zeros,
    which add nothing to db and dc."""
    global BWD_LAUNCHES
    if u.device.type == "cpu":
        return ssm_scan_backward_plain(u, dt, a, b, c, h0, dy, dh_out)
    if u.device.type == "meta":
        bsz, s, di = u.shape
        n = a.shape[-1]
        _build.charge_meta("ssm_scan_backward (plain, closed form)",
                           *backward_plain_cost(bsz, s, di, n))
        return (u.new_empty(u.shape), u.new_empty(u.shape), a.new_empty(a.shape),
                b.new_empty(b.shape), b.new_empty(b.shape), u.new_empty((bsz, di, n)))
    states = [t for t in (h0, dh_out) if t is not None]
    _build.require_cuda(u, dt, a, b, c, dy, *states)
    _build.refuse_grad("ssm_scan_backward (K5')", u, dt, a, b, c, dy, *states)
    bsz, s, di = u.shape
    n = a.shape[-1]
    if (dt.shape != u.shape or dy.shape != u.shape or a.shape != (di, n)
            or b.shape != (bsz, s, n) or c.shape != b.shape
            or any(t.shape != (bsz, di, n) for t in states)):
        raise ValueError(f"shapes u {tuple(u.shape)} dt {tuple(dt.shape)} a "
                         f"{tuple(a.shape)} b {tuple(b.shape)} c {tuple(c.shape)} dy "
                         f"{tuple(dy.shape)} states {[tuple(t.shape) for t in states]} "
                         "do not match")
    if any(t.dtype != torch.float32 for t in (u, dt, a, b, c, dy, *states)):
        raise ValueError("the selective scan's backward takes float32 tensors")
    if n not in STATE_SIZES:
        raise ValueError(f"state size {n} not in {STATE_SIZES}")
    if di % 4:
        pad = -di % 4
        u, dt, dy = (torch.nn.functional.pad(t, (0, pad)) for t in (u, dt, dy))
        a, h0, dh_out = (None if t is None else torch.nn.functional.pad(t, (0, 0, 0, pad))
                         for t in (a, h0, dh_out))
        du, ddt, da, db, dc, dh0 = ssm_scan_backward(
            u, dt, a, b, c, h0, dy, dh_out,
            None if plan is None else dataclasses.replace(plan, di=di + pad))
        return du[..., :di], ddt[..., :di], da[:di], db, dc, dh0[:, :di]
    u, dt, b, c = (_build.on_grid(t) for t in (u, dt, b, c))
    # the kernel reads dy, h0, dh_out and a as vectors of its plan's group
    dy, h0, dh_out = (None if t is None else _build.aligned(t) for t in (dy, h0, dh_out))
    if bsz >= 2**16 or any((s - 1) * x.stride(1) + x.shape[2] >= 2**31
                           for x in (u, dt, b, c) if x.numel()) or s * di >= 2**31:
        raise ValueError(f"unsupported shape {tuple(u.shape)}: a batch row's offsets must "
                         "fit in 32 bits")
    f32 = dict(dtype=torch.float32, device=u.device)
    du, ddt = torch.empty((bsz, s, di), **f32), torch.empty((bsz, s, di), **f32)
    dh0 = torch.empty((bsz, di, n), **f32)
    if bsz * di == 0:
        return (du, ddt, torch.zeros((di, n), **f32), torch.zeros((bsz, s, n), **f32),
                torch.zeros((bsz, s, n), **f32), dh0)
    if plan is None:
        plan = backward_plan(bsz, s, di, n, sms=_build.sm_count(u))
    if (plan.bsz, plan.s, plan.di, plan.n) != (bsz, s, di, n):
        raise ValueError(f"the plan is for {(plan.bsz, plan.s, plan.di, plan.n)}, "
                         f"not {(bsz, s, di, n)}")
    if max(plan.scratch_bytes, plan.bc_part_bytes, 4 * bsz * s * di,
           4 * bsz * plan.segments * di * n) >= 4 * 2**31:
        raise ValueError(f"unsupported shape {tuple(u.shape)}: the kernel's buffers must "
                         "hold fewer than 2**31 elements")
    a = _build.aligned(a)
    da_part = torch.empty((bsz, plan.segments, di, n), **f32)
    bc_part = torch.empty((2, bsz, plan.tiles, s, n), **f32)
    scratch = torch.empty((bsz, plan.chunks, di, n), **f32)
    cumdt = torch.empty((bsz, plan.chunks, di), **f32) if plan.segments > 1 else None
    strides = (ctypes.c_int64 * 8)(*u.stride()[:2], *dt.stride()[:2], *b.stride()[:2],
                                   *c.stride()[:2])
    err = _build.library().repro_ssm_scan_bwd(
        u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if h0 is None else h0.data_ptr(), dy.data_ptr(),
        None if dh_out is None else dh_out.data_ptr(), du.data_ptr(), ddt.data_ptr(),
        da_part.data_ptr(), bc_part.data_ptr(), dh0.data_ptr(), scratch.data_ptr(),
        None if cumdt is None else cumdt.data_ptr(), ctypes.addressof(strides), bsz, s, di,
        n, plan.group, plan.segments, plan.seg_chunks, plan.smem_bytes, _build.stream_ptr(u))
    _build.check(err, "ssm_scan_backward")
    BWD_LAUNCHES += 1
    db, dc = bc_part.sum(dim=2)
    return du, ddt, da_part.sum(dim=(0, 1)), db, dc, dh0
