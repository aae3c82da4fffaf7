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
#: threads a block of the backward, one a state entry
#: (``csrc/ssm_scan_bwd.cu::kSsmBwdThreads``)
BWD_BLOCK_THREADS = 256
#: steps between the states the backward keeps (``csrc/ssm_scan_bwd.cu::kChunk``)
BWD_CHUNK = 16


def ssm_scan_plain(u, dt, a, b, c, h0=None, h_out=None):
    y, h = ref.ssm_scan_reference(u, dt, a, b, c, h0)
    if h_out is not None:
        h = h_out.copy_(h)
    return y, h


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


def ssm_scan_backward(u: torch.Tensor, dt: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor, h0: torch.Tensor | None, dy: torch.Tensor,
                      dh_out: torch.Tensor | None) -> tuple[torch.Tensor, ...]:
    """The gradient of :func:`ssm_scan` at its inputs (``h0`` None: zeros)
    given ``dy`` (B, S, I), the gradient of y, and ``dh_out`` (B, I, N) or
    None (zeros), that of the final state. All float32, read as the forward
    reads them. Returns (du, ddt, da, db, dc, dh0).

    On the card the kernel recomputes the states from ``h0`` into a scratch
    of ``ceil(S / BWD_CHUNK)`` chunk-boundary states, and writes db, dc as one
    partial a block and da as one a batch row; the sums over those are
    taken here, in a fixed order."""
    global BWD_LAUNCHES
    if u.device.type == "cpu":
        return ssm_scan_backward_plain(u, dt, a, b, c, h0, dy, dh_out)
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
    if max(bsz, s, di) >= 2**31 or bsz >= 2**16:
        raise ValueError(f"unsupported shape {tuple(u.shape)}")
    dy = dy.contiguous()
    h0, dh_out = (None if t is None else t.contiguous() for t in (h0, dh_out))
    f32 = dict(dtype=torch.float32, device=u.device)
    du, ddt = torch.empty((bsz, s, di), **f32), torch.empty((bsz, s, di), **f32)
    dh0 = torch.empty((bsz, di, n), **f32)
    if bsz * di == 0:
        return (du, ddt, torch.zeros((di, n), **f32), torch.zeros((bsz, s, n), **f32),
                torch.zeros((bsz, s, n), **f32), dh0)
    blocks = -(-di // (BWD_BLOCK_THREADS // n))
    da_part = torch.empty((bsz, di, n), **f32)
    bc_part = torch.empty((2, bsz, blocks, s, n), **f32)
    scratch = torch.empty((bsz, -(-s // BWD_CHUNK), di, n), **f32)
    strides = (ctypes.c_int64 * 14)(*u.stride(), *dt.stride(), *b.stride(),
                                    *c.stride(), *a.stride())
    err = _build.library().repro_ssm_scan_bwd(
        u.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if h0 is None else h0.data_ptr(), dy.data_ptr(),
        None if dh_out is None else dh_out.data_ptr(), du.data_ptr(), ddt.data_ptr(),
        da_part.data_ptr(), bc_part.data_ptr(), dh0.data_ptr(), scratch.data_ptr(),
        ctypes.addressof(strides), bsz, s, di, n, _build.stream_ptr(u))
    _build.check(err, "ssm_scan_backward")
    BWD_LAUNCHES += 1
    db, dc = bc_part.sum(dim=2)
    return du, ddt, da_part.sum(dim=0), db, dc, dh0
