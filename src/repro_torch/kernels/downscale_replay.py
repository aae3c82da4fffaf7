"""The what-if replay's Algorithm-1 cooldown chain: the CUDA kernel
``csrc/downscale_replay.cu`` on the card, :func:`downscale_replay_plain` on
the CPU.

Replaces ``src/repro/whatif/backend.py::_downscale_kernel``, which is not
Pallas: a jitted ``lax.scan`` over each stream's low-activity runs (the
cooldown chain) wrapped in vectorized ``[K, S, C]`` passes that resolve the
trigger row and gather the prefix tables. The kernel does all of it in one
pass: one block per (stream, tile of pairs) stages the stream's run table in
shared memory, and a group of lanes per pair walks the chain by warp votes
(:func:`replay_plan` picks the lanes per pair and the chunk), with nothing
but the seven ``[S, C]`` results in device memory.

Inputs, per padding bucket of :func:`repro_torch.whatif.backend.pack_ir`
(``S`` streams, ``K`` padded low runs, ``N1`` prefix entries):

* ``lr_s0``, ``lr_len`` int64, ``lr_busy`` float64, ``lr_valid``,
  ``lr_trail`` bool, all ``[S, K]``: each low run's first row, length, the
  timestamp of the busy row after it, validity and trailing flag;
* ``cum_res`` int64 ``[S, N1]`` and ``ds_cum`` float64 ``[S, 4, N1]``: the
  resident-sample and clip-saving prefix sums;
* ``ts_first`` float64 ``[S]`` and ``dt`` (seconds per row);
* ``trig`` int64 and ``y`` float64, ``[C]``: trigger index and cooldown of
  each pair.

Returns ``(n_down, n_rest, throttled, sav0, sav1, sav2, sav3)``, each
``[S, C]``: int64 counts, then the float64 savings of the four planes
(clocks (MIN, MAX) then (MIN, MIN), each exec then active bucket).

A run fires iff it is valid, longer than the trigger, and its last row is
not before the cooldown's end: ``ts_last >= last_busy + y`` (``last_busy``
starts at ``-inf``). A fired run's trigger row is ``max(trig,
searchsorted(ts[s0:e0], last_busy + y, "left"))``, found exactly by the
4-probe window around the float-predicted crossing, on the timestamps
``fl(ts_first + fl(dt * i))`` that ``StreamIR.ts()`` gives.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _build

#: launches of the CUDA kernel in this process
LAUNCHES = 0

#: runs of the table staged in shared memory at a time (73 bytes each)
CHUNK_RUNS = 512
RUN_BYTES = 73
#: warps per block (``kThreads / 32`` in the source); each walks 32 // lanes pairs
WARPS = 8
#: the lanes-per-pair choices (a template parameter of the kernel)
LANES = (8, 32)

_INPUTS = (("lr_s0", torch.int64, 2), ("lr_len", torch.int64, 2),
           ("lr_busy", torch.float64, 2), ("lr_valid", torch.bool, 2),
           ("lr_trail", torch.bool, 2), ("cum_res", torch.int64, 2),
           ("ds_cum", torch.float64, 3), ("ts_first", torch.float64, 1),
           ("trig", torch.int64, 1), ("y", torch.float64, 1))


def chain_rows(lr_s0, lr_len, lr_busy, lr_valid, ts_first, dt: float, trig, y):
    """The chain's decisions, as the plain version takes them: ``fire``
    ``[K, S, C]`` (run k of stream s fires under pair c) and ``gpos``
    ``[K, S, C]``, the row of the prefix tables at a fired run's trigger (the
    run's first row where it does not fire)."""
    s_dim, k_dim = lr_s0.shape
    c_dim = trig.shape[0]
    f64 = torch.float64
    tsf = ts_first[:, None]
    # last-row timestamp per run, the same two roundings as StreamIR.ts()
    ts_last = tsf + dt * (lr_s0 + lr_len - 1).to(f64)
    can_fire = lr_valid.T[:, :, None] & (lr_len.T[:, :, None] > trig[None, None, :])

    fire = torch.empty((k_dim, s_dim, c_dim), dtype=torch.bool, device=lr_s0.device)
    t_cd = torch.empty((k_dim, s_dim, c_dim), dtype=f64, device=lr_s0.device)
    last_busy = torch.full((s_dim, c_dim), float("-inf"), dtype=f64, device=lr_s0.device)
    for k in range(k_dim):
        t_cd[k] = last_busy + y[None, :]
        fire[k] = can_fire[k] & (ts_last[:, k, None] >= t_cd[k])
        last_busy = torch.where(fire[k], lr_busy[:, k, None], last_busy)

    s0k = lr_s0.T[:, :, None]
    lnk = lr_len.T[:, :, None]
    tsf3 = ts_first[None, :, None]
    # float-predicted crossing, clipped in float so -inf never reaches the
    # int cast; the 4-probe window [floor(rel)-1, floor(rel)+2] holds the
    # exact searchsorted result
    rel = (t_cd - tsf3) / dt - s0k.to(f64)
    lo = torch.minimum(torch.clamp(torch.floor(rel) - 1.0, min=0.0),
                       lnk.to(f64)).to(torch.int64)
    cnt = torch.zeros_like(lo)
    for w in range(4):
        ts_j = tsf3 + dt * (s0k + lo + w).to(f64)
        cnt += ((lo + w < lnk) & (ts_j < t_cd)).to(torch.int64)
    i_row = torch.maximum(trig[None, None, :], lo + cnt)
    return fire, s0k + torch.where(fire, i_row, 0)


def downscale_replay_plain(lr_s0, lr_len, lr_busy, lr_valid, lr_trail, cum_res,
                           ds_cum, ts_first, dt: float, trig, y):
    """The vectorized transcription of the JAX package's
    ``_downscale_kernel``: the chain is a Python loop over K
    (:func:`chain_rows`), everything else ``[K, S, C]`` tensors (so it needs
    K * S * C * ~40 bytes)."""
    s_dim, k_dim = lr_s0.shape
    c_dim = trig.shape[0]
    e0 = lr_s0 + lr_len
    res_end = torch.gather(cum_res, 1, e0)
    end4 = torch.gather(ds_cum, 2, e0[:, None, :].expand(s_dim, 4, k_dim))
    fire, gpos = chain_rows(lr_s0, lr_len, lr_busy, lr_valid, ts_first, dt, trig, y)

    idx = gpos.permute(1, 0, 2).reshape(s_dim, k_dim * c_dim)
    fire_sc = fire.permute(1, 0, 2)
    n_down = fire.sum(0)
    n_rest = (fire & ~lr_trail.T[:, :, None]).sum(0)
    g_res = torch.gather(cum_res, 1, idx).reshape(s_dim, k_dim, c_dim)
    thr = torch.where(fire_sc, res_end[:, :, None] - g_res, 0).sum(1)

    def saved(plane):
        g = torch.gather(ds_cum[:, plane], 1, idx).reshape(s_dim, k_dim, c_dim)
        return torch.where(fire_sc, end4[:, plane][:, :, None] - g, 0.0).sum(1)

    return (n_down, n_rest, thr, saved(0), saved(1), saved(2), saved(3))


@dataclasses.dataclass(frozen=True)
class ReplayPlan:
    """How one bucket is cut for the kernel: ``lanes`` per (stream, pair)
    chain, ``chunk`` runs staged per pass, ``tiles`` blocks of :data:`WARPS`
    warps per stream (the grid is ``S * tiles``, stream-major)."""
    lanes: int
    chunk: int
    tiles: int

    @property
    def pairs_per_block(self) -> int:
        return WARPS * (32 // self.lanes)

    @property
    def smem_bytes(self) -> int:
        return self.chunk * RUN_BYTES


def lanes_for(k_dim: int) -> int:
    """Lanes per pair: 8 where they hold all K runs in one window (a warp
    then carries four chains), else a warp per pair, which keeps the most
    warps in flight for the long chains of the larger buckets."""
    return 8 if k_dim <= 8 else 32


def replay_plan(k_dim: int, c_dim: int, lanes: int | None = None) -> ReplayPlan:
    """The launch plan of a ``[S, K]`` bucket over ``C`` pairs: ``lanes``
    (one of :data:`LANES`; :func:`lanes_for` by default), the staged chunk a
    multiple of 32 runs up to :data:`CHUNK_RUNS` (the whole table where it
    fits), and enough tiles of :attr:`ReplayPlan.pairs_per_block` pairs to cover C."""
    lanes = lanes_for(k_dim) if lanes is None else lanes
    if lanes not in LANES:
        raise ValueError(f"lanes per pair must be one of {LANES}, not {lanes}")
    chunk = min(CHUNK_RUNS, max(32, -(-k_dim // 32) * 32))
    return ReplayPlan(lanes, chunk, max(1, -(-c_dim // (WARPS * (32 // lanes)))))


def _check(tensors: dict) -> tuple[int, int, int, int]:
    for name, dtype, ndim in _INPUTS:
        t = tensors[name]
        if t.dtype != dtype or t.dim() != ndim:
            raise ValueError(f"{name}: want {ndim}-d {dtype}, got "
                             f"{t.dim()}-d {t.dtype}")
    s_dim, k_dim = tensors["lr_s0"].shape
    n1 = tensors["cum_res"].shape[1]
    c_dim = tensors["trig"].shape[0]
    want = {"lr_len": (s_dim, k_dim), "lr_busy": (s_dim, k_dim),
            "lr_valid": (s_dim, k_dim), "lr_trail": (s_dim, k_dim),
            "cum_res": (s_dim, n1), "ds_cum": (s_dim, 4, n1),
            "ts_first": (s_dim,), "y": (c_dim,)}
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{name}: shape {tuple(tensors[name].shape)}, "
                             f"want {shape}")
    return s_dim, k_dim, n1, c_dim


def downscale_replay(lr_s0, lr_len, lr_busy, lr_valid, lr_trail, cum_res, ds_cum,
                     ts_first, dt: float, trig, y):
    """The whole-family Algorithm-1 replay over one bucket (see the module
    docstring for the arguments and results)."""
    tensors = dict(lr_s0=lr_s0, lr_len=lr_len, lr_busy=lr_busy, lr_valid=lr_valid,
                   lr_trail=lr_trail, cum_res=cum_res, ds_cum=ds_cum,
                   ts_first=ts_first, trig=trig, y=y)
    s_dim, k_dim, n1, c_dim = _check(tensors)
    if all(t.device.type == "cpu" for t in tensors.values()):
        return downscale_replay_plain(lr_s0, lr_len, lr_busy, lr_valid, lr_trail,
                                      cum_res, ds_cum, ts_first, float(dt), trig, y)
    _build.require_cuda(*tensors.values())
    _build.refuse_grad("downscale_replay (K7)", *tensors.values())
    if not all(t.is_contiguous() for t in tensors.values()):
        raise ValueError("the replay tensors must be contiguous")
    return launch(tensors, float(dt), replay_plan(k_dim, c_dim))


def launch(tensors: dict, dt: float, plan: ReplayPlan):
    """Launches the kernel with ``plan`` on the CUDA tensors (keyed by
    argument name) that :func:`downscale_replay` has checked; the results
    as it returns them. ``chip_smoke.py`` times other plans through it."""
    global LAUNCHES
    s_dim, k_dim = tensors["lr_s0"].shape
    n1 = tensors["cum_res"].shape[1]
    c_dim = tensors["trig"].shape[0]
    dev = tensors["lr_s0"].device
    ints = torch.empty((3, s_dim, c_dim), dtype=torch.int64, device=dev)
    flts = torch.empty((4, s_dim, c_dim), dtype=torch.float64, device=dev)
    if s_dim * c_dim:
        ptr = {k: t.data_ptr() for k, t in tensors.items()}
        err = _build.library().repro_downscale_replay(
            ptr["lr_s0"], ptr["lr_len"], ptr["lr_busy"], ptr["lr_valid"],
            ptr["lr_trail"], ptr["cum_res"], ptr["ds_cum"], ptr["ts_first"], dt,
            ptr["trig"], ptr["y"], s_dim, k_dim, n1, c_dim, ints.data_ptr(),
            flts.data_ptr(), plan.lanes, plan.chunk, plan.tiles,
            _build.stream_ptr(tensors["lr_s0"]))
        _build.check(err, "downscale_replay")
        LAUNCHES += 1
    return (ints[0], ints[1], ints[2], flts[0], flts[1], flts[2], flts[3])
