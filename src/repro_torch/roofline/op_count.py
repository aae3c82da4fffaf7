"""Per-rank FLOPs, HBM bytes and collective bytes of one step as the port
runs it, counted by dispatch modes while the step runs: the port's
counterpart of the JAX package's ``roofline/hlo_parse.py``.

The reference compiles each step and reads these from the optimized HLO
(``analyze_hlo``), multiplying a ``while`` body by its trip count. The port
has no HLO: it runs the step eagerly, on the ``meta`` device so that nothing
is allocated, and a :class:`OpCounter` sees every aten op below autograd, the
backward's included. A loop needs no trip count: each op is counted as often
as it runs. Per op:

* **flops**: ``torch.utils.flop_counter.FlopCounterMode``'s formulas (its
  ``flop_registry``: mm, addmm, bmm, baddbmm, convolutions, fused
  attention); elementwise ops none, as ``hlo_parse`` counts only dots;
* **hbm bytes**: operand plus output bytes of each materialising op
  (:data:`MATERIALIZING_OPS`, mapped from ``hlo_parse._MATERIALIZING_OPS``:
  products, copies and dtype casts, gathers, scatters and index ops,
  concatenation, reductions and softmax, sort and top-k, padding, the
  collectives). Views, factories and elementwise ops are free, as XLA fuses
  them into their consumers there; an in-place op reads its other operands
  and writes as many bytes as its update holds (``copy_`` its whole
  destination). This is a lower bound of the traffic: the eager step's
  elementwise chains and the optimizer's update are not charged;
* **collective bytes**: each ``c10d`` and ``_c10d_functional`` collective's
  per-rank transmitted bytes from its output and its group's size
  (``analysis._operand_bytes``), under the reference's op names.

The selective scan's and the WKV recurrence's wrappers, given ``meta``
tensors, charge what their plain versions would count here in closed form
(``kernels/_build.charge_meta``): walking 4,096-32,768 steps a layer in
Python would take minutes a cell.

Each distinct (op, flops, bytes, collective, group, output bytes) is kept
once with its count (:meth:`OpCounter.entries`), which the dry-run caches
beside each cell and :func:`stats_from_entries` turns back into the terms
(``roofline/rederive.py``).
"""
from __future__ import annotations

import collections
import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import _build
from repro_torch.roofline.analysis import COLLECTIVE_OPS, _operand_bytes

#: aten ops (overload packet names) whose operands and outputs are charged
MATERIALIZING_OPS = frozenset({
    # dot, convolution
    "mm", "addmm", "bmm", "baddbmm", "convolution", "_convolution",
    "convolution_backward",
    # copy (and convert, which materialises in eager code)
    "copy_", "clone", "_to_copy",
    # gather, scatter, dynamic-slice and dynamic-update-slice
    "gather", "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "index", "index_put", "index_put_", "_index_put_impl_", "index_select", "index_add",
    "index_add_", "index_copy", "index_copy_", "embedding", "embedding_dense_backward",
    "slice_scatter", "select_scatter", "masked_scatter",
    # concatenate
    "cat", "stack",
    # reduce, reduce-window, softmax
    "sum", "mean", "amax", "amin", "max", "min", "argmax", "argmin", "logsumexp", "var",
    "var_mean", "std", "prod", "norm", "linalg_vector_norm", "any", "all", "cumsum",
    "bincount", "_softmax", "_log_softmax", "_softmax_backward_data",
    "_log_softmax_backward_data",
    # sort
    "sort", "topk",
    # pad
    "constant_pad_nd",
})

#: the collectives, by (namespace, packet name), under the reference's names
_COLLECTIVES = {
    **{("c10d", n): "all-reduce" for n in ("allreduce_", "allreduce_coalesced_")},
    **{("c10d", n): "all-gather" for n in ("allgather_", "_allgather_base_",
                                           "allgather_coalesced_",
                                           "allgather_into_tensor_coalesced_")},
    **{("c10d", n): "reduce-scatter" for n in ("reduce_scatter_", "_reduce_scatter_base_",
                                               "reduce_scatter_tensor_coalesced_")},
    **{("c10d", n): "all-to-all" for n in ("alltoall_", "alltoall_base_")},
    **{("c10d", n): "collective-permute" for n in ("send", "recv_", "broadcast_")},
    **{("_c10d_functional", n): "all-reduce" for n in ("all_reduce", "all_reduce_",
                                                       "all_reduce_coalesced")},
    **{("_c10d_functional", n): "all-gather" for n in ("all_gather_into_tensor",
                                                       "all_gather_into_tensor_out",
                                                       "all_gather_into_tensor_coalesced")},
    **{("_c10d_functional", n): "reduce-scatter" for n in (
        "reduce_scatter_tensor", "reduce_scatter_tensor_coalesced")},
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    **{("_c10d_functional", n): "collective-permute" for n in ("broadcast", "broadcast_")},
}
#: collective-library ops that move no data
_NO_DATA = {("c10d", "barrier"), ("c10d", "monitored_barrier_"),
            ("_c10d_functional", "wait_tensor"), ("_c10d_functional", "_wrap_tensor_autograd")}


@dataclasses.dataclass
class HloStats:
    """The reference's ``hlo_parse.HloStats``, so that ``derive_terms`` takes
    it unchanged: per-rank FLOPs, HBM bytes and collective bytes."""
    flops: float
    hbm_bytes: float
    collective_bytes: float
    collective_by_op: dict[str, float]
    collective_counts: dict[str, float]

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def _bytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(x)
               if isinstance(t, torch.Tensor))


def _group_size(func, args) -> int:
    """The size of the process group a collective runs over: its
    ``group_size`` argument, its process group, or its group's name."""
    named = dict(zip((a.name for a in func._schema.arguments), args))
    if "group_size" in named:
        return int(named["group_size"])
    if "process_group" in named:
        return torch._C._distributed_c10d.ProcessGroup.unbox(named["process_group"]).size()
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(named["group_name"]).size()


def _tensors(x) -> list[torch.Tensor]:
    return [t for t in tree_leaves(x) if isinstance(t, torch.Tensor)]


def _collective_bytes(args, out) -> tuple[int, int]:
    """(operand + output bytes, output bytes) of a collective: what it
    returns, or else its first argument, is its output; its other tensor
    arguments its operands, or the output itself for one in place
    (all-reduce, broadcast)."""
    written = _tensors(out) or _tensors(args[0])
    read = [t for t in _tensors(args) if not any(t is w for w in written)] or written
    return _bytes(read) + _bytes(written), _bytes(written)


class OpCounter(TorchDispatchMode):
    """A dispatch mode that tallies each aten op's FLOPs, HBM bytes and
    collective bytes (module docstring) while it is active, and takes the
    closed-form charges of the recurrences' wrappers on ``meta``."""

    def __init__(self):
        super().__init__()
        self.counts: collections.Counter = collections.Counter()

    def __enter__(self):
        _build.META_CHARGES.append(self.charge)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.META_CHARGES.remove(self.charge)
        return super().__exit__(*exc)

    def charge(self, op: str, flops: float, hbm_bytes: float) -> None:
        self.counts[(op, float(flops), float(hbm_bytes), None, 1, 0)] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        key = (func.namespace, packet.__name__)
        flops = float(flop_registry[packet](*args, **kwargs, out_val=out)) \
            if packet in flop_registry else 0.0
        if key in _NO_DATA:
            return out
        if key in _COLLECTIVES:
            nbytes, out_bytes = _collective_bytes(args, out)
            self.counts[(str(packet), flops, float(nbytes), _COLLECTIVES[key],
                         _group_size(func, args), out_bytes)] += 1
            return out
        if func.namespace in ("c10d", "_c10d_functional"):
            raise NotImplementedError(f"{func}: a collective the op counter does not know")
        name = key[1]
        if name not in MATERIALIZING_OPS:
            if flops:
                raise NotImplementedError(f"{func}: FLOPs of an op whose bytes are not known")
            return out
        first = func._schema.arguments[0].alias_info if func._schema.arguments else None
        if first is not None and first.is_write:
            # in place: the destination is not read; it takes the update
            update = _bytes((args[1:], kwargs))
            nbytes = update + (_bytes(args[0]) if name == "copy_" else update)
        else:
            nbytes = _bytes((args, kwargs)) + _bytes(out)
        self.counts[(str(packet), flops, float(nbytes), None, 1, 0)] += 1
        return out

    def entries(self) -> list[dict]:
        """The tally, one dict a distinct op record with its ``count``."""
        return [{"op": op, "flops": f, "bytes": b, "collective": c, "group": g,
                 "out_bytes": ob, "count": n}
                for (op, f, b, c, g, ob), n in sorted(self.counts.items(), key=str)]

    def stats(self) -> HloStats:
        return stats_from_entries(self.entries())


def stats_from_entries(entries: list[dict]) -> HloStats:
    """The per-rank terms of an op log (:meth:`OpCounter.entries`); the
    transmitted bytes of each collective from its output bytes and group
    size by ``analysis._operand_bytes``."""
    by_op = dict.fromkeys(COLLECTIVE_OPS, 0.0)
    counts = dict.fromkeys(COLLECTIVE_OPS, 0.0)
    flops = hbm = 0.0
    for e in entries:
        n = e["count"]
        flops += n * e["flops"]
        hbm += n * e["bytes"]
        if e["collective"]:
            by_op[e["collective"]] += n * _operand_bytes(e["collective"], e["out_bytes"],
                                                         e["group"])
            counts[e["collective"]] += n
    return HloStats(flops=flops, hbm_bytes=hbm, collective_bytes=sum(by_op.values()),
                    collective_by_op=by_op, collective_counts=counts)


def analyze_step(fn, *args, **kwargs) -> HloStats:
    """``fn(*args, **kwargs)`` run under an :class:`OpCounter`: its per-rank
    terms."""
    with OpCounter() as counter:
        fn(*args, **kwargs)
    return counter.stats()
