"""Roofline terms of a dry-run cell, as the JAX package's
``roofline/analysis.py``, under an NVIDIA H100's constants:

    compute term    = FLOPs / peak FLOP/s
    memory term     = HBM bytes / HBM bandwidth
    collective term = collective bytes / link bandwidth

each per rank, from ``op_count.HloStats`` (the step's per-rank program run
under the op counter), so no division by the rank count is applied.

Constants (NVIDIA's H100 SXM data sheet, dense, at its 700-W limit):
989 TFLOP/s bf16, 3.35 TB/s HBM3, and NVLink 4's 450 GB/s a direction for
the collectives, which holds within a node of 8 cards. A 16 x 16 or
2 x 16 x 16 mesh spans 32 or 64 such nodes, and a collective between nodes
runs at :data:`CROSS_NODE_BW`, one 400 Gb/s NDR InfiniBand port a card
(50 GB/s), 9x slower; ``roofline/report.py`` names it beside the table.

The reference's HLO text parser (``collective_bytes_from_hlo``) has no
counterpart: the port has no HLO, and ``op_count`` reads the collectives off
the ops as they run.
"""
from __future__ import annotations

import dataclasses

#: bf16 dense FLOP/s of one H100 SXM
PEAK_FLOPS = 989e12
#: HBM3 bytes/s of one H100 SXM
HBM_BW = 3.35e12
#: NVLink 4 bytes/s a direction (18 links of 25 GB/s) within a node
ICI_BW = 450e9
#: bytes/s between nodes: one 400 Gb/s NDR InfiniBand port a card
CROSS_NODE_BW = 50e9

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")


def _operand_bytes(op: str, out_bytes: int, group_size: int) -> int:
    """Derive per-device operand (transmitted) bytes from the output type."""
    if op == "all-gather":
        return out_bytes // max(group_size, 1)
    if op == "reduce-scatter":
        return out_bytes * max(group_size, 1)
    return out_bytes  # all-reduce / all-to-all / collective-permute


@dataclasses.dataclass
class RooflineTerms:
    flops: float                 # per-rank FLOPs of the step's dots
    hbm_bytes: float             # per-rank HBM traffic of its materialising ops
    collective_bytes: float      # per-rank collective transmitted bytes
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float           # useful flops per rank (6*N*D etc.)
    useful_fraction: float       # model_flops / flops
    roofline_bound_s: float      # max of the three terms
    cost_analysis_flops: float   # the reference's cost_analysis values: none here
    cost_analysis_bytes: float

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def derive_terms(cost: dict, hlo_stats, n_chips: int,
                 model_flops_global: float,
                 peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                 ici_bw: float = ICI_BW) -> RooflineTerms:
    """hlo_stats: ``op_count.HloStats`` of the per-rank program (the
    reference's ``hlo_parse.HloStats`` works alike); ``ici_bw`` the
    collective link's bytes/s.

    model_flops_global: useful math for the step across ALL ranks
    (6*N_active*tokens for training; 2*N_active*tokens for inference).
    ``cost`` is the reference's raw ``cost_analysis`` dict, which the port
    does not have: pass ``{}``.
    """
    flops = float(hlo_stats.flops)
    hbm = float(hlo_stats.hbm_bytes)
    cbytes = float(hlo_stats.collective_bytes)
    compute_s = flops / peak_flops
    memory_s = hbm / hbm_bw
    collective_s = cbytes / ici_bw
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)  # type: ignore[arg-type]
    model_flops = model_flops_global / n_chips
    useful = model_flops / flops if flops else 0.0
    return RooflineTerms(
        flops=flops, hbm_bytes=hbm, collective_bytes=cbytes,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        bottleneck=bottleneck, model_flops=model_flops,
        useful_fraction=useful,
        roofline_bound_s=max(terms.values()),
        cost_analysis_flops=float(cost.get("flops", 0.0)),
        cost_analysis_bytes=float(cost.get("bytes accessed", 0.0)))
