"""Generate the §Roofline markdown table from the port's dry-run reports,
as the JAX package's ``roofline/report.py``, under an H100's constants.

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir reports/dryrun_torch]

The terms are derived figures for one H100 per rank, not measured times.
"""
from __future__ import annotations

import argparse
import json
import pathlib

from repro_torch.launch.dryrun import MESH_RANKS
from repro_torch.roofline import analysis


def one_liner(r: dict) -> str:
    """One sentence on what would move the dominant term down."""
    rf = r["roofline"]
    b = rf["bottleneck"]
    shape = r["shape"]
    if b == "memory" and shape in ("train_4k", "prefill_32k"):
        return ("attention-score traffic dominates: K2's tiles keep scores on chip "
                "in the forward; a fused K2 backward would rebuild P tile by tile "
                "(attn_block_remat bounds it meanwhile)")
    if b == "memory":
        return ("KV/weight streaming bound: K3 reads the cache grouped per kv head; "
                "batch more sequences per step")
    if b == "collective":
        return ("the whole-leaf gathers of the redundant model axis dominate: "
                "tensor/sequence parallelism, reduce-scatter gradients, NCCL "
                "overlapped with the backward")
    return "compute-bound: larger tiles, fewer recomputed products"


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="reports/dryrun_torch")
    ap.add_argument("--out", default="reports/roofline_table_torch.md")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)

    rows = []
    for path in sorted(pathlib.Path(args.dir).glob(f"*__{args.mesh}.json")):
        r = json.loads(path.read_text())
        if r["status"] == "skipped":
            rows.append((r["arch"], r["shape"], "skipped", None, r.get("reason", "")))
        elif r["status"] == "ok":
            rows.append((r["arch"], r["shape"], "ok", r, one_liner(r)))
        else:
            rows.append((r["arch"], r["shape"], "error", None,
                         r.get("error", "")[:80]))

    ranks = MESH_RANKS.get(args.mesh, 1)
    lines = [
        f"# §Roofline — baseline table ({args.mesh} mesh, {ranks} ranks, the port's "
        "per-rank program)",
        "",
        f"Terms in seconds per step and rank, derived (not measured) under H100 constants: "
        f"{analysis.PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, {analysis.HBM_BW / 1e12:.2f} TB/s "
        f"HBM, {analysis.ICI_BW / 1e9:.0f} GB/s NVLink 4 a direction for the collectives. "
        f"Between nodes of 8 a collective runs at {analysis.CROSS_NODE_BW / 1e9:.0f} GB/s "
        f"(one 400 Gb/s NDR InfiniBand port a card): its term "
        f"{analysis.ICI_BW / analysis.CROSS_NODE_BW:.0f}x the one shown. HBM bytes count "
        "materialising ops only (a lower bound). Each rank gathers the parameters whole "
        "and computes the model axis redundantly, so MODEL_FLOPS/FLOPs falls with the "
        "model axis's width.",
        "",
        "| arch | shape | compute_s | memory_s | collective_s | bottleneck | "
        "MODEL_FLOPS/FLOPs | note |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for arch, shape, status, r, note in rows:
        if status != "ok":
            lines.append(f"| {arch} | {shape} | — | — | — | {status} | — | {note} |")
            continue
        rf = r["roofline"]
        lines.append(
            f"| {arch} | {shape} | {rf['compute_s']:.4f} | {rf['memory_s']:.4f} "
            f"| {rf['collective_s']:.4f} | **{rf['bottleneck']}** "
            f"| {rf['useful_fraction']:.3f} | {note} |")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text("\n".join(lines) + "\n")
    print(f"wrote {out} ({len(rows)} cells)")


if __name__ == "__main__":
    main()
