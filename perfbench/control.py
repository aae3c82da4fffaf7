#!/usr/bin/env python3
"""The control of a cell's ``correct``, and the readings its limits are set
from: the reference put in the program's place and computed in float8
(e4m3, both operands of every matrix product rounded, a scale a row of
activations and a column of weights), the step below the configurations'
bfloat16.

    python3 perfbench/control.py --workload <name> --seeds 11,12,13 [--seconds 5]

Serving: each seed runs the cell for ``--seconds`` and replays the finished
sample through the reference twice, in float32 and in float8; it prints the
program's reading (the served tokens' widest gap) beside the control's (the
gap of the tokens float8 puts first). Training: each seed runs the
reference's set-up steps in float32, in float8, and on half of each batch
(the mean over the rest, a fault), and prints the float8 and half-batch
steps' readings against the float32 ones; the program is not run. Needs a
CUDA device; the benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def serve_readings(cell, kind, seed: int, seconds: float, device: str) -> dict:
    from perfbench.lib import compare
    ctx = kind.run(cell, seed, seconds, False, device=device)
    check = ctx["check"]
    rows = check["sample"]
    ec = ctx["ec"]
    low = kind.reference_logits(cell, rows, min(ec.prefill_bucket, ec.max_seq_len),
                                ec.max_seq_len, seed, device,
                                mm=compare.fp8_mm)
    return {"served_gap": check["gap"],
            "control_gap": max(compare.control_gaps(check["logits"], low)),
            "rows": check["rows"], "tokens": check["tokens"]}


def train_readings(cell, kind, seed: int, device: str) -> dict:
    from perfbench.lib import compare
    want = kind.reference_steps(cell, seed, device)
    moved = compare.moved_leaves(want["grad"])
    out = {}
    half = slice(0, cell.traffic["batch"] // 2)
    for label, kw in (("fp8", {"mm": compare.fp8_mm}), ("half_batch", {"rows": half})):
        got = kind.reference_steps(cell, seed, device, **kw)
        out[label] = {
            "loss_gap": max(compare.relative(a, b) for a, b in zip(got["loss"], want["loss"])),
            "grad_median_gap": compare.median_leaf_gap(got["grad"], want["grad"]),
            "grad_worst_gap": compare.leaf_gap(got["grad"], want["grad"])[0],
            "change_gap": compare.leaf_gap(got["change"], want["change"], moved)[0]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.lib.cell import HERE, load, load_module
    cell = load(args.workload)
    kind = load_module(HERE / "kinds" / f"{cell.traffic['kind']}.py")
    for seed in (int(s) for s in args.seeds.split(",")):
        if cell.traffic["kind"] == "serve":
            r = serve_readings(cell, kind, seed, args.seconds, args.device)
        else:
            r = train_readings(cell, kind, seed, args.device)
        print(json.dumps({"workload": cell.name, "seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
