"""Re-derive roofline terms for existing dry-run reports from their cached
op logs, as the JAX package's ``roofline/rederive.py`` does from cached HLO.

Accounting changes (``op_count.stats_from_entries``, ``analysis``) apply
retroactively without retracing:

    PYTHONPATH=src python -m repro_torch.roofline.rederive [--dir reports/dryrun_torch]
"""
from __future__ import annotations

import argparse
import gzip
import json
import pathlib

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch.dryrun import model_flops_global, shape_spec
from repro_torch.roofline import analysis as roofline
from repro_torch.roofline.op_count import stats_from_entries


def rederive(directory: pathlib.Path, smoke: bool = False) -> int:
    """Recompute ``roofline`` and ``collectives`` of every ``ok`` report in
    ``directory`` that has its op log beside it; returns how many."""
    n = 0
    for jpath in sorted(directory.glob("*.json")):
        r = json.loads(jpath.read_text())
        lpath = jpath.parent / (jpath.stem + ".ops.json.gz")
        if r["status"] != "ok" or not lpath.exists():
            continue
        with gzip.open(lpath, "rt") as f:
            stats = stats_from_entries(json.load(f))
        cfg = get_smoke_config(r["arch"]) if smoke else get_config(r["arch"])
        cost = {"flops": r["roofline"].get("cost_analysis_flops", 0.0),
                "bytes accessed": r["roofline"].get("cost_analysis_bytes", 0.0)}
        terms = roofline.derive_terms(cost, stats, r["n_chips"],
                                      model_flops_global(cfg, shape_spec(r["shape"])))
        r["roofline"] = terms.as_dict()
        r["collectives"] = {"total_bytes": stats.collective_bytes,
                            "by_op": stats.collective_by_op,
                            "counts": stats.collective_counts}
        jpath.write_text(json.dumps(r, indent=1, default=str))
        n += 1
    return n


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="reports/dryrun_torch")
    ap.add_argument("--smoke", action="store_true",
                    help="the reports are of reduced configs (dryrun --smoke)")
    args = ap.parse_args(argv)
    print(f"re-derived {rederive(pathlib.Path(args.dir), args.smoke)} reports")


if __name__ == "__main__":
    main()
