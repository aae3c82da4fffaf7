"""Frontier serialization and human-readable reporting.

JSON schema is flat and stable: one object with sweep metadata plus a list
of per-config outcomes (params, energy saved, modeled penalty, Pareto flag,
per-job CDFs), so downstream dashboards can diff sweeps across fleet
snapshots.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

from repro_torch.core.energy import energy_kwh
from repro_torch.whatif.sweep import Frontier, PolicyOutcome

SCHEMA_VERSION = 1


def frontier_to_dict(frontier: Frontier) -> dict:
    return {
        "schema_version": SCHEMA_VERSION,
        "n_rows": frontier.n_rows,
        "n_jobs": frontier.n_jobs,
        "n_runs": frontier.n_runs,
        "coverage": frontier.coverage,
        "trace": [dict(t) for t in frontier.trace],
        "outcomes": [dataclasses.asdict(o) for o in frontier.outcomes],
    }


def frontier_from_dict(payload: dict) -> Frontier:
    outcomes = []
    for o in payload["outcomes"]:
        o = dict(o)
        o["per_job_saved_fraction"] = tuple(o["per_job_saved_fraction"])
        o["per_job_penalty_s"] = tuple(o["per_job_penalty_s"])
        outcomes.append(PolicyOutcome(**o))
    return Frontier(outcomes=tuple(outcomes),
                    n_rows=payload["n_rows"], n_jobs=payload["n_jobs"],
                    n_runs=payload.get("n_runs", 0),
                    coverage=payload.get("coverage", 1.0),
                    trace=tuple(dict(t) for t in payload.get("trace", ())))


def save_frontier(frontier: Frontier, path: str | pathlib.Path,
                  compact: bool = True) -> pathlib.Path:
    """Write the frontier JSON. ``compact=True`` (default) uses minimal
    separators and no indentation — a dense-grid frontier is ~10k lines
    pretty-printed, one line compact, at identical fidelity (the loader
    accepts both) — pass ``compact=False`` for a human-diffable dump."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    payload = frontier_to_dict(frontier)
    if compact:
        text = json.dumps(payload, separators=(",", ":"))
    else:
        text = json.dumps(payload, indent=1)
    path.write_text(text + "\n")
    return path


def load_frontier(path: str | pathlib.Path) -> Frontier:
    return frontier_from_dict(json.loads(pathlib.Path(path).read_text()))


def format_search_trace(frontier: Frontier) -> str:
    """Render the search convergence trace (one line per round).

    The trace is recorded unconditionally by the closed-loop search
    (``whatif/search.py`` of the JAX package) — it contains only
    deterministic replay results, no wall-clock — so this works on any
    searched frontier, observability on or off. Swept (non-searched)
    frontiers have an empty trace.
    """
    if not frontier.trace:
        return "search trace: empty (frontier was swept, not searched)"
    rounds: dict[int, list[dict]] = {}
    for t in frontier.trace:
        rounds.setdefault(int(t["round"]), []).append(t)
    lines = [f"search trace: {len(frontier.trace)} evals over "
             f"{len(rounds)} rounds",
             f"{'round':>5} {'evals':>6} {'cum':>5} {'best saved %':>12} "
             f"{'families':<32}"]
    best = 0.0
    cum = 0
    for r in sorted(rounds):
        evs = rounds[r]
        cum += len(evs)
        best = max(best, max(t["saved_fraction"] for t in evs))
        fams = sorted({t["family"] for t in evs})
        lines.append(f"{r:5d} {len(evs):6d} {cum:5d} {best:12.2%} "
                     f"{', '.join(fams):<32}")
    return "\n".join(lines)


def _label_params(name: str, p: dict) -> str:
    if p.get("policy") == "composite":
        return " + ".join(_label_params(q.get("policy", "?"), q)
                          for q in p["parts"])
    if name == "downscale":
        return (f"downscale X={p['threshold_x_s']:g} Y={p['cooldown_y_s']:g} "
                f"{p['mode']}")
    if name == "parking":
        return (f"parking {p['n_active']}-of-{p['n_devices']} "
                f"resume={p['resume_latency_s']:g}s")
    if name == "powercap":
        return f"powercap {p['cap_fraction']:.0%} TDP"
    return name


def _label(outcome: PolicyOutcome) -> str:
    return _label_params(outcome.name, outcome.params)


def format_frontier(frontier: Frontier, top: int | None = None) -> str:
    """Text table of the sweep, best energy saving first; ``*`` marks the
    Pareto set."""
    rows = sorted(frontier.outcomes, key=lambda o: -o.energy_saved_j)
    if top is not None:
        rows = rows[:top]
    compaction = ""
    if frontier.n_runs:
        # rows/runs: how run-compressible (idle-dominated) the corpus is —
        # the leverage behind the run-IR replay (paper: execution-idle
        # stretches are long and near-constant)
        compaction = (f" ({frontier.n_runs:,} runs, compaction "
                      f"{frontier.compaction_ratio:.1f}x)")
    lines = [
        f"what-if frontier: {len(frontier.outcomes)} configs, "
        f"{frontier.n_jobs} jobs, {frontier.n_rows:,} samples{compaction}",
        f"{'':2}{'policy':44} {'saved kWh':>10} {'saved %':>8} "
        f"{'penalty s':>10} {'wakes':>7}",
    ]
    for o in rows:
        mark = "* " if o.pareto else "  "
        lines.append(
            f"{mark}{_label(o):44} {energy_kwh(o.energy_saved_j):10.2f} "
            f"{o.saved_fraction:8.1%} {o.penalty_s:10.1f} {o.wake_events:7d}")
    return "\n".join(lines)
