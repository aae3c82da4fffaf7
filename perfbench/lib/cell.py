"""A cell of ``BENCHMARK.json`` and the files the harness finds by its names:
the configuration (``configs/<config>.json`` and its reference
``configs/<config>.py``), the traffic mix (``traffic/<traffic>.json``), the
cell's own limits (``cells/<workload>.json``), the driver of the mix's kind
(``kinds/<kind>.py``) and each metric's reader (``metrics/<metric>.py``).
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent      # perfbench/
ROOT = HERE.parent


def load_module(path: Path, name: str | None = None):
    """The Python file at ``path`` as a module, registered as ``name``
    (by default one made from the file's name, which need not be an
    identifier)."""
    name = name or "perfbench_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    reader: object            # module with read(ctx) -> float | None


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict              # the configuration file, as run
    reference: object         # its plain reference, a module
    traffic: dict
    limits: dict[str, float]
    end_to_end: list[Metric]
    per_layer: list[Metric]


def _reports(entry: dict, workload: str, reported: set[str]) -> bool:
    """Whether a metric entry belongs to ``workload``: it lists the cell,
    or lists none and the cell reports the end-to-end metric it moves."""
    if "workloads" in entry:
        return workload in entry["workloads"]
    return entry.get("moves") is None or entry["moves"] in reported


def load(workload: str, bench: dict | None = None) -> Cell:
    bench = bench if bench is not None else read_json(ROOT / "BENCHMARK.json")
    try:
        w = next(x for x in bench["workloads"] if x["name"] == workload)
    except StopIteration:
        raise SystemExit(f"unknown workload {workload!r}") from None
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    cfg_path = ROOT / cfg_entry["file"]
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload, set())]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"] if _reports(m, workload, reported)]

    def metric(m: dict) -> Metric:
        reader = None if m["name"] == "setup_s" else load_module(HERE / "metrics" / f"{m['name']}.py")
        return Metric(m["name"], m["unit"], reader)

    return Cell(name=workload, chips=w["chips"], config=read_json(cfg_path),
                reference=load_module(cfg_path.with_suffix(".py")),
                traffic=read_json(HERE / "traffic" / f"{w['traffic']}.json"),
                limits=read_json(HERE / "cells" / f"{workload}.json")["limits"],
                end_to_end=[metric(m) for m in e2e], per_layer=[metric(m) for m in layer])


def model_config(cfg: dict):
    """The program's ``ModelConfig`` of a configuration file: its fields
    that the dataclass has."""
    from repro_torch.configs.base import ModelConfig
    names = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items() if k in names}
    out = ModelConfig(**kw)
    out.validate()
    return out


def flatten(tree, prefix: tuple = ()) -> dict[tuple, object]:
    """A tree of dicts and lists as {path: leaf}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten(v, prefix + (k,)))
    return out


def same_layout(tree, like) -> None:
    """Raise unless the two trees have the same paths, shapes and dtypes."""
    a, b = flatten(tree), flatten(like)
    if a.keys() != b.keys():
        raise ValueError(f"parameter trees differ: {sorted(set(a) ^ set(b))[:6]}")
    for p in a:
        if tuple(a[p].shape) != tuple(b[p].shape) or a[p].dtype != b[p].dtype:
            raise ValueError(f"leaf {p}: {tuple(a[p].shape)} {a[p].dtype} against "
                             f"{tuple(b[p].shape)} {b[p].dtype}")
