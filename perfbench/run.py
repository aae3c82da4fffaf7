#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``perfbench/``
and the program under test (``src/repro_torch``). The cell's entry in
``BENCHMARK.json`` names its configuration (``perfbench/configs/``) and its
traffic mix (``perfbench/traffic/``), whose ``kind`` names the driver
(``perfbench/kinds/<kind>.py``); its limits are in ``perfbench/cells/``, and
each metric's reader in ``perfbench/metrics/<metric>.py``. With ``--trace 0``
the line holds the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read over a profiled stretch of the window.

The run needs as many CUDA devices as the cell asks for and exits with
status 2 without them; it never falls back to the CPU. Builds and kernel
caches go under ``build/`` in the checkout. A run that finds JAX or the JAX
package loaded once the window has closed exits with status 3. The last
line of standard output is the result; the last lines of standard error are
the numbers compared for ``correct``, each beside its limit.
"""
import time

T0 = time.perf_counter()
T0_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def process_age() -> float:
    """Seconds from this process's start to ``T0`` (0 where /proc is not
    there to say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return max(0.0, T0_WALL - (boot + start_ticks / os.sysconf("SC_CLK_TCK")))
    except (OSError, ValueError, IndexError, StopIteration):
        return 0.0


def use_checkout_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def require_chips(n: int) -> None:
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {n} CUDA device(s); found {found}", file=sys.stderr)
        raise SystemExit(2)


def forbidden_loaded() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def finite(x):
    return x if x is None or math.isfinite(x) else None


def result(cell, ctx: dict, trace: bool, setup_s: float, device: dict) -> dict:
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = setup_s if m.name == "setup_s" else m.reader.read(ctx)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m.name} read nothing")
            continue
        metrics[m.name] = {"value": finite(float(value)), "unit": m.unit}
    checks = {name: {"value": finite(float(v)), "limit": lim}
              for name, (v, lim) in ctx["checks"].items()}
    correct = (all(c["value"] is not None and c["value"] <= c["limit"] for c in checks.values())
               and ctx["failed"] == 0
               and all(v["value"] is not None for v in metrics.values()))
    out = {"correct": correct, "attempted": ctx["attempted"], "failed": ctx["failed"],
           "metrics": metrics, "device": device}
    tr = ctx["trace"]
    if trace and tr is not None:
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        out["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.idle_gaps(10)}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    use_checkout_caches()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from perfbench.lib.cell import HERE, load, load_module
    cell = load(args.workload)
    require_chips(cell.chips)
    import torch

    kind = load_module(HERE / "kinds" / f"{cell.traffic['kind']}.py")
    ctx = kind.run(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_loaded()
    if bad:
        print(f"perfbench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    setup_s = ctx["window"][0] - T0 + process_age()
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": ctx["memory_peak_bytes"]}
    out = result(cell, ctx, bool(args.trace), setup_s, device)
    sys.stdout.flush()
    print(json.dumps(out), flush=True)
    for line in ctx.get("notes", []):
        print(line, file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
