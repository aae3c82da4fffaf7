#!/usr/bin/env python3
"""Card time of K4, the what-if cap-bucket scan, at every padding bucket of
the 10^4-config ``evaluate``, on one NVIDIA GPU (an H100):

    python3 cap_scan_buckets.py [--src PATH] [--label NAME]

Simulates the reference benchmark's fleet (64 devices x 3 h, seed 3, as
``chip_smoke.py`` does), packs its run-level IR as ``evaluate`` does, and at
each of the 7 padding buckets holds K4 against its plain version and
``torch.searchsorted`` on the grid's 7,901 caps, then times it back to back
in a CUDA graph and after an L2-sized read (profiled), beside
``torch.searchsorted`` in both settings and the bounds
(``chip_smoke.cap_buckets``, through the wrapper's two-argument form only).
Last, one profiled 10^4-config ``evaluate``: K4's card time in it.

``--src`` runs another checkout's ``src`` (an earlier commit unpacked with
``git archive``), so two commits' kernels can be compared in one call.
Prints one line per reading and, last, the card's name and power limit.
Imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", type=Path, default=cs.ROOT / "src",
                    help="the checkout's src directory whose kernel to measure")
    ap.add_argument("--label", default="this", help="prefix of every line")
    args = ap.parse_args()
    sys.path.insert(0, str(args.src.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: this sweep runs on the card only", file=sys.stderr)
        return 2
    from repro_torch.cluster import generate_cluster
    from repro_torch.kernels import _build
    from repro_torch.telemetry import TelemetryStore
    from repro_torch.whatif import evaluate, get_ir, ir_config_for
    from repro_torch.whatif import backend as B
    from repro_torch.whatif.policies import PowerCapBatch, make_batches

    dev = torch.device("cuda", 0)
    _build.library()
    log = cs.log
    cs.log = lambda msg: log(f"{args.label} {msg}")
    scratch = cs.ROOT / "build"
    scratch.mkdir(exist_ok=True)
    kw = dict(min_job_duration_s=0.0)
    with tempfile.TemporaryDirectory(dir=scratch) as d:
        store = TelemetryStore(d, shard_format="npy_dir")
        generate_cluster(store=store, **cs.WHATIF_DEPLOYMENT)
        grid = cs.grid_10k()
        packed = B.pack_ir(get_ir(store, ir_config_for(grid)), 5, **kw)
        cap_batch = next(b for b, _ in make_batches(grid) if isinstance(b, PowerCapBatch))
        cs.cap_buckets(dev, packed, cap_batch._fracs, alternatives=False)
        evaluate(grid, store, **kw)
        prof = cs.profile_evaluate(grid, store, kw)
    k4 = {k: v for k, v in prof["repro_kernels_ms"].items() if "cap_bucket_scan" in k}
    launches = {k: v for k, v in prof["repro_kernel_launches"].items() if "cap_bucket_scan" in k}
    cs.log(f"cap_bucket_scan in the profiled 10^4 evaluate: {k4} ms over {launches} launches; "
           f"card busy {prof['card_busy_ms']:.4f} ms")
    print(cs.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
