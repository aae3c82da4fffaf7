"""Cells at a size the CPU runs in seconds, for the tests: each
configuration cut to a few narrow layers, each mix to a few slots, the
reference and the limits the cell's own."""
from __future__ import annotations

import dataclasses

from perfbench.lib.cell import ROOT, load, load_module, read_json

SMOKE_CONFIGS = {
    "hymba-1.5b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                       vocab_size=256, ssm_state=8, d_inner=128, window=16, global_layers=[0]),
    "rwkv6-3b": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256,
                     rwkv_head_size=16, rwkv_decay_lora=8, rwkv_mix_lora=8),
}
SMOKE_SERVE = dict(engine=dict(n_slots=4, max_seq_len=64, prefill_bucket=32, max_new_tokens=8,
                               controller=True, eos_token=-1),
                   clients=4, prompt_tokens=dict(median=20, sigma=0.6),
                   output_tokens=dict(median=4, sigma=0.5), pool=64, warmup_ticks=2,
                   trace_ticks=4, check_requests=8)
SMOKE_TRAIN = dict(batch=4, seq=16)
#: the limits at smoke size: a narrow model's logits spread less (a random
#: token lies at most about 0.8 below the best, against several at full
#: width) and its steps move differently, so the cells' own limits, set at
#: full size, do not carry over. Set between this size's sound readings
#: (served_gap 2e-4; loss_gap 3.9e-5 and 5.4e-4, grad_median_gap 3.3e-4 and
#: 1.9e-3, change_gap 3.1e-2, hymba-1.5b's and rwkv6-3b's) and its faults'
#: (a token altered 0.78; half of the batch 1.9e-3 and 2.7e-2; a state left
#: unchanged 1.0).
SMOKE_LIMITS = {"served_gap": 0.05, "loss_gap": 1e-3, "grad_median_gap": 5e-3, "change_gap": 0.3}


def smoke_cell(workload: str, config: str | None = None, **changes):
    """The cell ``workload`` of BENCHMARK.json at smoke size, on the
    configuration ``config`` (the cell's own by default), its configuration
    file's keys updated by ``changes`` (``dtype="float32"``)."""
    cell = load(workload, read_json(ROOT / "BENCHMARK.json"))
    if config is not None:
        cell = dataclasses.replace(
            cell, config=read_json(ROOT / "perfbench" / "configs" / f"{config}.json"),
            reference=load_module(ROOT / "perfbench" / "configs" / f"{config}.py"))
    cfg = dict(cell.config, **SMOKE_CONFIGS[cell.config["name"]], **changes)
    small = SMOKE_SERVE if cell.traffic["kind"] == "serve" else SMOKE_TRAIN
    limits = {k: SMOKE_LIMITS[k] for k in cell.limits}
    return dataclasses.replace(cell, config=cfg, traffic=dict(cell.traffic, **small),
                               limits=limits)
