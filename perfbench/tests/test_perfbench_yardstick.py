"""The yardstick on the CPU: the counts against figures the chip runs
printed (PERF.md's table of kernels), the trace reduction, the percentile,
and the weights drawn by block."""
import itertools

import pytest
import torch

from perfbench.lib import counts, stats, weights
from perfbench.lib.cell import ROOT, load_module
from perfbench.lib.trace import Trace, short_name, union

HYMBA = load_module(ROOT / "perfbench/configs/hymba-1.5b.py")
RWKV = load_module(ROOT / "perfbench/configs/rwkv6-3b.py")
CFG = {name: __import__("json").load(open(ROOT / f"perfbench/configs/{name}.json"))
       for name in ("hymba-1.5b", "rwkv6-3b")}


def us(work):
    return work.bound_s * 1e6


def test_kernel_bounds_match_the_chip_runs_figures():
    # PERF.md's table of kernels: K5′ 81.4 µs and K6′ 37.6 µs, operations;
    # K3 3.14 µs and K6 1.63 µs, bytes; K2 13.58 / 10.18 µs, operations
    assert round(us(counts.ssm_scan_backward(2, 2048, 3200, 16)), 1) == 81.4
    assert counts.ssm_scan_backward(2, 2048, 3200, 16).bound_by == "operations"
    assert round(us(counts.wkv_backward(8, 40, 128, 64)), 1) == 37.6
    assert round(us(counts.decode_attention(4, 25, 5, 64, 2048)), 2) == 3.14
    assert counts.decode_attention(4, 25, 5, 64, 2048).bound_by == "bytes"
    assert round(us(counts.wkv(4, 1, 40, 64)), 2) == 1.63
    assert round(us(counts.attention(1, 2048, 25, 5, 64)), 2) == 13.58
    assert round(us(counts.attention(1, 2048, 25, 5, 64, 1024)), 2) == 10.18


def test_decode_weight_reads_match_the_chip_runs_figures():
    # PERF.md §2: hymba-1.5b 3.23 GB, rwkv6-3b 5.86 GB (4 slots' embedding rows)
    assert round(HYMBA.weight_bytes(CFG["hymba-1.5b"]) / 1e9, 2) == 3.23
    cfg = CFG["rwkv6-3b"]
    gathered = 4 * cfg["d_model"] * 2
    assert round((RWKV.weight_bytes(cfg, embed=False) + gathered) / 1e9, 2) == 5.86


@pytest.mark.parametrize("s,window", [(1, 0), (7, 3), (16, 16), (33, 8), (64, 0)])
def test_visible_keys_counts_the_mask(s, window):
    want = sum(1 for i, j in itertools.product(range(s), repeat=2)
               if j <= i and (window <= 0 or j > i - window))
    assert counts.visible_keys(s, window) == want


def test_step_works_bound_by_what_they_should():
    cfg = CFG["hymba-1.5b"]
    step, per = HYMBA.decode_work(cfg, 32, 4096, 2048)
    assert step.bound_by == "bytes" and len(per["K3"]) == 32
    assert step.bytes > HYMBA.weight_bytes(cfg)
    step, per = HYMBA.prefill_work(cfg, 2048)
    assert step.bound_by == "operations" and len(per["K2"]) == 32
    assert 6.3e12 < step.flops < 7e12
    step, per = RWKV.train_work(CFG["rwkv6-3b"], 8, 128)
    assert 17e12 < step.flops < 19e12 and len(per["K6bwd"]) == 32


def test_union_and_percentile():
    assert union([(0, 2), (1, 3), (5, 6)]) == 4
    assert union([]) == 0
    assert stats.percentile([5, 1, 4, 2, 3], 95) == 5
    assert stats.percentile(range(1, 101), 95) == 95
    assert stats.percentile([1.0, float("inf")], 50) == 1.0


def _events():
    ann = lambda n, ts, dur: {"ph": "X", "cat": "user_annotation", "name": n, "ts": ts, "dur": dur}  # noqa: E731
    op = lambda n, ts, dur: {"ph": "X", "cat": "kernel", "name": n, "ts": ts, "dur": dur}  # noqa: E731
    return [ann("window", 100, 100), ann("submit", 100, 40), ann("decode_tick", 150, 50),
            op("void repro::flash_tc_kernel<64>(repro::P)", 105, 20),
            op("void repro::decode_split_kernel<bf16, 64>(repro::D)", 160, 10),
            op("void repro::decode_split_kernel<bf16, 64>(repro::D)", 170, 20),
            op("outside", 10, 5)]


def test_trace_reduces_busy_time_gaps_and_kernels():
    tr = Trace(_events())
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(50e-6)
    assert tr.kernel("decode_split_kernel", "decode_tick") == (2, pytest.approx(30e-6))
    assert tr.kernel("decode_split_kernel", "submit") == (0, 0.0)
    assert tr.kernel("flash_") == (1, pytest.approx(20e-6))
    gaps = dict(tr.idle_gaps())
    # a gap is labelled by the span open where it begins: 100-105 and 125-160
    # begin inside submit, 190-200 inside decode_tick
    assert gaps == {"submit": pytest.approx(40e-6), "decode_tick": pytest.approx(10e-6)}
    assert short_name("void repro::decode_split_kernel<bf16, 64>(repro::D)") == \
        "repro::decode_split_kernel"
    assert dict(tr.top_ops())["repro::decode_split_kernel"] == pytest.approx(30e-6)


def test_a_block_draws_alone_what_the_whole_draw_gave():
    cfg = dict(CFG["rwkv6-3b"], n_layers=3, d_model=32, d_ff=64, vocab_size=50,
               rwkv_head_size=8, rwkv_decay_lora=4, rwkv_mix_lora=4)
    params = RWKV.empty_params(cfg, "cpu")
    blocks = RWKV.fills(cfg, params)
    weights.fill(blocks, 2**40 + 3)
    for i in (0, 3):
        for (leaf, _), v in zip(blocks[i], weights.draw_block(blocks[i], 2**40 + 3, i)):
            assert torch.equal(leaf, v)
    other = RWKV.empty_params(cfg, "cpu")
    weights.fill(RWKV.fills(cfg, other), 2**40 + 4)
    assert not torch.equal(other["head"], params["head"])
    assert torch.equal(params["layers"]["mu"], torch.full_like(params["layers"]["mu"], 0.5))


def test_roofline_share_charges_each_traced_launch_the_mean_bound():
    from perfbench.lib.roofline import share
    tr = Trace(_events())
    per_call = [counts.Work(bytes=counts.HBM_BYTES_PER_S * 5e-6),
                counts.Work(bytes=counts.HBM_BYTES_PER_S * 15e-6)]
    # two launches in decode_tick, 30 µs of device time, 10 µs of bound each
    assert share(tr, "decode_split_kernel", "decode_tick", per_call) == pytest.approx(
        100 * 20 / 30)
    assert share(tr, "decode_split_kernel", "submit", per_call) is None
