"""The readers of the program's own spans and marks on hand-made traces:
each gives the value worked out by hand; the train step's parts sum to the
busy time between its first and last marks; the engine's graph gaps, the idle before each
graph's first kernel and the host idle, with the idle under the harness's
spans alone, sum to the whole idle; a dropped mark, a
missing span or no trace reads None."""
import random

import pytest

from perfbench.lib import spans
from perfbench.lib.cell import HERE, load_module
from perfbench.lib.trace import Trace


def reader(name):
    return load_module(HERE / "metrics" / f"{name}.py")


def ann(name, ts, end):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": end - ts}


def op(name, ts, end):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": end - ts}


def serve_events(engine=True):
    """Two ticks in 1,000 µs: a submit (its prefill) and a decode tick, then
    a decode tick alone. Device ops: 20-25, 40-100, 110-190, 210-240,
    331-333 (the decode graph's input copy), 335-400, 400-495, 750-890 (477
    µs busy, 523 idle)."""
    harness = [ann("window", 0, 1000), ann("submit", 0, 300), ann("decode_tick", 300, 700),
               ann("client", 700, 720), ann("decode_tick", 720, 1000)]
    program = [ann("engine.submit", 10, 290), ann("engine.stage", 10, 30),
               ann("engine.prefill", 30, 200), ann("engine.splice_cache", 200, 250),
               ann("engine.first_token", 250, 280),
               ann("engine.decode_tick", 310, 690), ann("engine.stage", 310, 330),
               ann("engine.decode", 330, 500), ann("engine.read_tokens", 500, 520),
               ann("engine.controller", 600, 650),
               ann("engine.decode_tick", 730, 990), ann("engine.decode", 740, 900),
               ann("engine.controller", 950, 960)]
    ops = [op("Memcpy HtoD (Pageable -> Device)", 20, 25),
           op("void repro::flash_tc_kernel<64>()", 40, 100),
           op("at::native::elementwise_kernel", 110, 190),
           op("Memcpy DtoD (Device -> Device)", 210, 240),
           op("Memcpy DtoD (Device -> Device)", 331, 333),
           op("void repro::decode_split_kernel<bf16>()", 335, 400), op("gemv", 400, 495),
           op("void repro::decode_split_kernel<bf16>()", 750, 890)]
    return harness + (program if engine else []) + ops


def serve_ctx(**kw):
    return {"trace": Trace(serve_events(**kw))}


def test_engine_readers_give_the_hand_worked_values():
    ctx = serve_ctx()
    # idle under engine.prefill (30-200) from its first kernel (40):
    # 100-110, 190-200; one span
    assert spans.graph_gaps(ctx["trace"], "engine.prefill") == pytest.approx([20])
    # under engine.decode (330-500, 740-900) from the first kernel, not the
    # input copy (335, 750): 495-500, then 890-900; the median of the two
    assert reader("engine.decode_graph_gap_ms").read(ctx) == pytest.approx(7.5 / 1e3)
    # under engine.* outside the phases: 10-20, 25-30, 200-210, 240-290,
    # 310-330, 500-690, 730-740, 900-990 = 385 µs over two decode ticks
    assert reader("engine.idle_host_ms_per_tick").read(ctx) == pytest.approx(192.5 / 1e3)
    # engine.controller spans: 50 + 10 µs over two decode ticks
    assert reader("engine.controller_ms_per_tick").read(ctx) == pytest.approx(30 / 1e3)


def test_engine_idle_partitions_the_whole_idle():
    tr = Trace(serve_events())
    whole = tr.window_s * 1e6 - tr.busy_s * 1e6
    ctx = {"trace": tr}
    count = {"engine.decode_tick": len(spans.spans(tr, "engine.decode_tick"))}
    harness_only = spans.overlap(spans.idle(tr), spans.minus(
        [tr.window], spans.merged(spans.engine_spans(tr))))
    parts = (sum(spans.graph_gaps(tr, "engine.prefill")) / 1e3
             + sum(spans.graph_gaps(tr, "engine.decode")) / 1e3
             + reader("engine.idle_host_ms_per_tick").read(ctx) * count["engine.decode_tick"])
    before_first_kernel = 10 + 1 + 2 + 10             # 30-40, 330-331, 333-335, 740-750
    assert harness_only == pytest.approx(80)          # 0-10, 290-310, 690-730, 990-1000
    assert parts * 1e3 + before_first_kernel + harness_only == pytest.approx(whole)
    assert whole == pytest.approx(523)


def test_a_graph_gap_is_the_median_over_the_spans():
    """A third decode span, stalled 300 µs mid-graph, moves the mean but not
    the median; a span that holds only a copy counts no gap."""
    events = serve_events() + [
        ann("engine.decode", 1000, 1400), op("void repro::rmsnorm_kernel()", 1005, 1050),
        op("gemv", 1350, 1395), ann("engine.decode", 1500, 1600),
        op("Memcpy DtoD (Device -> Device)", 1510, 1520)]
    events[0] = ann("window", 0, 2000)
    tr = Trace(events)
    assert spans.graph_gaps(tr, "engine.decode") == pytest.approx([5, 10, 305])
    assert reader("engine.decode_graph_gap_ms").read({"trace": tr}) == pytest.approx(10 / 1e3)


@pytest.mark.parametrize("name", ["engine.decode_graph_gap_ms",
                                  "engine.idle_host_ms_per_tick",
                                  "engine.controller_ms_per_tick"])
def test_engine_readers_read_nothing_without_the_engines_spans(name):
    assert reader(name).read(serve_ctx(engine=False)) is None
    assert reader(name).read({"trace": None}) is None


def train_events(drop=None):
    """Two steps. Step 1: marks at 100, 300, 700, 900; step 2 at 1100, 1250,
    1700, 1800; each mark 2 µs; a batch copy before and the loss's copy
    after each step, outside the marks. ``drop``: the index of a mark left
    out, or "all"."""
    marks = [("forward", 100), ("backward", 300), ("update", 700), ("done", 900),
             ("forward", 1100), ("backward", 1250), ("update", 1700), ("done", 1800)]
    events = [ann("window", 0, 2000), ann("step", 40, 950), ann("step", 1040, 1950)]
    events += [op(f"repro::mark_{k}()", t, t + 2) for i, (k, t) in enumerate(marks)
               if drop not in (i, "all")]
    events += [op("memcpy", 50, 60), op("a", 102, 200), op("b", 210, 290), op("c", 302, 500),
               op("d", 500, 690), op("e", 702, 800), op("f", 850, 895), op("memcpy", 920, 925),
               op("memcpy", 1050, 1060), op("a", 1102, 1200), op("c", 1252, 1690),
               op("e", 1702, 1790), op("memcpy", 1820, 1825)]
    return events


def train_ctx(drop=None, steps=2):
    return {"trace": Trace(train_events(drop)), "traced_steps": steps}


def test_step_parts_give_the_hand_worked_values():
    ctx = train_ctx()
    # forward: 100-200 and 210-290 (180), then 1100-1200 (100)
    assert reader("step.forward_ms").read(ctx) == pytest.approx(140 / 1e3)
    # backward: 300-690 (390), then 1250-1690 (440)
    assert reader("step.backward_ms").read(ctx) == pytest.approx(415 / 1e3)
    # update: 700-800 and 850-895 (145), then 1700-1790 (90); the done mark is
    # the end, not a part
    assert reader("step.update_ms").read(ctx) == pytest.approx(117.5 / 1e3)


def test_step_parts_sum_to_the_busy_time_between_the_marks():
    ctx = train_ctx()
    total = sum(reader(n).read(ctx) for n in ("step.forward_ms", "step.backward_ms",
                                              "step.update_ms"))
    marked = spans.steps(ctx["trace"], 2)
    busy = [spans.busy(ctx["trace"], m["forward"], m["done"]) for m in marked]
    assert busy == pytest.approx([715, 630])
    assert total * 1e3 == pytest.approx(sum(busy) / 2)


@pytest.mark.parametrize("name", ["step.forward_ms", "step.backward_ms", "step.update_ms"])
@pytest.mark.parametrize("ctx", [train_ctx(drop=6), train_ctx(drop=0), train_ctx(steps=3),
                                 train_ctx(drop="all"), {"trace": None, "traced_steps": 2}],
                         ids=["dropped-update", "dropped-forward", "a-step-short", "no-marks",
                              "no-trace"])
def test_step_parts_read_nothing_without_every_mark(name, ctx):
    assert reader(name).read(ctx) is None


@pytest.mark.parametrize("seed", range(20))
def test_interval_algebra_matches_a_grid(seed):
    rng = random.Random(seed)

    def draw():
        out = []
        for _ in range(rng.randrange(0, 8)):
            lo = rng.randrange(0, 60)
            out.append((lo, lo + rng.randrange(0, 15)))
        return out

    a, b = draw(), draw()
    ga = {x for lo, hi in a for x in range(lo, hi)}
    gb = {x for lo, hi in b for x in range(lo, hi)}
    ma, mb = spans.merged(a), spans.merged(b)
    assert sum(hi - lo for lo, hi in ma) == len(ga)
    assert spans.overlap(ma, mb) == len(ga & gb)
    diff = spans.minus(ma, mb)
    assert {x for lo, hi in diff for x in range(lo, hi)} == ga - gb
    assert diff == spans.merged(diff)
