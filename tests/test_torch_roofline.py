"""The port's roofline counting (``repro_torch.roofline``) against the JAX
package's, as tests/test_roofline.py holds ``hlo_parse``:

* the five cases of tests/test_roofline.py on torch programs with the same
  counts: one (16, 32) @ (32, 64) product (65,536 FLOPs), 10 all-reduces of
  f32 (8, 8) over a 4-rank group of a fake world of 16 (count 10, 2,560 B),
  the materialised bytes of the product, a copy and the 10 reductions equal
  to ``analyze_hlo``'s on the reference test's HLO, an all-gather of f32
  (4, 8) over 4 ranks (128 B), and the bottleneck under H100 constants;
* ``derive_terms`` equal to the reference's on the same stats under the
  TPU's constants and the H100's;
* each recurrence's closed-form charge on ``meta`` (forward and backward,
  the kernel's layout and the model's) equal to what the op counter counts
  over its plain version on a small CPU input;
* the FLOPs equal ``FlopCounterMode``'s over a training step, and an op
  log turned back into the same terms.
"""
import numpy as np
import pytest
import torch

from repro_torch.roofline import analysis, op_count

jax = pytest.importorskip("jax")
import test_roofline as ref_tests  # noqa: E402
from repro.roofline import analysis as janalysis  # noqa: E402
from repro.roofline import hlo_parse  # noqa: E402


@pytest.fixture
def fake_world():
    """A fake process group of 16 ranks in this process, and a group of its
    first 4."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        yield torch.distributed.new_group([0, 1, 2, 3])
    finally:
        torch.distributed.destroy_process_group()


def simple_program(group):
    """The reference test's HLO as a torch program: a product, 10
    all-reduces of f32 (8, 8) over ``group``, a copy of the product."""
    a, b = torch.empty((16, 32), device="meta"), torch.empty((32, 64), device="meta")
    d = a @ b
    buf = torch.zeros((8, 8))
    for _ in range(10):
        torch.distributed.all_reduce(buf, group=group)
    return d.clone()


def test_dot_flops():
    a, b = torch.empty((16, 32), device="meta"), torch.empty((32, 64), device="meta")
    stats = op_count.analyze_step(torch.matmul, a, b)
    assert stats.flops == 2 * 16 * 64 * 32 == hlo_parse.analyze_hlo(ref_tests.SIMPLE).flops


def test_loop_multiplied_collectives(fake_world):
    stats = op_count.analyze_step(simple_program, fake_world)
    ref = hlo_parse.analyze_hlo(ref_tests.SIMPLE)
    assert stats.collective_counts["all-reduce"] == 10 == ref.collective_counts["all-reduce"]
    assert stats.collective_by_op["all-reduce"] == 256 * 10 == ref.collective_by_op["all-reduce"]


def test_materializing_bytes_counted(fake_world):
    stats = op_count.analyze_step(simple_program, fake_world)
    dot_bytes = (16 * 64 + 16 * 32 + 32 * 64) * 4
    copy_bytes = 2 * 16 * 64 * 4
    ar_bytes = 256 * 2 * 10         # operand+output per reduction
    assert stats.hbm_bytes == dot_bytes + copy_bytes + ar_bytes
    assert stats.hbm_bytes == hlo_parse.analyze_hlo(ref_tests.SIMPLE).hbm_bytes


def test_allgather_group_scaling(fake_world):
    x, out = torch.zeros((4, 8)), torch.zeros((16, 8))
    stats = op_count.analyze_step(torch.distributed.all_gather_into_tensor, out, x,
                                  group=fake_world)
    assert stats.collective_by_op["all-gather"] == 16 * 8 * 4 / 4 == 128
    assert stats.collective_counts["all-gather"] == 1


def test_derive_terms_bottleneck():
    stats = op_count.HloStats(
        flops=analysis.PEAK_FLOPS, hbm_bytes=analysis.HBM_BW * 2,
        collective_bytes=analysis.ICI_BW * 0.5,
        collective_by_op=dict.fromkeys(analysis.COLLECTIVE_OPS, 0.0),
        collective_counts=dict.fromkeys(analysis.COLLECTIVE_OPS, 0.0))
    terms = analysis.derive_terms({}, stats, n_chips=256,
                                  model_flops_global=analysis.PEAK_FLOPS * 256 * 0.5)
    assert (analysis.PEAK_FLOPS, analysis.HBM_BW, analysis.ICI_BW) == (989e12, 3.35e12, 450e9)
    assert terms.compute_s == 1.0
    assert terms.memory_s == 2.0
    assert terms.collective_s == 0.5
    assert terms.bottleneck == "memory"
    assert terms.useful_fraction == 0.5


@pytest.mark.parametrize("constants", ["tpu_v5e", "h100"])
def test_derive_terms_matches_reference(constants):
    peaks = {"tpu_v5e": dict(peak_flops=janalysis.PEAK_FLOPS, hbm_bw=janalysis.HBM_BW,
                             ici_bw=janalysis.ICI_BW),
             "h100": dict(peak_flops=analysis.PEAK_FLOPS, hbm_bw=analysis.HBM_BW,
                          ici_bw=analysis.ICI_BW)}[constants]
    by_op = {"all-gather": 3e9, "all-reduce": 1e9, "reduce-scatter": 2e9, "all-to-all": 0.0,
             "collective-permute": 0.0}
    counts = {k: 4.0 for k in by_op}
    jstats = hlo_parse.HloStats(7.5e14, 2.25e12, 6e9, dict(by_op), dict(counts))
    tstats = op_count.HloStats(7.5e14, 2.25e12, 6e9, dict(by_op), dict(counts))
    cost = {"flops": 1e14, "bytes accessed": 2e11}
    for n_chips, model in ((256, 1.2e17), (512, 3.0e17)):
        want = janalysis.derive_terms(cost, jstats, n_chips, model, **peaks).as_dict()
        got = analysis.derive_terms(cost, tstats, n_chips, model, **peaks).as_dict()
        assert got == want


def test_h100_platform_has_the_roofline_peaks():
    from repro_torch.core.power_model import H100
    assert (H100.peak_bf16_tflops * 1e12, H100.hbm_gbps * 1e9,
            H100.ici_gbps_per_link * 1e9) == (analysis.PEAK_FLOPS, analysis.HBM_BW,
                                              analysis.ICI_BW)


# --------------------------------------------------------------------------- #
# the recurrences' closed-form charges on meta
# --------------------------------------------------------------------------- #
def _rand(shape, gen, layout=None):
    t = torch.rand(shape, generator=gen)
    if layout == "model":      # a head-major view of (B, S, H, K)
        b, h, s, k = shape
        t = torch.rand((b, s, h, k), generator=gen).transpose(1, 2)
    return t


def _ssm(case, gen, b=2, s=7, di=12, n=8):
    u, dt, dy = (_rand((b, s, di), gen) for _ in range(3))
    a = -_rand((di, n), gen)
    bb, c = _rand((b, s, n), gen), _rand((b, s, n), gen)
    h0 = _rand((b, di, n), gen)
    from repro_torch.kernels import ssm_scan as mod
    if case == "forward":
        return mod.ssm_scan, (u, dt, a, bb, c, None, None)
    if case == "forward_state":
        return mod.ssm_scan, (u, dt, a, bb, c, h0, torch.zeros_like(h0))
    return mod.ssm_scan_backward, (u, dt, a, bb, c, h0, dy, torch.ones_like(h0))


def _wkv(case, gen, layout, b=2, h=3, s=6, k=16):
    r, kk, v, w, dy = (_rand((b, h, s, k), gen, layout) for _ in range(5))
    u, state = _rand((h, k), gen), _rand((b, h, k, k), gen)
    from repro_torch.kernels import rwkv6_scan as mod
    if case == "forward":
        return mod.wkv6, (r, kk, v, w, u, None, None)
    if case == "forward_state":
        return mod.wkv6, (r, kk, v, w, u, state, torch.zeros_like(state))
    return mod.wkv6_backward, (r, kk, v, w, u, state, dy, None)


RECURRENCE_CASES = [("ssm", c, None) for c in ("forward", "forward_state", "backward")] + \
    [("wkv", c, layout) for c in ("forward", "forward_state", "backward")
     for layout in ("heads", "model")]


@pytest.mark.parametrize("kind,case,layout", RECURRENCE_CASES,
                         ids=[f"{k}-{c}-{lay}" for k, c, lay in RECURRENCE_CASES])
def test_recurrence_meta_charge_equals_plain_count(kind, case, layout):
    gen = torch.Generator().manual_seed(3)
    fn, args = _ssm(case, gen) if kind == "ssm" else _wkv(case, gen, layout)
    plain = op_count.analyze_step(fn, *args)
    meta_args = [None if t is None else t.to("meta") for t in args]
    assert all(t is None or t.stride() == m.stride() for t, m in zip(args, meta_args))
    with op_count.OpCounter() as counter:
        out = fn(*meta_args)
    on_meta = counter.stats()
    assert (on_meta.flops, on_meta.hbm_bytes) == (plain.flops, plain.hbm_bytes)
    assert plain.flops > 0
    # one closed-form record, not S steps' ops
    assert len(counter.entries()) == 1 and counter.entries()[0]["count"] == 1
    want = fn(*args)
    assert [tuple(t.shape) for t in out] == [tuple(t.shape) for t in want]
    assert all(t.device.type == "meta" for t in out)


def test_flops_equal_flop_counter_mode_and_entries_round_trip():
    """Over a smoke qwen1.5-0.5b training loss and backward on the CPU, the
    counter's FLOPs are FlopCounterMode's, and its op log gives back its
    terms."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api
    from repro_torch.train.tree import leaves

    cfg = get_smoke_config("qwen1.5-0.5b")
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    batch = api.make_batch(cfg, 2, 32)

    def step():
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        loss, _ = api.loss_fn(params, batch, cfg)
        return torch.autograd.grad(loss, flat, allow_unused=True)

    with FlopCounterMode(display=False) as fc:
        step()
    with op_count.OpCounter() as counter:
        step()
    stats = counter.stats()
    assert stats.flops == fc.get_total_flops() > 0
    again = op_count.stats_from_entries(counter.entries())
    assert again.as_dict() == stats.as_dict()
    assert np.isfinite(stats.hbm_bytes) and stats.hbm_bytes > 0
