"""The port's dry-run tooling (``repro_torch.launch.dryrun``,
``repro_torch.roofline``):

* ``tune="attn_grouped"`` lowers the HBM bytes of a GQA config;
* a 256-rank and a 512-rank cell (the production meshes over the fake
  process group), their JSON with the reference's keys, ``rederive`` from
  the cached op log, ``report``'s table, and the CLI's ``--mesh both``;
* a full-width cell (llama-3.2-vision-90b ``train_4k`` on 16 x 16) in a
  subprocess under 2 GB of resident memory: nothing is allocated;
* a kernel wrapper's call on ``meta`` is no launch;
* chip_smoke.py's dry-run phase: its train cells' FLOPs above
  ``train_flops``'s by exactly the named terms (masked pairs, the backward's
  QKᵀ, the recurrences' products, hymba's elementwise convolution), at
  smoke widths; its tuned backward on the CPU (the same loss bit for bit,
  the gradients within its bounds from the floor); and its stand-ins for
  the plain attentions, which take the ``knobs`` argument.

The FLOPs against the JAX package's compiled steps are in
test_torch_dryrun_flops.py.
"""
import dataclasses
import gzip
import importlib.util
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.roofline import rederive, report

jax = pytest.importorskip("jax")
from repro.roofline import analysis as janalysis  # noqa: E402
from repro.roofline import hlo_parse  # noqa: E402

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"
#: chip_smoke.py, for its dry-run phase's accounting
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)


def test_attn_grouped_lowers_hbm_bytes():
    base = dryrun.run_cell("gemma-2b", "prefill:2x128", False, world=(1, 1), smoke=True)
    tuned = dryrun.run_cell("gemma-2b", "prefill:2x128", False, world=(1, 1), smoke=True,
                            tune="attn_grouped")
    assert get_smoke_config("gemma-2b").q_per_kv > 1
    assert tuned["mesh"] == "local__tuned-attn_grouped" and tuned["tune"] == "attn_grouped"
    assert tuned["roofline"]["hbm_bytes"] < base["roofline"]["hbm_bytes"]
    assert tuned["roofline"]["flops"] == base["roofline"]["flops"]


REF_KEYS = {"arch", "shape", "mesh", "tune", "status", "lower_s", "compile_s", "n_chips",
            "memory", "collectives", "roofline", "wall_s"}


@pytest.mark.parametrize("multi", [False, True], ids=["256", "512"])
def test_production_mesh_cell_rederive_and_report(tmp_path, multi):
    arch, shape = "granite-moe-3b-a800m", "train:64x32"
    r = dryrun.run_cell(arch, shape, multi, tmp_path, smoke=True)
    assert r["status"] == "ok", r.get("traceback")
    assert set(r) == REF_KEYS
    assert r["n_chips"] == (512 if multi else 256)
    assert set(r["roofline"]) == {f.name for f in dataclasses.fields(janalysis.RooflineTerms)}
    assert set(r["memory"]) == {"argument_size_in_bytes", "output_size_in_bytes"}
    assert set(r["collectives"]["by_op"]) == set(hlo_parse.COLLECTIVE_OPS)
    # expert parallel over the 16-wide model axis, the gathers and reductions
    assert r["collectives"]["counts"]["all-to-all"] > 0
    assert r["collectives"]["counts"]["all-gather"] > 0
    mesh = "multi" if multi else "single"
    jpath = dryrun._cell_file(tmp_path, arch, shape, mesh, ".json")
    lpath = dryrun._cell_file(tmp_path, arch, shape, mesh, ".ops.json.gz")
    assert json.loads(jpath.read_text()) == json.loads(json.dumps(r))
    with gzip.open(lpath, "rt") as f:
        assert {"op", "flops", "bytes", "collective", "group", "out_bytes", "count"} == \
            set(json.load(f)[0])
    # rederive from the op log gives back the terms
    stale = dict(r, roofline=dict(r["roofline"], flops=0.0), collectives={})
    jpath.write_text(json.dumps(stale))
    assert rederive.rederive(tmp_path, smoke=True) == 1
    assert json.loads(jpath.read_text()) == json.loads(json.dumps(r))
    report.main(["--dir", str(tmp_path), "--out", str(tmp_path / "t.md"), "--mesh", mesh])
    table = (tmp_path / "t.md").read_text()
    assert f"| {arch} | {shape} |" in table and ("512 ranks" if multi else "256 ranks") in table
    assert "TPU" not in table and "Pallas" not in table


def test_cli_both_meshes_and_skipped(tmp_path, capsys):
    dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode:32x16", "--mesh", "both",
                 "--smoke", "--out", str(tmp_path)])
    dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "long_500k", "--mesh", "single",
                 "--smoke", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("[ok     ]") == 2 and "[skipped]" in out
    assert not torch.distributed.is_initialized()
    single = json.loads((tmp_path / "qwen1_5-0_5b__decode_32x16__single.json").read_text())
    multi = json.loads((tmp_path / "qwen1_5-0_5b__decode_32x16__multi.json").read_text())
    assert (single["n_chips"], multi["n_chips"]) == (256, 512)
    # 32 rows: 2 a rank on 16 data ranks, 1 on 32
    assert single["roofline"]["flops"] == 2 * multi["roofline"]["flops"]
    dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode:32x16", "--mesh", "both",
                 "--smoke", "--out", str(tmp_path), "--skip-existing"])
    assert capsys.readouterr().out.count("[skip]") == 2


def test_full_width_cell_allocates_nothing(tmp_path):
    # the peak resident set of this process image: VmHWM, which exec resets
    # (getrusage's ru_maxrss keeps the forking test process's)
    code = ("import re\n"
            "from repro_torch.launch import dryrun\n"
            "r = dryrun.run_cell('llama-3.2-vision-90b', 'train_4k', False)\n"
            "assert r['status'] == 'ok', r.get('traceback')\n"
            "hwm = re.search(r'VmHWM:\\s+(\\d+) kB', open('/proc/self/status').read())\n"
            "print(r['roofline']['flops'], r['memory']['argument_size_in_bytes'],\n"
            "      int(hwm.group(1)) * 1024)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
                                           "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    flops, arg_bytes, rss = map(float, out.stdout.split())
    assert flops > 1e16                    # a 90 B model over 256 x 4,096 tokens
    assert arg_bytes > 2**30                # a rank's shards of parameters and state
    assert rss < 2 * 2**30, rss


def test_meta_calls_are_not_launches():
    from repro_torch.kernels import ops
    before = kernels.launch_counts()
    meta = torch.device("meta")
    x = torch.empty((2, 8, 64), device=meta, dtype=torch.bfloat16)
    ops.rmsnorm(x, torch.empty(64, device=meta, dtype=torch.bfloat16))
    q = torch.empty((2, 8, 4, 64), device=meta, dtype=torch.bfloat16)
    kv = torch.empty((2, 8, 2, 64), device=meta, dtype=torch.bfloat16)
    assert ops.flash_attention(q, kv, kv).device == meta
    assert ops.decode_attention(q[:, :1], kv, kv, 8).shape == (2, 1, 4, 64)
    f32 = dict(device=meta, dtype=torch.float32)
    y, h = ops.ssm_scan(torch.empty(2, 8, 16, **f32), torch.empty(2, 8, 16, **f32),
                        torch.empty(16, 8, **f32), torch.empty(2, 8, 8, **f32),
                        torch.empty(2, 8, 8, **f32))
    assert (y.shape, h.shape) == ((2, 8, 16), (2, 16, 8))
    r = torch.empty(2, 8, 4, 16, **f32)
    y, s = ops.wkv6(r, r, r, r, torch.empty(4, 16, **f32))
    assert (y.shape, s.shape) == ((2, 8, 4, 16), (2, 4, 16, 16))
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "hymba-1.5b", "rwkv6-3b", "whisper-tiny"])
def test_chip_smoke_difference_is_named(arch):
    """The phase's gate 2 at smoke widths (hymba over its 16-token window):
    the dry-run's FLOPs are train_flops' plus the named terms, none left."""
    cfg = get_smoke_config(arch)
    b, s = 2, 48
    r = dryrun.run_cell(arch, f"train:{b}x{s}", False, world=(1, 1), smoke=True)
    model = cs.train_flops(cfg, b, s)["flops"]
    diff = cs.dryrun_difference(cfg, b, s, r["roofline"]["flops"], model)
    assert r["roofline"]["flops"] >= model
    assert diff["other"] == 0, diff
    if cfg.family != "rwkv":
        assert diff["recompute_p"] > 0 and diff["masked_pairs"] > 0
    if cfg.family in ("rwkv", "hybrid"):
        assert diff["recurrence_dots"] > 0


def test_chip_smoke_tuned_backward_on_cpu(monkeypatch):
    """chip_smoke.tuned_backward's logic on a smoke hymba-1.5b on the CPU: the
    knobs leave the loss bit for bit and the gradients within its bounds
    from the floor (the CUDA memory calls stubbed)."""
    import types

    from repro_torch.models import api
    from repro_torch.train.data import SyntheticDataset

    cfg = get_smoke_config("hymba-1.5b")
    trainer = types.SimpleNamespace(
        params=api.init_params(torch.Generator().manual_seed(0), cfg),
        dataset=SyntheticDataset(cfg, 2, 32, seed=0))
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    for name in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: 0)
    monkeypatch.setattr(cs, "nvidia_smi_line", lambda: "cpu")
    monkeypatch.setattr(cs, "TUNED_BWD_KNOBS", dict(attn_block_remat=True, q_block=8))
    monkeypatch.setattr(cs, "TUNED_BWD_FLOOR_KNOBS", dict(attn_block_remat=True, q_block=16))
    r = cs.tuned_backward(trainer, cfg, torch.device("cpu"))
    assert r["tuned"]["loss"] == r["floor"]["loss"] == r["baseline"]["loss"]
    assert r["worst_leaf"] <= cs.TUNED_BWD_LEAF_RATIO * r["floor_worst_leaf"]
    assert r["whole"] <= min(2 * r["floor_whole"], cs.TUNED_BWD_WHOLE_TOL)


@pytest.mark.parametrize("arch", ["gemma-2b", "hymba-1.5b"])
def test_chip_smoke_plain_stand_ins_on_cpu(arch):
    """chip_smoke.py's stand-ins for the plain attentions (the f64 chaos
    floor's, the unmasked forward's) take the plain versions' arguments,
    ``knobs`` included: on the CPU the floor is small and the unmasked
    forward moves the logits."""
    from repro_torch.models import api

    cfg = get_smoke_config(arch)
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    cpu = torch.device("cpu")
    plain = cs.logit_runs(cfg, params, cpu, 16, True)
    assert cs.attention_f64_floor(cfg, params, cpu, 16, plain) < 5e-2
    patches, _ = cs.wrong_forward(cfg)
    wrong = cs.patched_call(patches, lambda: cs.logit_runs(cfg, params, cpu, 16, True))
    assert cs.normwise_error(wrong, plain, cfg, "unmasked") > 5e-2
