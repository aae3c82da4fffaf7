"""The serving engine's CUDA graphs on the card, at smoke size.

On the card ``ServingEngine`` captures its decode step and its prefill into
one CUDA graph each. Here each of the eight served models' smoke configs
is held to the eager step functions bit for bit, over 8 decode steps that
cross the shared length's clamp (and hymba's ring) and one prefill
(``chip_smoke.lockstep``, which the chip smoke test runs at full width),
and the launch counters are checked: capture adds nothing, each replay adds
the graph's launches, which are one eager step's. These tests need the card
and skip elsewhere; the union of kernel intervals that ``chip_smoke.py``
reads the card's active time from is tested here on any machine. The file
imports no JAX, so it also runs on a machine without it.
"""
import dataclasses
import importlib.util
import pathlib

import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models import api
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.engine import EngineConfig, ServingEngine

#: chip_smoke.py, for the lockstep check and the launch counts it shares
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)

MAX_SEQ = 32        # hymba's smoke window is 16: its ring wraps at 32 as well


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["llama-13b", "gemma-2b", "hymba-1.5b", "rwkv6-3b",
                                  "granite-moe-3b-a800m", "whisper-tiny",
                                  "llama-3.2-vision-90b", "deepseek-v3-671b"])
def test_replayed_steps_match_eager_on_card(cuda, arch, monkeypatch):
    monkeypatch.setattr(chip_smoke, "log", lambda msg: None)
    cfg = get_smoke_config(arch)
    if cfg.resolved_head_dim not in HEAD_DIMS:       # hymba's, the VLM's: 16 wide
        cfg = dataclasses.replace(cfg, head_dim=32)
    params = api.init_params(torch.Generator(device=cuda).manual_seed(0), cfg)
    before = kernels.launch_counts()
    eng = ServingEngine(cfg, params, EngineConfig(n_slots=2, max_seq_len=MAX_SEQ,
                                                  prefill_bucket=8, device="cuda"))
    torch.cuda.synchronize()
    assert set(eng.graphs) == {"decode", "prefill"}
    runs = engine_mod.WARMUP_RUNS       # only the eager warm-up launched
    warm = chip_smoke.expected_launches(cfg, runs, runs)
    assert {k: n - before[k] for k, n in kernels.launch_counts().items()} == warm
    decode, prefill = eng.graphs["decode"].launches, eng.graphs["prefill"].launches
    assert {k: n for k, n in decode.items() if k != kernels.WGMMA} == \
        chip_smoke.expected_launches(cfg, 0, 1)
    assert {k: n for k, n in prefill.items() if k != kernels.WGMMA} == \
        chip_smoke.expected_launches(cfg, 1, 0)
    assert prefill[kernels.WGMMA] == prefill["flash_attention"] and decode[kernels.WGMMA] == 0
    before = kernels.launch_counts()
    result = chip_smoke.lockstep(eng, MAX_SEQ - 4)
    torch.cuda.synchronize()
    assert result["len"] == [MAX_SEQ - 4, MAX_SEQ + 4]
    # 8 eager steps and 8 replays, one eager prefill and one replay
    assert {k: n - before[k] for k, n in kernels.launch_counts().items()} == \
        chip_smoke.expected_launches(cfg, 2, 16)


def test_card_activity_counts_overlapping_kernels_once():
    """``chip_smoke.covered``, which reads the card's active time from the
    profiler's kernel intervals: overlapping and nested intervals count
    once, touching ones add up, gaps count for nothing."""
    assert chip_smoke.covered([]) == 0.0
    assert chip_smoke.covered([(5, 6), (0, 2), (1, 3), (5.5, 5.7)]) == 4.0
    assert chip_smoke.covered([(0, 1), (1, 2)]) == 2.0
    assert chip_smoke.covered([(0, 10), (2, 3), (9, 12)]) == 12.0
