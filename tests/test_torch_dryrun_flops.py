"""The port's dry-run FLOPs (``repro_torch.launch.dryrun.run_cell``)
against the JAX package's compiled steps: the smoke config of each family
(dense, moe, mla_moe, rwkv, hybrid, encdec, vlm) and each shape kind (train,
prefill, decode), on a world of one rank and on a data-only fake world of
four, against the reference's own step compiled by its ``lower_cell`` on an
Auto-axis mesh of one host device and read by ``analyze_hlo``:

* prefill and decode FLOPs exactly equal; for moe and mla_moe after the
  reference's one-hot combine product (``einsum("bske,bsk->bse")``,
  2 B S top_k E a MoE layer), which the port takes by ``scatter_``;
* the train step's FLOPs within TRAIN_RTOL (2.5%) above the reference's.
  The port does more, and for dense, hybrid and rwkv exactly this much more:
  the attention backward (``ops.FlashAttentionFunction``) recomputes QKᵀ on
  top of the layer's remat (2 B H Sq Sk hd an attention call), and the
  recurrences' plain backwards take three products a step where XLA's
  gradient of the scan's ``einsum`` takes one contraction (4 B S I N a
  hymba layer, 4 B H S K² an rwkv layer); for moe and mla_moe the
  reference's combine product, forward, recomputed and differentiated, goes
  the other way, and whisper and the VLM recompute QKᵀ in their encoder and
  cross attentions too;
* on the world of four each rank runs the port's per-rank program (a
  quarter of the batch rows, the parameters gathered whole), which is the
  reference's unsharded program at those rows: the reference is compiled at
  the rank's rows, not on four devices, where GSPMD partitions the weight
  products over the data axis and its per-device FLOPs are no longer a row
  count's.

The tooling (meshes, JSON, rederive, report, memory) is in
test_torch_dryrun.py.
"""
import concurrent.futures
import os

import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun

jax = pytest.importorskip("jax")
from jax.sharding import AxisType, Mesh  # noqa: E402

from repro.configs import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.configs.base import ShapeSpec as JShape  # noqa: E402
from repro.distributed.context import DistContext as JDist  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.roofline import hlo_parse  # noqa: E402

TRAIN_RTOL = 0.025
FAMILY_ARCHS = {"dense": "qwen1.5-0.5b", "moe": "granite-moe-3b-a800m",
                "mla_moe": "deepseek-v3-671b", "rwkv": "rwkv6-3b", "hybrid": "hymba-1.5b",
                "encdec": "whisper-tiny", "vlm": "llama-3.2-vision-90b"}
#: rows a rank runs, and the sequence
ROWS, SEQ = 2, 64
KINDS = ("train", "prefill", "decode")


@pytest.fixture(scope="module")
def jdry():
    """The reference's dry-run module. Its import sets XLA_FLAGS for every
    later subprocess: the environment is restored after it."""
    saved = dict(os.environ)
    try:
        import repro.launch.dryrun as mod
    finally:
        os.environ.clear()
        os.environ.update(saved)
    return mod


@pytest.fixture(scope="module")
def ref_flops(jdry):
    """The reference's per-device FLOPs (``analyze_hlo``) of each family's
    smoke step at ROWS x SEQ, compiled by its ``lower_cell`` on an Auto mesh
    of one host device."""
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1), ("data", "model"),
                axis_types=(AxisType.Auto,) * 2)
    shapes = {k: JShape(f"{k}:{ROWS}x{SEQ}", SEQ, ROWS, k) for k in KINDS}
    saved = (jdry.get_config, dict(jdry.LM_SHAPES))
    jdry.get_config = jax_smoke_config
    jdry.LM_SHAPES.update({s.name: s for s in shapes.values()})
    lowered = {}
    try:
        for arch in FAMILY_ARCHS.values():
            for kind, shape in shapes.items():
                lowered[arch, kind] = jdry.lower_cell(arch, shape.name, JDist(mesh=mesh))[0]
        # XLA compiles outside the interpreter lock: a few at once
        with concurrent.futures.ThreadPoolExecutor(4) as pool:
            texts = dict(zip(lowered, pool.map(lambda lw: lw.compile().as_text(),
                                               lowered.values())))
        out = {key: hlo_parse.analyze_hlo(text).flops for key, text in texts.items()}
    finally:
        jdry.get_config = saved[0]
        jdry.LM_SHAPES.clear()
        jdry.LM_SHAPES.update(saved[1])
        jcm.set_shard_hook(None)
    return out


def combine_flops(cfg, b: int, s: int) -> int:
    """The reference's dense-dispatch combine product, which the port does
    not take: 2 B S top_k E a MoE layer."""
    if not cfg.is_moe:
        return 0
    return 2 * b * s * cfg.top_k * cfg.n_experts * (cfg.n_layers - cfg.first_k_dense)


def train_extra_flops(cfg, b: int, s: int) -> int | None:
    """What the port's train step does beyond the reference's, where named
    exactly (dense, hybrid, rwkv); None elsewhere."""
    if cfg.family == "rwkv":
        return 4 * b * cfg.n_rwkv_heads * s * cfg.rwkv_head_size ** 2 * cfg.n_layers
    if cfg.family not in ("dense", "hybrid"):
        return None
    qk = 2 * b * cfg.n_heads * s * s * cfg.resolved_head_dim * cfg.n_layers
    if cfg.family == "hybrid":
        return qk + 4 * b * s * cfg.d_inner * cfg.ssm_state * cfg.n_layers
    return qk


CELLS = [(fam, kind, world) for fam in FAMILY_ARCHS for kind in KINDS
         for world in ((1, 1), (4, 1))]


@pytest.mark.parametrize("family,kind,world", CELLS,
                         ids=[f"{f}-{k}-{w[0]}x{w[1]}" for f, k, w in CELLS])
def test_run_cell_flops_match_reference(ref_flops, family, kind, world):
    arch = FAMILY_ARCHS[family]
    cfg = get_smoke_config(arch)
    ranks = world[0] * world[1]
    r = dryrun.run_cell(arch, f"{kind}:{ROWS * ranks}x{SEQ}", False, world=world, smoke=True)
    assert r["status"] == "ok", r.get("traceback")
    assert r["n_chips"] == ranks
    got, want = r["roofline"]["flops"], ref_flops[arch, kind]
    if kind == "train":
        assert want <= got <= (1 + TRAIN_RTOL) * want, (got, want, got / want)
        extra = train_extra_flops(cfg, ROWS, SEQ)
        if extra is not None:
            assert got - want == extra, (got - want, extra)
    else:
        assert got + combine_flops(cfg, ROWS, SEQ if kind == "prefill" else 1) == want, \
            (got, want)
    if ranks > 1 and kind == "train":
        # the sharded step gathers leaves and reduces gradients
        assert r["collectives"]["total_bytes"] > 0
        assert r["collectives"]["counts"]["all-gather"] > 0
