"""The port's MoE family (granite-moe's dense dispatch) and the two new dense
configs against the JAX package's.

* ``router_topk``: the same expert ids and gates as the reference (1e-5 in
  f32), with padded experts masked, and the reference's order on exact
  ties (``lax.top_k`` puts the lower index first);
* ``moe_ffn_dense`` and ``moe_ffn`` with a shared expert within 1e-5 in
  f32; ``moe_ffn`` takes ``dist`` (``LOCAL`` or a 1-wide model axis: the
  dense dispatch);
* granite-3-8b and qwen1.5-4b: configs and smoke prefill/decode parity
  (tests/test_torch_models.py's 1e-4);
* ``init_moe_ffn``: granite-moe's stacks drawn bit for bit as before they
  were chunked, and larger stacks in chunks of whole experts;
* ``launch.serve --arch granite-moe-3b-a800m --smoke --device cpu``.

Granite-moe's prefill/decode parity, init shapes and engine tokens run in
the parametrised cases of tests/test_torch_models.py and
tests/test_torch_serving.py.
"""
import contextlib
import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import api as japi
from repro.models import moe as jmoe
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.distributed.context import LOCAL, DistContext, make_mesh
from repro_torch.launch import serve
from repro_torch.models import moe
import test_torch_models as tm

TOL = dict(rtol=1e-5, atol=1e-5)
ARCH = "granite-moe-3b-a800m"


@contextlib.contextmanager
def world_of_one():
    """A 1 x 1 (data, model) mesh over a gloo group of this process alone."""
    with tempfile.TemporaryDirectory() as d:
        torch.distributed.init_process_group("gloo", init_method=f"file://{d}/store",
                                             rank=0, world_size=1)
        try:
            yield DistContext(mesh=make_mesh((1, 1), ("data", "model")))
        finally:
            torch.distributed.destroy_process_group()


def _moe_pair(seed=0, ep_size=1, shared=0):
    """(jax cfg, port cfg, numpy FFN params of layer 0) in float32."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32",
                               n_shared_experts=shared)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32",
                               n_shared_experts=shared)
    p = jmoe.init_moe_ffn(jax.random.PRNGKey(seed), jcfg, ep_size)
    return jcfg, tcfg, {k: np.array(v[0]) for k, v in p.items()}


def _x(cfg, seed=1, shape=(3, 5)):
    return np.random.default_rng(seed).standard_normal((*shape, cfg.d_model)).astype(np.float32)


def test_moe_configs_match_jax():
    for arch in (ARCH, "granite-3-8b", "qwen1.5-4b"):
        tm._assert_same_config(jax_config(arch), get_config(arch))
        tm._assert_same_config(jax_smoke_config(arch), get_smoke_config(arch))
    cfg = get_smoke_config(ARCH)
    assert (cfg.n_experts, cfg.top_k, cfg.d_expert, cfg.n_shared_experts) == (4, 2, 32, 0)
    assert get_config(ARCH).is_moe and not get_config("granite-3-8b").is_moe
    with pytest.raises(ValueError, match="bad top_k"):
        dataclasses.replace(cfg, top_k=5).validate()


@pytest.mark.parametrize("ep_size", [1, 3])
def test_router_topk_matches_jax(ep_size):
    """ids equal and gates within 1e-5; with ep_size 3 the 4 experts pad to
    6 and the padded two are never picked."""
    jcfg, tcfg, p = _moe_pair(ep_size=ep_size)
    assert p["router"].shape[-1] == moe.padded_experts(tcfg, ep_size) == 4 + 2 * (ep_size > 1)
    assert p["router"].dtype == np.float32
    own = moe.init_moe_ffn(torch.Generator().manual_seed(0), tcfg, ep_size)
    assert {k: (tuple(v.shape[1:]), v.dtype) for k, v in own.items()} == \
        {k: (v.shape, torch.float32) for k, v in p.items()}
    x = _x(tcfg)
    jg, jids, _ = jmoe.router_topk(jnp.asarray(x), jnp.asarray(p["router"]), jcfg)
    tg, tids, taux = moe.router_topk(torch.from_numpy(x), torch.from_numpy(p["router"]), tcfg)
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    assert tids.max() < tcfg.n_experts
    assert taux is None                   # the aux loss only when asked for
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    assert tg.dtype == torch.float32


@pytest.mark.parametrize("top_k", [2, 4])
def test_router_topk_ties_keep_the_lower_index(top_k):
    """Exact ties (every real expert's router column the same, beside two
    padded experts) pick the lower index first, as lax.top_k does."""
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), dtype="float32", top_k=top_k)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32", top_k=top_k)
    col = np.random.default_rng(2).standard_normal((tcfg.d_model, 1)).astype(np.float32)
    router = np.repeat(col, 6, axis=1)                        # 4 real + 2 padded
    x = _x(tcfg, seed=3)
    jg, jids, _ = jmoe.router_topk(jnp.asarray(x), jnp.asarray(router), jcfg)
    tg, tids, _ = moe.router_topk(torch.from_numpy(x), torch.from_numpy(router), tcfg)
    assert np.array_equal(np.asarray(jids), np.broadcast_to(np.arange(top_k), jids.shape))
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("ep_size", [1, 3])
def test_moe_ffn_matches_jax(shared, ep_size):
    jcfg, tcfg, p = _moe_pair(seed=4, ep_size=ep_size, shared=shared)
    x = _x(tcfg, seed=5, shape=(2, 7))
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jdense, _ = jmoe.moe_ffn_dense(jnp.asarray(x), jp, jcfg)
    tdense, _ = moe.moe_ffn_dense(torch.from_numpy(x), tp, tcfg)
    np.testing.assert_allclose(tdense.numpy(), np.asarray(jdense), **TOL)
    jout, _ = jmoe.moe_ffn(jnp.asarray(x), jp, jcfg)
    tout, _ = moe.moe_ffn(torch.from_numpy(x), tp, tcfg)
    assert tout.shape == x.shape and tout.dtype == torch.float32
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), **TOL)
    if shared:
        assert not np.allclose(tout.numpy(), tdense.numpy())
    # ``dist`` is taken: LOCAL, and a mesh whose model axis is 1 wide, keep
    # the dense dispatch (the expert-parallel one is tested in
    # tests/test_torch_distributed.py)
    assert torch.equal(moe.moe_ffn(torch.from_numpy(x), tp, tcfg, LOCAL)[0], tout)
    with world_of_one() as dist:
        assert dist.ep_size == 1
        assert torch.equal(moe.moe_ffn(torch.from_numpy(x), tp, tcfg, dist)[0], tout)


def test_moe_ffn_keeps_the_reference_dtypes_in_bf16():
    """Under a bf16 model the router stays f32 through params_from_jax, and
    the FFN's output is in the model dtype."""
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    np_params = jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(0), jcfg))
    params = params_from_jax(np_params, tcfg, "cpu")
    layers = params["layers"]
    assert layers["router"].dtype == torch.float32
    assert layers["we_gate"].dtype == layers["wq"].dtype == torch.bfloat16
    x = torch.randn((1, 3, tcfg.d_model), generator=torch.Generator().manual_seed(0))
    out, _ = moe.moe_ffn(x.bfloat16(), {k: v[0] for k, v in layers.items()}, tcfg)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen1.5-4b"])
def test_new_dense_configs_match_jax(arch):
    """The two new dense configs' smoke prefill and decode logits and caches
    equal the JAX package's within 1e-4 in f32."""
    tm.test_prefill_and_decode_match_jax(arch)


def test_serve_launcher_runs_granite_moe_on_cpu():
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--duration", "30", "--max-seq", "32", "--controller"])
    assert out["arch"] == ARCH + "-smoke"
    assert out["completed"] >= 1
    assert 0.0 <= out["telemetry"]["exec_idle_time_fraction"] <= 1.0


def _init_moe_ffn_one_draw(gen, cfg):
    """``init_moe_ffn`` as it drew before its stacks were chunked: each
    layer's whole stack in one f32 draw."""
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    l, d, fe, e = cfg.n_layers, cfg.d_model, cfg.d_expert, cfg.n_experts

    def stack(*shape, fan_in, dtype=dt):
        out = torch.empty((l, *shape), dtype=dtype)
        for i in range(l):
            w = torch.randn(shape, generator=gen, dtype=torch.float32)
            out[i] = (w * (1.0 / np.sqrt(fan_in))).to(dtype)
        return out

    return {"router": stack(d, e, fan_in=d, dtype=torch.float32),
            "we_gate": stack(e, d, fe, fan_in=d), "we_up": stack(e, d, fe, fan_in=d),
            "we_down": stack(e, fe, d, fan_in=fe)}


def test_init_moe_ffn_granite_stacks_are_one_draw():
    """granite-moe's stacks (31.5 M elements a layer, below the 2^28 chunk)
    are drawn as before the chunking, bit for bit: its weights, and the
    routing figures recorded on them, do not move."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=1)
    got = moe.init_moe_ffn(torch.Generator().manual_seed(0), cfg)
    want = _init_moe_ffn_one_draw(torch.Generator().manual_seed(0), cfg)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name


def test_init_moe_ffn_draws_whole_experts_in_chunks(monkeypatch):
    """Past ``DRAW_CHUNK`` elements a layer, each expert stack is drawn in
    chunks of whole experts, none over the limit (deepseek-v3: 18 experts of
    7168 x 2048 a chunk), at the stack's scale; ``n_layers=`` sets the
    depth, as the reference's argument does."""
    from repro_torch.models import common as cm
    cfg = dataclasses.replace(get_smoke_config("deepseek-v3-671b"), dtype="float32")
    per_expert = cfg.d_model * cfg.d_expert
    monkeypatch.setattr(cm, "DRAW_CHUNK", 3 * per_expert)
    drawn = []
    randn = torch.randn

    def spy(shape, *args, **kwargs):
        drawn.append(tuple(shape))
        return randn(shape, *args, **kwargs)

    monkeypatch.setattr(torch, "randn", spy)
    p = moe.init_moe_ffn(torch.Generator().manual_seed(0), cfg, n_layers=3)
    want = jax.tree.map(lambda a: a.shape, jmoe.init_moe_ffn(
        jax.random.PRNGKey(0), jax_smoke_config("deepseek-v3-671b"), n_layers=3))
    assert {k: tuple(v.shape) for k, v in p.items()} == want
    assert all(np.prod(s) <= 3 * per_expert for s in drawn)
    e, d, fe = cfg.n_experts, cfg.d_model, cfg.d_expert
    assert drawn.count((3, d, fe)) == 2 * 3 and drawn.count((e - 3, d, fe)) == 2 * 3
    assert drawn.count((3, fe, d)) == 3 and drawn.count((e - 3, fe, d)) == 3
    for name, fan_in in (("we_gate", d), ("we_down", fe)):
        assert abs(float(p[name].std()) * np.sqrt(fan_in) - 1.0) < 0.1, name
    chunks = p["we_gate"][0].reshape(e, -1)
    assert not torch.equal(chunks[0], chunks[3])          # later chunks are new draws
    full = get_config("deepseek-v3-671b")
    assert 18 * full.d_model * full.d_expert <= 1 << 28 < 19 * full.d_model * full.d_expert
