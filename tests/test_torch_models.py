"""The port's models (dense, granite-moe, hymba, RWKV-6, whisper, the VLM,
deepseek-v3's MLA) against the JAX package's, on the same weights.

JAX initialises the parameters; ``repro_torch.convert.params_from_jax``
carries them across as numpy. Norm weights, biases and the parameters that
start at a constant (hymba's fusion scales and D-skip, RWKV's bonus and
decay base, the VLM's cross-attention gates) are redrawn from a numpy seed
so that they are not trivially one, zero or uniform; whisper's frames and
the VLM's vision embeddings are random, so the cross paths reach the
logits. Both run in float32:
the JAX model casts softmax probabilities to v's dtype before the PV product
while the kernels keep them in f32, so bf16 would compare two roundings.
Tolerance: 1e-4 absolute and relative on logits and caches (f32 matmuls and
transcendentals in two libraries, summed in different orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import api as japi
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import api
from repro_torch.models import common as cm

ARCHS = ["llama-13b", "qwen1.5-0.5b", "gemma-2b", "hymba-1.5b", "rwkv6-3b",
         "granite-moe-3b-a800m", "whisper-tiny", "llama-3.2-vision-90b", "deepseek-v3-671b"]
#: the new families' caches: each padded leaf's sequence axis, each leaf's
#: batch axis (tests of pad_cache and cache_rows)
PADDED = {"whisper-tiny": {"k": 2, "v": 2}, "llama-3.2-vision-90b": {"k": 3, "v": 3},
          "deepseek-v3-671b": {"ckv": 2, "krope": 2}}
BATCH_AXES = {"whisper-tiny": {"k": 1, "v": 1, "xk": 1, "xv": 1},
              "llama-3.2-vision-90b": {"k": 2, "v": 2, "xk": 1, "xv": 1},
              "deepseek-v3-671b": {"ckv": 1, "krope": 1}}
#: layer norms whose weights and biases are redrawn
LN_PREFIXES = ("ln", "gn", "enc_ln", "dec_ln")
TOL = dict(rtol=1e-4, atol=1e-4)


def _perturb(np_params, seed):
    rng = np.random.default_rng(seed)

    def visit(node, name=""):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        if isinstance(node, list):
            return [visit(v, name) for v in node]
        arr = np.asarray(node, np.float32)

        def noise():
            return rng.standard_normal(arr.shape)

        if "norm" in name or name.endswith("_w") and name.startswith(LN_PREFIXES) \
                or name in ("beta_attn", "beta_ssm", "d_skip"):
            return (1.0 + 0.1 * noise()).astype(np.float32)
        if name in ("bq", "bk", "bv", "bo", "b_up", "b_down", "conv_b", "dt_bias", "u") \
                or name.startswith("x_b") \
                or name.endswith("_b") and name.startswith(LN_PREFIXES):
            return (0.1 * noise()).astype(np.float32)
        if name in ("gate_attn", "gate_mlp"):
            return (0.5 + 0.1 * noise()).astype(np.float32)
        if name == "decay_base":
            return (arr + 0.5 * noise()).astype(np.float32)
        return arr

    return visit(np_params)


def _assert_same_config(jcfg, tcfg):
    """The port's config carries the dense fields only: each equals the JAX
    config's, and every JAX field the port lacks is at its default."""
    port = dataclasses.asdict(tcfg)
    for f in dataclasses.fields(jcfg):
        value = getattr(jcfg, f.name)
        if f.name in port:
            assert port[f.name] == value, f.name
        else:
            assert value == f.default, f"{f.name} = {value!r} is not ported"


def _pair(arch, seed=0):
    """(jax cfg, port cfg, jax params, port params) on the same weights."""
    jcfg = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    _assert_same_config(jcfg, tcfg)
    np_params = jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(seed), jcfg))
    np_params = _perturb(np_params, seed + 1)
    jparams = jax.tree.map(jnp.asarray, np_params)
    return jcfg, tcfg, jparams, params_from_jax(np_params, tcfg, "cpu")


def _stub_inputs(cfg, b, seed=11):
    """Random ``frames=`` / ``vision=`` for the families that take them, as
    numpy; {} for the others."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal((b, cfg.n_frames, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"vision": rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)}
    return {}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(tree, path=""):
    """{path: numpy array} of a cache tree (dicts and lists)."""
    if isinstance(tree, dict):
        return {p: a for k, v in tree.items() for p, a in _leaves(v, f"{path}/{k}").items()}
    if isinstance(tree, list):
        return {p: a for i, v in enumerate(tree) for p, a in _leaves(v, f"{path}/{i}").items()}
    return {path: _np(tree)}


def _assert_caches_close(tcache, jcache):
    """Every leaf of the port's cache equals the JAX package's: same tree,
    shapes and dtypes, values within TOL."""
    tl, jl = _leaves(tcache), _leaves(jcache)
    assert tl.keys() == jl.keys()
    for path, want in jl.items():
        got = tl[path]
        assert got.shape == want.shape and got.dtype == want.dtype, path
        np.testing.assert_allclose(got, want, **TOL, err_msg=path)


def test_smoke_configs_match_jax():
    for arch in ARCHS:
        _assert_same_config(jax_config(arch), get_config(arch))
        _assert_same_config(jax_smoke_config(arch), get_smoke_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    jcfg, tcfg, jparams, tparams = _pair(arch)
    rng = np.random.default_rng(7)
    b, s, max_len = 2, 12, 20
    tokens = rng.integers(0, tcfg.vocab_size, (b, s))
    stubs = _stub_inputs(tcfg, b)

    jcache, jlogits = japi.prefill(jparams, jnp.asarray(tokens, jnp.int32), jcfg,
                                   **{k: jnp.asarray(x) for k, x in stubs.items()})
    tcache, tlogits = api.prefill(tparams, torch.from_numpy(tokens), tcfg,
                                  **{k: torch.from_numpy(x) for k, x in stubs.items()})
    assert tlogits.shape == (b, 1, tcfg.vocab_size)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), **TOL)
    _assert_caches_close(tcache, jcache)
    assert int(tcache["len"]) == int(jcache["len"]) == s

    jcache = japi.pad_cache(jcfg, jcache, max_len)
    tcache = api.pad_cache(tcfg, tcache, max_len)
    _assert_caches_close(tcache, jcache)
    for step in range(3):
        nxt = rng.integers(0, tcfg.vocab_size, (b, 1))
        jcache, jlogits = japi.decode_step(jparams, jcache, jnp.asarray(nxt, jnp.int32), jcfg)
        tcache, tlogits = api.decode_step(tparams, tcache, torch.from_numpy(nxt), tcfg)
        assert int(tcache["len"]) == int(jcache["len"]) == s + step + 1
        np.testing.assert_allclose(_np(tlogits), _np(jlogits), **TOL)
        _assert_caches_close(tcache, jcache)


def test_decode_past_cache_end_matches_jax():
    """With the shared length at or past the cache size the reference clamps
    the write to the last slot and counts every slot valid; so does the
    port."""
    jcfg, tcfg, jparams, tparams = _pair("llama-13b", seed=3)
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 6))
    jcache, _ = japi.prefill(jparams, jnp.asarray(tokens, jnp.int32), jcfg)
    tcache, _ = api.prefill(tparams, torch.from_numpy(tokens), tcfg)
    for _ in range(3):                       # len 6 -> 9 on a 6-slot cache
        nxt = rng.integers(0, tcfg.vocab_size, (2, 1))
        jcache, jlogits = japi.decode_step(jparams, jcache, jnp.asarray(nxt, jnp.int32), jcfg)
        tcache, tlogits = api.decode_step(tparams, tcache, torch.from_numpy(nxt), tcfg)
        np.testing.assert_allclose(_np(tlogits), _np(jlogits), **TOL)
        np.testing.assert_allclose(_np(tcache["k"]), _np(jcache["k"]), **TOL)
    assert int(tcache["len"]) == int(jcache["len"]) == 9


def _first_projection(params, cfg):
    """A (d_model, ·) projection of the first layer, drawn at 1/sqrt(d)."""
    if cfg.family == "hybrid":
        return params["layers"][0]["wq"]
    if cfg.family == "encdec":
        return params["dec_layers"]["wq"][0]
    if cfg.family == "vlm":
        return params["self_layers"]["wq"][0, 0]
    if cfg.family == "mla_moe":
        return params["dense_layers"]["w_dq"][0]
    return params["layers"]["wr" if cfg.family == "rwkv" else "wq"][0]


def test_init_params_shapes_match_jax():
    """The port's own initialiser yields the JAX package's tree, shapes and
    dtypes (f32 leaves included under bf16), at the configured scales."""
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                               japi.abstract_params(jax_smoke_config(arch)))
        params = api.init_params(torch.Generator().manual_seed(0), cfg)
        tshapes = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                               params)
        assert tshapes == jshapes
        std = float(_first_projection(params, cfg).float().std())
        assert abs(std - cfg.d_model ** -0.5) < 0.2 * cfg.d_model ** -0.5


def test_params_from_jax_keeps_f32_leaves():
    """Under a bf16 model the converted tree keeps the JAX package's dtypes:
    f32 leaves stay f32, the rest are bf16, lists are walked."""
    for arch in ("hymba-1.5b", "rwkv6-3b"):
        jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
        np_params = jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(0), jcfg))
        params = params_from_jax(np_params, tcfg, "cpu")
        want = jax.tree.map(lambda a: (a.shape, str(a.dtype)), np_params)
        got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), params)
        assert got == want
        assert "float32" in {d for _, d in jax.tree.leaves(
            got, is_leaf=lambda x: isinstance(x, tuple))}


@pytest.mark.parametrize("s", [16, 20, 32])
def test_hymba_ring_placement_matches_jax(s):
    """The reference caveat, pinned: a prefill keeps a window layer's last
    ``min(window, s)`` keys at slots 0.. and decode writes position p at slot
    p % window. With the smoke window of 16, a prefill of 16 or 32 tokens
    then decodes exactly as a full prefill of s + 1 tokens; one of 20
    overwrites a key that is not the oldest, and the decode step differs
    from the full prefill. The port equals the JAX package in every case."""
    jcfg, tcfg, jparams, tparams = _pair("hymba-1.5b", seed=5)
    assert tcfg.window == 16
    tokens = np.random.default_rng(9).integers(0, tcfg.vocab_size, (1, s + 1))
    jcache, _ = japi.prefill(jparams, jnp.asarray(tokens[:, :s], jnp.int32), jcfg)
    tcache, _ = api.prefill(tparams, torch.from_numpy(tokens[:, :s]), tcfg)
    jcache = japi.pad_cache(jcfg, jcache, s + 4)
    tcache = api.pad_cache(tcfg, tcache, s + 4)
    nxt = tokens[:, s:]
    jcache, jlogits = japi.decode_step(jparams, jcache, jnp.asarray(nxt, jnp.int32), jcfg)
    tcache, tlogits = api.decode_step(tparams, tcache, torch.from_numpy(nxt), tcfg)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), **TOL)
    _assert_caches_close(tcache, jcache)
    _, full = api.prefill(tparams, torch.from_numpy(tokens), tcfg)
    gap = float(np.abs(_np(tlogits) - _np(full)).max())
    if s % tcfg.window:
        assert gap > 1e-2, gap
    else:
        assert gap < 1e-4, gap


@pytest.mark.parametrize("arch", list(PADDED))
def test_pad_cache_pads_the_new_axes_as_jax(arch):
    """``pad_cache`` zero-pads whisper's self cache at axis 2, the VLM's at
    axis 3 and MLA's latents at axis 2, as the reference's; the cross caches
    are shared, not copied."""
    jcfg, tcfg, jparams, tparams = _pair(arch, seed=4)
    tokens = np.random.default_rng(12).integers(0, tcfg.vocab_size, (2, 5))
    stubs = _stub_inputs(tcfg, 2)
    jcache, _ = japi.prefill(jparams, jnp.asarray(tokens, jnp.int32), jcfg,
                             **{k: jnp.asarray(x) for k, x in stubs.items()})
    tcache, _ = api.prefill(tparams, torch.from_numpy(tokens), tcfg,
                            **{k: torch.from_numpy(x) for k, x in stubs.items()})
    padded = api.pad_cache(tcfg, tcache, 9)
    _assert_caches_close(padded, japi.pad_cache(jcfg, jcache, 9))
    for name, t in padded.items():
        axis = PADDED[arch].get(name)
        if axis is None:
            assert t is tcache[name], name
            continue
        assert t.shape[axis] == 9 and tcache[name].shape[axis] == 5, name
        assert torch.equal(t.narrow(axis, 0, 5), tcache[name])
        assert not t.narrow(axis, 5, 4).any()
    assert api.pad_cache(tcfg, padded, 7)["k" if "k" in padded else "ckv"].shape == \
        padded["k" if "k" in padded else "ckv"].shape       # never cut


@pytest.mark.parametrize("arch", list(BATCH_AXES))
def test_cache_rows_name_each_leaf_with_its_batch_axis(arch):
    """``cache_rows`` lists every per-sequence leaf of the new families'
    caches with its batch axis (the VLM's self cache at axis 2): the row of
    a two-sequence prefill at that axis is the one-sequence prefill of that
    sequence."""
    _, tcfg, _, tparams = _pair(arch, seed=6)
    cache = api.init_cache(tcfg, 3, 7, "cpu")
    rows = api.cache_rows(tcfg, cache)
    names = [n for n in cache if n != "len"]
    assert [(id(t), ax) for t, ax in rows] == \
        [(id(cache[n]), BATCH_AXES[arch][n]) for n in names]
    assert all(t.shape[ax] == 3 for t, ax in rows)
    tokens = np.random.default_rng(13).integers(0, tcfg.vocab_size, (2, 6))
    stubs = {k: torch.from_numpy(x) for k, x in _stub_inputs(tcfg, 2).items()}
    both, _ = api.prefill(tparams, torch.from_numpy(tokens), tcfg, **stubs)
    one, _ = api.prefill(tparams, torch.from_numpy(tokens[1:]), tcfg,
                         **{k: x[1:] for k, x in stubs.items()})
    for (a, ax), (b, _) in zip(api.cache_rows(tcfg, both), api.cache_rows(tcfg, one)):
        torch.testing.assert_close(a.select(ax, 1), b.select(ax, 0), **TOL)


class _Reads(TorchDispatchMode):
    """The storages that the operators run under it read: the first argument
    of a gather (``aten.index``, ``aten.embedding``) apart, every other tensor
    argument of an operator that is not a view."""

    GATHERS = (torch.ops.aten.index.Tensor, torch.ops.aten.embedding.default)

    def __init__(self):
        super().__init__()
        self.whole, self.gathered = set(), set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not func.is_view:
            tensors = [t for t in pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)]
            for n, t in enumerate(tensors):
                ptr = t.untyped_storage().data_ptr()
                (self.gathered if n == 0 and func in self.GATHERS else self.whole).add(ptr)
        return func(*args, **kwargs)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_params_are_the_weights_the_step_reads(arch):
    """``api.decode_params`` lists exactly the weights that a decode step
    reads whole (each parameter's storage, seen by every operator the step
    runs), and the embedding is left out only where the step merely gathers
    its rows: the bytes a decode step's weight-read bound counts."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    cache = api.init_cache(cfg, 2, 8, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 1)))
    ptr = {t.untyped_storage().data_ptr(): t for t in cm.leaves(params) if t.numel()}
    with _Reads() as reads:
        api.decode_step(params, cache, tokens, cfg)
    listed = {t.untyped_storage().data_ptr() for t in api.decode_params(params, cfg)}
    assert reads.whole & ptr.keys() == listed
    embed = params["embed"].untyped_storage().data_ptr()
    assert reads.gathered & ptr.keys() == {embed}
    assert (embed in listed) == (embed in reads.whole)


def test_mla_absorbed_decode_matches_expanded_prefill():
    """MLA's two attention forms on the same weights: the absorbed decode
    step of the last token after a prefill of the others gives the expanded
    prefill's last logits over all the tokens (equal in exact arithmetic)."""
    cfg = dataclasses.replace(get_smoke_config("deepseek-v3-671b"), dtype="float32")
    params = api.init_params(torch.Generator().manual_seed(2), cfg)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 9)))
    cache, _ = api.prefill(params, tokens[:, :-1], cfg)
    _, step = api.decode_step(params, api.pad_cache(cfg, cache, 12), tokens[:, -1:], cfg)
    _, whole = api.prefill(params, tokens, cfg)
    torch.testing.assert_close(step, whole, **TOL)
