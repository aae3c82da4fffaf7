"""The port's dense model against the JAX package's, on the same weights.

JAX initialises the parameters; ``repro_torch.convert.params_from_jax``
carries them across as numpy. Norm weights and QKV biases are redrawn from a
numpy seed so that they are not trivially one and zero. Both run in float32:
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

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import api as japi
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.models import api

ARCHS = ["llama-13b", "qwen1.5-0.5b", "gemma-2b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _perturb(np_params, seed):
    rng = np.random.default_rng(seed)

    def visit(node, name=""):
        if isinstance(node, dict):
            return {k: visit(v, k) for k, v in node.items()}
        arr = np.asarray(node, np.float32)
        if "norm" in name:
            return (1.0 + 0.1 * rng.standard_normal(arr.shape)).astype(np.float32)
        if name in ("bq", "bk", "bv"):
            return (0.1 * rng.standard_normal(arr.shape)).astype(np.float32)
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


def _pad_port_cache(cache, max_len):
    out = dict(cache)
    for name in ("k", "v"):
        src = cache[name]
        dst = torch.zeros(src.shape[:2] + (max_len,) + src.shape[3:], dtype=src.dtype)
        dst[:, :, :src.shape[2]] = src
        out[name] = dst
    return out


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


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

    jcache, jlogits = japi.prefill(jparams, jnp.asarray(tokens, jnp.int32), jcfg)
    tcache, tlogits = api.prefill(tparams, torch.from_numpy(tokens), tcfg)
    assert tlogits.shape == (b, 1, tcfg.vocab_size)
    np.testing.assert_allclose(_np(tlogits), _np(jlogits), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]), **TOL)
    assert int(tcache["len"]) == int(jcache["len"]) == s

    jcache = japi.pad_cache(jcfg, jcache, max_len)
    tcache = _pad_port_cache(tcache, max_len)
    for step in range(3):
        nxt = rng.integers(0, tcfg.vocab_size, (b, 1))
        jcache, jlogits = japi.decode_step(jparams, jcache, jnp.asarray(nxt, jnp.int32), jcfg)
        tcache, tlogits = api.decode_step(tparams, tcache, torch.from_numpy(nxt), tcfg)
        assert int(tcache["len"]) == int(jcache["len"]) == s + step + 1
        np.testing.assert_allclose(_np(tlogits), _np(jlogits), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(_np(tcache[name]), _np(jcache[name]), **TOL)


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


def test_init_params_shapes_match_jax():
    """The port's own initialiser yields the JAX package's tree, shapes and
    dtypes, at the configured scales."""
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        jshapes = jax.tree.map(lambda a: (a.shape, str(a.dtype)),
                               japi.abstract_params(jax_smoke_config(arch)))
        params = api.init_params(torch.Generator().manual_seed(0), cfg)
        tshapes = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]),
                               params)
        assert tshapes == jshapes
        std = float(params["layers"]["wq"].float().std())
        assert abs(std - cfg.d_model ** -0.5) < 0.2 * cfg.d_model ** -0.5
