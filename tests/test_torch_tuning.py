"""The port's tuning knobs (``repro_torch.models.tuning``) against the JAX
package's, as tests/test_tuning.py holds the reference:

* the four cases of tests/test_tuning.py on the port: grouped attention
  and grouped decode attention equal the baseline within 1e-5 (causal,
  window, no mask), the three attention knobs together keep the smoke
  gemma-2b's loss within 2e-2 and its gradient's cosine above 0.99, and
  ``describe``;
* each knob set on both packages at once: the port's logits (prefill and
  one decode step) and loss on ``convert``ed f32 weights within 1e-5 of the
  reference's (2e-3 with ``attn_probs_bf16``: the two round P to bf16 from
  f32 probabilities that differ in their last bits), and its gradient
  (through ``FlashAttentionFunction``'s backward) against ``jax.grad`` of
  the reference's loss leaf by leaf, normwise, within GRAD_TOL
  (BF16_MODEL_GRAD_TOL with ``attn_probs_bf16``);
* the blocked backward of ``FlashAttentionFunction`` (``attn_block_remat``
  with ``q_block``) against the whole one within 1e-5; its backward under
  ``attn_probs_bf16`` against ``jax.grad`` through the reference's cast
  within BF16_GRAD_TOL normwise, and on the card (``gpu``, skipped here)
  equal to the knob-off one bit for bit, since K2 keeps P in f32; and with
  every knob off the plain attention computing as before bit for bit;
* the sharding rules' defaults read the two sharding knobs.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import api, tuning
from repro_torch.models import common as cm
from repro_torch.train.tree import flatten

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from test_torch_train_losses import (jax_paths, np_batch, pair, port_grads,  # noqa: E402
                                     torch_batch)

from repro.models import api as japi  # noqa: E402
from repro.models import common as jcm  # noqa: E402
from repro.models import tuning as jtuning  # noqa: E402

TOL = 1e-5
BF16_PROBS_TOL = 2e-3
#: a gradient leaf against jax.grad, normwise (tests/test_torch_train_losses.py's)
GRAD_TOL = 1e-4
#: the attention backward under attn_probs_bf16 against jax.grad through the
#: reference's cast, normwise per gradient: P computed in another order
#: rounds to the other bf16 neighbour here and there (worst read 1.3e-4, dv);
#: a backward that rounds P but not dP, or neither, reads 1.5e-3 or more
BF16_GRAD_TOL = 5e-4
#: a model's gradient leaf under attn_probs_bf16 against jax.grad, normwise:
#: the flips above carried through the smoke hymba-1.5b (worst read 4.5e-4,
#: gemma-2b 7e-7); a backward that keeps P and dP in f32 reads 1.9e-3 or more
BF16_MODEL_GRAD_TOL = 1e-3


@pytest.fixture(autouse=True)
def _reset_tuning():
    tuning.reset()
    jtuning.reset()
    yield
    tuning.reset()
    jtuning.reset()


@pytest.fixture(scope="module")
def jx():
    from repro.configs import get_smoke_config as jax_smoke_config
    import types
    return types.SimpleNamespace(jax=jax, jnp=jnp, smoke=jax_smoke_config, api=japi,
                                 common=jcm)


def _attn(q, k, v, **kw):
    """The port's plain attention in the model's (B, S, H, d) layout under
    the active knobs, through the models layer's reader."""
    return cm.attention(q, k, v, plain=True, **kw)


def _randn(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32))


# --------------------------------------------------------------------------- #
# tests/test_tuning.py on the port
# --------------------------------------------------------------------------- #
def test_grouped_attention_matches_baseline():
    q = _randn((2, 256, 8, 64), 0)
    k = _randn((2, 256, 2, 64), 1)
    v = _randn((2, 256, 2, 64), 2)
    for kwargs in (dict(causal=True), dict(causal=True, window=64), dict(causal=False)):
        tuning.set_tuning(q_block=128)
        base = _attn(q, k, v, **kwargs)
        tuning.set_tuning(attn_grouped=True, q_block=128)
        opt = _attn(q, k, v, **kwargs)
        np.testing.assert_allclose(opt.numpy(), base.numpy(), rtol=TOL, atol=TOL)
        # and the reference's, at the same q block
        jtuning.reset()
        want = jcm.attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)), q_block=128,
                             **kwargs)
        np.testing.assert_allclose(base.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_grouped_decode_matches_baseline():
    q = _randn((2, 1, 8, 64), 0)
    kc = _randn((2, 512, 2, 64), 3)
    vc = _randn((2, 512, 2, 64), 4)

    def dec():
        return cm.decode_attention(q, kc, vc, 300, plain=True)

    base = dec()
    tuning.set_tuning(attn_grouped=True)
    opt = dec()
    np.testing.assert_allclose(opt.numpy(), base.numpy(), rtol=TOL, atol=TOL)
    want = jcm.decode_attention(*(jnp.asarray(t.numpy()) for t in (q, kc, vc)), 300)
    np.testing.assert_allclose(base.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


def test_block_remat_preserves_grads():
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config("gemma-2b")
    params = api.init_params(torch.Generator().manual_seed(0), cfg)
    batch = api.make_batch(cfg, 2, 32)
    base_loss, _, base_grads = port_grads(params, batch, cfg)
    tuning.set_tuning(attn_grouped=True, attn_probs_bf16=True, attn_block_remat=True)
    opt_loss, _, opt_grads = port_grads(params, batch, cfg)
    # bf16 probs change rounding slightly; loss must agree to bf16 precision
    assert abs(base_loss.item() - opt_loss.item()) < 2e-2
    gb = torch.cat([g.float().ravel() for g in base_grads])
    go = torch.cat([g.float().ravel() for g in opt_grads])
    cos = float(gb @ go / (gb.norm() * go.norm()))
    assert cos > 0.99


def test_tuning_describe():
    assert tuning.Tuning().describe() == "baseline"
    t = tuning.Tuning(attn_grouped=True, seq_parallel=True)
    assert "attn_grouped" in t.describe() and "seq_parallel" in t.describe()
    for kw in ({}, dict(attn_grouped=True, seq_parallel=True),
               dict(attn_block_remat=True, q_block=512)):
        assert tuning.Tuning(**kw).describe() == jtuning.Tuning(**kw).describe()
    assert tuning.parse("attn_grouped,q_block=512") == dict(attn_grouped=True, q_block=512)


# --------------------------------------------------------------------------- #
# each knob on both packages
# --------------------------------------------------------------------------- #
KNOBS = [dict(attn_grouped=True), dict(attn_probs_bf16=True),
         dict(attn_block_remat=True, q_block=8), dict(q_block=8), dict(seq_parallel=True),
         dict(decode_cache_data_only=True)]
KNOB_ARCHS = ["gemma-2b", "hymba-1.5b"]
KNOB_CASES = [(arch, knob) for arch in KNOB_ARCHS for knob in KNOBS]


@pytest.mark.parametrize("arch,knob", KNOB_CASES,
                         ids=[f"{a}-{tuning.Tuning(**k).describe()}" for a, k in KNOB_CASES])
def test_knob_matches_reference(jx, arch, knob):
    """Logits, loss and the gradient (through FlashAttentionFunction's
    backward) under each knob against the reference's under the same knob."""
    jcfg, tcfg, jparams, tparams = pair(jx, arch)
    batch = np_batch(tcfg, b=2, s=24)
    tol = BF16_PROBS_TOL if knob.get("attn_probs_bf16") else TOL
    grad_tol = BF16_MODEL_GRAD_TOL if knob.get("attn_probs_bf16") else GRAD_TOL
    tuning.set_tuning(**knob)
    jtuning.set_tuning(**knob)
    tokens = batch["tokens"]
    jcache, jlogits = japi.prefill(jparams, jnp.asarray(tokens[:, :-1]), jcfg)
    jcache = japi.pad_cache(jcfg, jcache, tokens.shape[1])
    _, jdec = japi.decode_step(jparams, jcache, jnp.asarray(tokens[:, -1:]), jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jloss, jgrads = jax.value_and_grad(lambda p: japi.loss_fn(p, jbatch, jcfg)[0])(jparams)
    with torch.no_grad():
        tt = torch.from_numpy(tokens).long()
        cache, logits = api.prefill(tparams, tt[:, :-1], tcfg)
        cache = api.pad_cache(tcfg, cache, tt.shape[1])
        _, dec = api.decode_step(tparams, cache, tt[:, -1:], tcfg)
    loss, _, grads = port_grads(tparams, torch_batch(batch), tcfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=tol, atol=tol)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=tol, atol=tol)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=tol)
    want = jax_paths(jx, jgrads)
    assert [k for k, _ in flatten(tparams)] == [k for k, _ in want]
    for (path, w), g in zip(want, grads):
        err = np.linalg.norm(g.numpy() - w)
        assert err <= grad_tol * max(np.linalg.norm(w), 1e-30), (path, err, np.linalg.norm(w))


# --------------------------------------------------------------------------- #
# the attention backward and the knob-off path
# --------------------------------------------------------------------------- #
BWD_CASES = [(2, 256, 256, 8, 2, 64, True, 0, 64), (1, 192, 192, 6, 2, 32, True, 48, 64),
             (2, 128, 200, 4, 4, 32, False, 0, 32)]


@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal,window,q_block", BWD_CASES)
def test_blocked_attention_backward_matches_whole(b, sq, sk, h, kv, d, causal, window,
                                                   q_block):
    q = _randn((b, sq, h, d), 5).requires_grad_(True)
    k = _randn((b, sk, kv, d), 6).requires_grad_(True)
    v = _randn((b, sk, kv, d), 7).requires_grad_(True)
    do = _randn((b, sq, h, d), 8)

    def grads(**knobs):
        out = ops.FlashAttentionFunction.apply(q, k, v, causal, window,
                                               tuning.attention_knobs(tuning.Tuning(**knobs)))
        return torch.autograd.grad(out, (q, k, v), do)

    whole = grads()
    blocked = grads(attn_block_remat=True, q_block=q_block)
    for w, g in zip(whole, blocked):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=TOL, atol=TOL)
    # under attn_probs_bf16: the reference's gradient through its cast, whole
    # and blocked
    jtuning.set_tuning(attn_probs_bf16=True)
    jdo = jnp.asarray(do.numpy())
    want = jax.grad(lambda *qkv: jnp.sum(jcm.attention(*qkv, causal=causal, window=window,
                                                       q_block=sq) * jdo),
                    argnums=(0, 1, 2))(*(jnp.asarray(t.detach().numpy()) for t in (q, k, v)))
    for knobs in (dict(attn_probs_bf16=True),
                  dict(attn_probs_bf16=True, attn_block_remat=True, q_block=q_block)):
        for name, w, g in zip("qkv", want, grads(**knobs)):
            w = np.asarray(w)
            err = np.linalg.norm(g.numpy() - w)
            assert err <= BF16_GRAD_TOL * np.linalg.norm(w), (knobs, name, err)


@pytest.mark.gpu
def test_probs_bf16_moves_nothing_on_card():
    """K2 keeps P in f32 on the card, so under attn_probs_bf16 the
    Function's output and gradients there equal the knob-off ones bit for
    bit (the backward follows the forward it has)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, do = (torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
                   for shape in ((2, 256, 8, 64), (2, 256, 2, 64), (2, 256, 2, 64),
                                 (2, 256, 8, 64)))

    def run(**knobs):
        qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
        out = ops.FlashAttentionFunction.apply(qq, kk, vv, True, 64,
                                               tuning.attention_knobs(tuning.Tuning(**knobs)))
        return (out.detach(), *torch.autograd.grad(out, (qq, kk, vv), do))

    for a, b in zip(run(attn_probs_bf16=True), run()):
        assert torch.equal(a, b)


def test_knobs_off_plain_attention_unchanged():
    """With every knob off the plain attentions compute the formula they had
    before the knobs, bit for bit (K2 and K3 are held to them)."""
    q = _randn((2, 4, 40, 16), 9)
    k = _randn((2, 2, 40, 16), 10)
    v = _randn((2, 2, 40, 16), 11)
    kr, vr = (torch.repeat_interleave(t, 2, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q, kr) / math.sqrt(16)
    s = torch.where(ref.attention_mask(40, 40, True, 8, q.device)[None, None], s, ref.NEG_INF)
    want = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), vr)
    assert torch.equal(ref.mha_reference(q, k, v, causal=True, window=8), want)
    qd = q[:, :, 0]
    sd = torch.einsum("bhd,bhkd->bhk", qd, kr) / math.sqrt(16)
    sd = torch.where(torch.arange(40)[None, None, :] < 33, sd, ref.NEG_INF)
    want = torch.einsum("bhk,bhkd->bhd", torch.softmax(sd, dim=-1), vr)
    assert torch.equal(ref.decode_attention_reference(qd, k, v, 33), want)


def test_sharding_defaults_read_the_knobs():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_dist

    cfg = get_config("qwen1.5-0.5b")
    torch.distributed.init_process_group("fake", store=FakeStore(), rank=0, world_size=256)
    try:
        dist = make_dist()
        cache = api.init_cache(cfg, 32, 256, "meta")
        for on in (False, True):
            tuning.set_tuning(seq_parallel=on, decode_cache_data_only=on)
            assert shd.activation_spec(cfg, dist, "act_bsd", (32, 256, 64)) == \
                shd.activation_spec(cfg, dist, "act_bsd", (32, 256, 64), seq_parallel=on)
            assert shd.cache_specs(cfg, cache, dist) == \
                shd.cache_specs(cfg, cache, dist, data_only=on)
        assert shd.cache_specs(cfg, cache, dist) != shd.cache_specs(cfg, cache, dist,
                                                                    data_only=False)
    finally:
        torch.distributed.destroy_process_group()


def test_knob_dataclass_matches_reference():
    assert [f.name for f in dataclasses.fields(tuning.Tuning)] == \
        [f.name for f in dataclasses.fields(jtuning.Tuning)]
    assert dataclasses.asdict(tuning.Tuning()) == dataclasses.asdict(jtuning.Tuning())
