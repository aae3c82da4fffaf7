"""The port's training losses and the K1/K2 autograd Functions against the
JAX package.

Losses: ``repro_torch.models.api.loss_fn`` of each family at its smoke
config against ``repro.models.api.loss_fn`` on the same weights (the JAX
init, norm weights, biases and constant-initialised parameters redrawn from
a numpy seed, carried across by ``repro_torch.convert.params_from_jax``) and
the same batch, both in float32 (the reference casts softmax probabilities
to v's dtype, which only f32 hides). The VLM's cross gates are opened and
its vision, like whisper's frames, is random, so the cross paths reach the
loss. Tolerances: the loss and its metrics (``ce``, ``aux``, ``ce_mtp``)
within 1e-5 relative; each gradient leaf against ``jax.grad`` normwise,
``|g - g_ref| <= 1e-4 |g_ref|``.

Functions: ``torch.autograd.gradcheck`` in float64 (the plain versions
compute in f64 for f64 inputs), and f32 gradients against autograd through
the plain versions within 1e-5, at causal, window, Sq != Sk and GQA
shapes (K5's and K6's Functions: ``test_torch_recurrent_grads.py``). The
``gpu`` test holds the wrappers' refusal of a gradient cut on the card and
the Functions there; it skips here. JAX is imported in a fixture, so that test still
collects on a machine without it.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.rmsnorm import rmsnorm_plain
from repro_torch.models import api
from repro_torch.models import common as cm
from repro_torch.train.tree import flatten

FAMILY_ARCHS = ["qwen1.5-0.5b", "granite-moe-3b-a800m", "deepseek-v3-671b",
                "whisper-tiny", "llama-3.2-vision-90b", "hymba-1.5b", "rwkv6-3b"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4
FN_TOL = 1e-5
#: layer norms whose weights and biases are redrawn
LN_PREFIXES = ("ln", "gn", "enc_ln", "dec_ln")


@pytest.fixture(scope="module")
def jx():
    """The JAX package. Imported here, not at the top: the machine with the
    card, where the ``gpu`` test runs, has no JAX."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import api as japi
    from repro.models import common as jcm
    return types.SimpleNamespace(jax=jax, jnp=jnp, smoke=jax_smoke_config, api=japi,
                                 common=jcm)


def perturb(np_params, seed):
    """Norm weights near 1, biases and constant-initialised parameters near
    0 or their start, redrawn from ``seed``; the VLM's gates opened to
    0.5 +- 0.1."""
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
                or name in ("beta_attn", "beta_ssm", "d_skip") or name.startswith("norm_"):
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


def pair(jx, arch, seed=0):
    """(jax cfg, port cfg, jax params, port params) on the same f32 weights."""
    jcfg = dataclasses.replace(jx.smoke(arch), dtype="float32")
    tcfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    np_params = jx.jax.tree.map(np.asarray, jx.api.init_params(jx.jax.random.PRNGKey(seed),
                                                               jcfg))
    np_params = perturb(np_params, seed + 1)
    return (jcfg, tcfg, jx.jax.tree.map(jx.jnp.asarray, np_params),
            params_from_jax(np_params, tcfg, "cpu"))


def np_batch(cfg, b=2, s=24, seed=3):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((b, cfg.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["vision"] = rng.standard_normal(
            (b, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return out


def torch_batch(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else torch.from_numpy(v)
            for k, v in batch.items()}


def port_grads(params, batch, cfg, plain=False):
    flat = [leaf for _, leaf in flatten(params)]
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = api.loss_fn(params, batch, cfg, plain=plain)
    grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    return loss, metrics, grads


def jax_paths(jx, tree):
    flat, _ = jx.jax.tree_util.tree_flatten_with_path(tree)
    return [(jx.jax.tree_util.keystr(p), np.asarray(x)) for p, x in flat]


# --------------------------------------------------------------------------- #
# losses and gradients, every family
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_grads_match_jax(jx, arch):
    jcfg, tcfg, jparams, tparams = pair(jx, arch)
    batch = np_batch(tcfg)
    jbatch = {k: jx.jnp.asarray(v) for k, v in batch.items()}

    def jloss(p):
        return jx.api.loss_fn(p, jbatch, jcfg)

    (jl, jmetrics), jgrads = jx.jax.value_and_grad(jloss, has_aux=True)(jparams)
    loss, metrics, grads = port_grads(tparams, torch_batch(batch), tcfg)

    np.testing.assert_allclose(loss.item(), float(jl), rtol=LOSS_RTOL)
    assert set(metrics) == set(jmetrics)
    for name, value in jmetrics.items():
        np.testing.assert_allclose(float(metrics[name]), float(value), rtol=LOSS_RTOL,
                                   atol=1e-12, err_msg=name)
    want = jax_paths(jx, jgrads)
    got = flatten(tparams)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (path, w), g in zip(want, grads):
        g = g.numpy()
        assert g.shape == w.shape, path
        err = np.linalg.norm(g - w)
        assert err <= GRAD_TOL * max(np.linalg.norm(w), 1e-30), (path, err, np.linalg.norm(w))


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "granite-moe-3b-a800m",
                                  "llama-3.2-vision-90b", "hymba-1.5b", "rwkv6-3b"])
def test_plain_and_function_paths_agree(jx, arch):
    """``plain=True`` (autograd through the plain versions) and the kernel
    path (the Functions, their forward the plain version on the CPU) give
    the same loss and gradients."""
    _, tcfg, _, tparams = pair(jx, arch)
    batch = torch_batch(np_batch(tcfg))
    loss, _, grads = port_grads(tparams, batch, tcfg)
    ploss, _, pgrads = port_grads(tparams, batch, tcfg, plain=True)
    torch.testing.assert_close(loss, ploss, rtol=FN_TOL, atol=0)
    for g, p in zip(grads, pgrads):
        assert (g - p).norm() <= FN_TOL * max(p.norm(), 1e-30)


def test_cross_entropy_matches_jax(jx):
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 7, 50)).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) > 0.3
    for m in (None, mask):
        want = jx.common.cross_entropy(jx.jnp.asarray(logits), jx.jnp.asarray(labels),
                                       None if m is None else jx.jnp.asarray(m))
        got = cm.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                               None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


@pytest.mark.parametrize("length,chunk", [(32, 8), (20, 8), (8, 8)])
def test_chunked_scan_matches_jax(jx, length, chunk):
    """Values and gradients of the chunk-checkpointed scan, a decaying
    linear recurrence, against the JAX package's ``chunked_scan``."""
    rng = np.random.default_rng(6)
    h0 = rng.standard_normal((2, 4)).astype(np.float32)
    a = rng.uniform(0.5, 0.99, (length, 2, 4)).astype(np.float32)
    u = rng.standard_normal((length, 2, 4)).astype(np.float32)

    def step(h, x):
        h = x[0] * h + x[1]
        return h, (h * h).sum(-1)

    def jloss(h0, a, u):
        h, ys = jx.common.chunked_scan(step, h0, (a, u), chunk=chunk)
        return (h * h).sum() + ys.sum()

    jgrads = jx.jax.grad(jloss, argnums=(0, 1, 2))(*(jx.jnp.asarray(t) for t in (h0, a, u)))
    ts = [torch.from_numpy(t).requires_grad_(True) for t in (h0, a, u)]
    h, ys = cm.chunked_scan(step, ts[0], tuple(ts[1:]), chunk=chunk)
    assert ys.shape == (length, 2)
    loss = (h * h).sum() + ys.sum()
    np.testing.assert_allclose(float(loss), float(jloss(*(jx.jnp.asarray(t) for t in (h0, a, u)))),
                               rtol=1e-5)
    for g, w in zip(torch.autograd.grad(loss, ts), jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_abstract_param_counts_match_jax(jx):
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config
    for arch in ("qwen1.5-0.5b", "granite-moe-3b-a800m", "deepseek-v3-671b", "hymba-1.5b"):
        assert api.count_params_abstract(get_config(arch)) == \
            jx.api.count_params_abstract(jax_config(arch)), arch
        assert api.active_params_abstract(get_config(arch)) == \
            jx.api.active_params_abstract(jax_config(arch)), arch
    tree = api.abstract_params(get_config("qwen1.5-0.5b"))
    assert {t.device.type for t in cm.leaves(tree)} == {"meta"}
    _, _, _, tparams = pair(jx, "rwkv6-3b")
    assert api.count_params(tparams) == sum(int(np.prod(x.shape)) for _, x in flatten(tparams))


def test_make_batch_shapes():
    for arch in ("qwen1.5-0.5b", "whisper-tiny", "llama-3.2-vision-90b"):
        cfg = get_smoke_config(arch)
        b = api.make_batch(cfg, 2, 12, torch.Generator().manual_seed(1))
        assert b["tokens"].shape == b["labels"].shape == (2, 12)
        assert b["tokens"].dtype == torch.int64 and int(b["tokens"].max()) < cfg.vocab_size
        stub = {"encdec": "frames", "vlm": "vision"}.get(cfg.family)
        assert set(b) == {"tokens", "labels"} | ({stub} if stub else set())
        if stub:
            assert b[stub].dtype == torch.float32 and b[stub].shape[-1] == cfg.d_model
        assert torch.equal(api.make_batch(cfg, 2, 12, torch.Generator().manual_seed(1))
                           ["tokens"], b["tokens"])


# --------------------------------------------------------------------------- #
# the K1 and K2 Functions
# --------------------------------------------------------------------------- #
ATTN_CASES = [  # (Sq, Sk, H, KV, causal, window)
    (9, 9, 4, 2, True, 0), (9, 9, 4, 1, True, 4), (5, 11, 4, 2, False, 0),
    (11, 5, 2, 2, False, 3), (7, 7, 6, 6, False, 0)]


def _rnd(seed, *shape, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=dtype).requires_grad_(True)


def test_rmsnorm_function_gradcheck():
    x, w = _rnd(0, 3, 5, 16), _rnd(1, 16)
    assert torch.autograd.gradcheck(
        lambda x, w: ops.RMSNormFunction.apply(x, w, 1e-6), (x, w))


@pytest.mark.parametrize("sq,sk,h,kv,causal,window", ATTN_CASES)
def test_flash_attention_function_gradcheck(sq, sk, h, kv, causal, window):
    q, k, v = _rnd(2, 2, sq, h, 8), _rnd(3, 2, sk, kv, 8), _rnd(4, 2, sk, kv, 8)
    assert torch.autograd.gradcheck(
        lambda q, k, v: ops.FlashAttentionFunction.apply(q, k, v, causal, window), (q, k, v))


def test_rmsnorm_function_matches_plain_f32():
    x, w = _rnd(5, 4, 7, 32, dtype=torch.float32), _rnd(6, 32, dtype=torch.float32)
    dy = torch.randn((4, 7, 32), generator=torch.Generator().manual_seed(7))
    out = ops.rmsnorm(x, w)
    assert out.grad_fn is not None and "RMSNormFunction" in type(out.grad_fn).__name__
    got = torch.autograd.grad(out, (x, w), dy)
    want = torch.autograd.grad(rmsnorm_plain(x, w), (x, w), dy)
    torch.testing.assert_close(out, rmsnorm_plain(x, w), rtol=0, atol=0)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=FN_TOL, atol=FN_TOL)


@pytest.mark.parametrize("sq,sk,h,kv,causal,window", ATTN_CASES)
def test_flash_attention_function_matches_plain_f32(sq, sk, h, kv, causal, window):
    f32 = torch.float32
    q, k, v = (_rnd(8, 2, sq, h, 16, dtype=f32), _rnd(9, 2, sk, kv, 16, dtype=f32),
               _rnd(10, 2, sk, kv, 16, dtype=f32))
    dout = torch.randn((2, sq, h, 16), generator=torch.Generator().manual_seed(11))
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert "FlashAttentionFunction" in type(out.grad_fn).__name__
    plain = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                  causal=causal, window=window).transpose(1, 2)
    got = torch.autograd.grad(out, (q, k, v), dout)
    want = torch.autograd.grad(plain, (q, k, v), dout)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=FN_TOL, atol=FN_TOL)


def test_inference_calls_skip_the_functions():
    """Without an input that requires grad (inference), or in no-grad mode,
    the wrappers are called directly: no autograd node, as before."""
    x, w = torch.randn(2, 3, 16), torch.ones(16)
    assert ops.rmsnorm(x, w).grad_fn is None
    q = torch.randn(1, 5, 2, 8, requires_grad=True)
    with torch.no_grad():
        assert ops.flash_attention(q, q, q).grad_fn is None
        assert ops.rmsnorm(q, torch.ones(8)).grad_fn is None


# --------------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_wrappers_refuse_a_gradient_cut_on_card(cuda, monkeypatch):
    """Each kernel wrapper given a CUDA tensor that requires grad, in grad
    mode, raises instead of returning a result with no gradient: K1, K2, K5
    and K6 naming their Function, K3 and the backward kernels saying they
    have no backward; in no-grad mode they launch. The Functions' gradients
    match autograd through the plain versions in f32, K5's and K6's backward
    kernels their plain backwards, and hymba's and RWKV's kernel-path losses
    give finite gradients that match their plain paths' as closely as two
    correct computations do."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rmsnorm as rms
    from repro_torch.kernels import rwkv6_scan as wkv
    from repro_torch.kernels import ssm_scan as ssm

    g = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).requires_grad_(True)

    x, w = rnd(4, 64), rnd(64)
    with pytest.raises(RuntimeError, match="RMSNormFunction"):
        rms.rmsnorm(x, w)
    q, k = rnd(1, 2, 16, 64), rnd(1, 2, 16, 64)
    with pytest.raises(RuntimeError, match="FlashAttentionFunction"):
        fa.flash_attention(q, k, k)
    with pytest.raises(NotImplementedError, match="decode_attention"):
        da.decode_attention(q[:, :, 0], k, k, 8)
    a = -torch.rand((8, 16), generator=g, device=cuda)
    ssm_args = (rnd(1, 3, 8), torch.rand((1, 3, 8), device=cuda), a, rnd(1, 3, 16),
                rnd(1, 3, 16))
    with pytest.raises(RuntimeError, match="SsmScanFunction"):
        ssm.ssm_scan(*ssm_args)
    r = rnd(1, 2, 3, 64)
    wkv_args = (r, r, r, torch.rand((1, 2, 3, 64), device=cuda), rnd(2, 64))
    with pytest.raises(RuntimeError, match="Wkv6Function"):
        wkv.wkv6(*wkv_args)
    with pytest.raises(NotImplementedError, match="ssm_scan_backward"):
        ssm.ssm_scan_backward(*ssm_args, None, rnd(1, 3, 8), None)
    with pytest.raises(NotImplementedError, match="wkv6_backward"):
        wkv.wkv6_backward(*wkv_args, None, rnd(1, 2, 3, 64), None)
    with torch.no_grad():
        for args, fn, bwd in ((ssm_args, ssm.ssm_scan, ssm.ssm_scan_backward),
                              (wkv_args, wkv.wkv6, wkv.wkv6_backward)):
            y, state = fn(*args)
            dy, dstate = torch.randn_like(y), torch.randn_like(state)
            got = bwd(*args, None, dy, dstate)
            want = (ssm.ssm_scan_backward_plain if fn is ssm.ssm_scan
                    else wkv.wkv6_backward_plain)(*args, None, dy, dstate)
            for grad, plain_grad in zip(got, want):
                torch.testing.assert_close(grad, plain_grad, rtol=1e-4, atol=1e-4)
    with torch.no_grad():
        assert rms.rmsnorm(x, w).grad_fn is None
    out = ops.rmsnorm(x, w)
    torch.testing.assert_close(
        torch.autograd.grad(out.sum(), (x, w)),
        torch.autograd.grad(rmsnorm_plain(x, w).sum(), (x, w)), rtol=FN_TOL, atol=FN_TOL)
    qm = rnd(2, 16, 4, 64)
    km, vm = rnd(2, 16, 2, 64), rnd(2, 16, 2, 64)
    out = ops.flash_attention(qm, km, vm, causal=True)
    ref = ops.flash_attention(qm, km, vm, causal=True, plain=True)
    for got, want in zip(torch.autograd.grad(out.square().sum(), (qm, km, vm)),
                         torch.autograd.grad(ref.square().sum(), (qm, km, vm))):
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    from repro_torch.configs import get_config
    from repro_torch.kernels.ref import ssm_scan_reference, wkv6_reference

    def in_f64(reference):  # the plain recurrence in float64, cast back
        return lambda *args: tuple(t.float() for t in reference(
            *(None if t is None else t.double() for t in args[:6])))

    for arch, mod, plain_name, reference in (
            ("hymba-1.5b", ssm, "ssm_scan_plain", ssm_scan_reference),
            ("rwkv6-3b", wkv, "wkv6_plain", wkv6_reference)):
        # full widths (K2 takes head dims 32-256), two layers
        cfg = dataclasses.replace(get_config(arch), dtype="float32", n_layers=2)
        params = api.init_params(torch.Generator(device=cuda).manual_seed(1), cfg)
        for p in cm.leaves(params):
            p.requires_grad_(True)
        batch = api.make_batch(cfg, 1, 8, torch.Generator(device=cuda).manual_seed(2))
        loss, _, grads = port_grads(params, batch, cfg)
        ploss, _, pgrads = port_grads(params, batch, cfg, plain=True)
        monkeypatch.setattr(mod, plain_name, in_f64(reference))
        _, _, fgrads = port_grads(params, batch, cfg, plain=True)
        monkeypatch.undo()
        torch.testing.assert_close(loss, ploss, rtol=1e-5, atol=0)
        assert all(torch.isfinite(g).all() for g in grads), arch
        # the whole gradient, normwise, within twice the plain path's distance
        # from itself with the recurrence in float64 (its floor: single leaves
        # of two correct f32 computations fall 2e-4 to 5e-4 apart here), or
        # within GRAD_TOL
        norm = torch.stack([p.norm() for p in pgrads]).norm()

        def whole(gs):
            return float(torch.stack([(g - p).norm() for g, p in zip(gs, pgrads)]).norm() / norm)

        assert whole(grads) <= max(2 * whole(fgrads), GRAD_TOL), (arch, whole(grads),
                                                                  whole(fgrads))
