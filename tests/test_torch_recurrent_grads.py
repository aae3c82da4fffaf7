"""The selective scan's (K5) and the WKV recurrence's (K6) gradients against
autograd and the JAX package.

The plain backwards (``repro_torch.kernels.ref.ssm_scan_backward_reference``
and ``wkv6_backward_reference``, the analytic reverse recurrences) are held
to autograd through the plain forwards in float64 within 1e-10, and to
``jax.grad`` of the JAX package's ``repro.kernels.ref.ssm_scan_reference`` /
``wkv6_reference`` in float32 within 1e-5 normwise per output, on inputs
drawn by numpy: S = 1 and odd lengths, a given initial state, a nonzero
gradient of the final state, large dt (exp(dt a) -> 0) and decays at 1e-4
and 0.999. ``SsmScanFunction`` and ``Wkv6Function`` pass
``torch.autograd.gradcheck`` in float64. On the CPU the Functions run the
plain versions; the ``gpu`` test holds the backward kernels to the plain
backwards on the card (it skips here). JAX is imported in a fixture, so the
file still collects on a machine without it.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan as k6
from repro_torch.kernels import ssm_scan as k5

JAX_TOL = 1e-5
F64_TOL = 1e-10
#: (S, initial state given, final-state gradient given, large dt / extreme decays)
CASES = [(1, True, True, False), (7, False, False, False), (7, True, True, False),
         (20, True, False, False), (9, False, True, True), (20, True, True, True)]


@pytest.fixture(scope="module")
def jx():
    """The JAX package's reference scans. Imported here, not at the top: the
    machine with the card, where the ``gpu`` test runs, has no JAX."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.kernels import ref as jref
    return types.SimpleNamespace(jax=jax, jnp=jnp, ref=jref)


def ssm_inputs(seed, s, state, dstate, big_dt, bsz=2, di=6, n=8):
    """u, dt, a, b, c, h0, dy, dh_out as numpy float32 (h0 / dh_out None
    unless asked): dt = softplus(normal), x 100 for ``big_dt``."""
    rng = np.random.default_rng(seed)

    def nrm(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    dt = np.log1p(np.exp(nrm(bsz, s, di))) * (100.0 if big_dt else 1.0)
    return (nrm(bsz, s, di), dt.astype(np.float32), -np.exp(0.5 * nrm(di, n)),
            nrm(bsz, s, n), nrm(bsz, s, n), nrm(bsz, di, n) if state else None,
            nrm(bsz, s, di), nrm(bsz, di, n) if dstate else None)


def wkv_inputs(seed, s, state, dstate, extreme, bsz=2, h=3, kd=8):
    """r, k, v, w, u, state0, dy, dstate_out as numpy float32, head-major
    (B, H, S, K): w = 0.4 + 0.55 sigmoid(normal) or each from {1e-4, 0.999}."""
    rng = np.random.default_rng(seed)

    def nrm(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    if extreme:
        w = np.where(nrm(bsz, h, s, kd) > 0, 0.999, 1e-4)
    else:
        w = 0.4 + 0.55 / (1.0 + np.exp(-nrm(bsz, h, s, kd)))
    return (nrm(bsz, h, s, kd), nrm(bsz, h, s, kd), nrm(bsz, h, s, kd),
            w.astype(np.float32), 0.1 * nrm(h, kd),
            nrm(bsz, h, kd, kd) if state else None, nrm(bsz, h, s, kd),
            nrm(bsz, h, kd, kd) if dstate else None)


def tensors(arrays, dtype=torch.float32):
    return [None if x is None else torch.from_numpy(x).to(dtype) for x in arrays]


def autograd_grads(forward, inputs, dy, dstate):
    """Gradients of sum(y * dy) + sum(state * dstate) at ``inputs`` (None
    entries skipped, their gradient None) by autograd through ``forward``."""
    leaves = [None if x is None else x.clone().requires_grad_(True) for x in inputs]
    y, state = forward(*leaves)
    loss = (y * dy).sum() + (0.0 if dstate is None else (state * dstate).sum())
    given = [x for x in leaves if x is not None]
    grads = iter(torch.autograd.grad(loss, given, allow_unused=True, materialize_grads=True))
    return [None if x is None else next(grads) for x in leaves]


# --------------------------------------------------------------------------- #
# the plain backwards
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("s,state,dstate,edge", CASES)
def test_ssm_backward_plain_matches_autograd_f64(s, state, dstate, edge):
    u, dt, a, b, c, h0, dy, dh = tensors(ssm_inputs(1, s, state, dstate, edge), torch.float64)
    want = autograd_grads(ref.ssm_scan_reference, (u, dt, a, b, c, h0), dy, dh)
    got = ref.ssm_scan_backward_reference(u, dt, a, b, c, h0, dy, dh)
    for name, g, w in zip("u dt a b c h0".split(), got, want):
        assert g.dtype == torch.float64
        if w is not None:
            torch.testing.assert_close(g, w, rtol=F64_TOL, atol=F64_TOL, msg=name)


@pytest.mark.parametrize("s,state,dstate,edge", CASES)
def test_wkv_backward_plain_matches_autograd_f64(s, state, dstate, edge):
    r, k, v, w, u, s0, dy, ds = tensors(wkv_inputs(2, s, state, dstate, edge), torch.float64)
    want = autograd_grads(ref.wkv6_reference, (r, k, v, w, u, s0), dy, ds)
    got = ref.wkv6_backward_reference(r, k, v, w, u, s0, dy, ds)
    for name, g, x in zip("r k v w u state0".split(), got, want):
        assert g.dtype == torch.float64
        if x is not None:
            torch.testing.assert_close(g, x, rtol=F64_TOL, atol=F64_TOL, msg=name)


def jax_grads(jx, fn, arrays, dy, dstate):
    """``jax.grad`` of sum(y * dy) + sum(state * dstate) at the given
    (non-None) arrays of ``fn``'s arguments, in float32."""
    given = [i for i, x in enumerate(arrays) if x is not None]

    def loss(*xs):
        args = list(arrays)
        for i, x in zip(given, xs):
            args[i] = x
        y, state = fn(*args)
        out = (y * dy).sum()
        return out if dstate is None else out + (state * dstate).sum()

    grads = jx.jax.grad(loss, argnums=tuple(range(len(given))))(
        *(jx.jnp.asarray(arrays[i]) for i in given))
    out = [None] * len(arrays)
    for i, g in zip(given, grads):
        out[i] = np.asarray(g)
    return out


def assert_normwise(got, want, names):
    for name, g, w in zip(names, got, want):
        if w is None:
            continue
        g = g.numpy()
        assert g.shape == w.shape, name
        err = np.linalg.norm(g - w)
        assert err <= JAX_TOL * max(np.linalg.norm(w), 1e-30), (name, err, np.linalg.norm(w))


@pytest.mark.parametrize("s,state,dstate,big_dt", CASES)
def test_ssm_backward_plain_matches_jax_grad(jx, s, state, dstate, big_dt):
    arrays = ssm_inputs(3, s, state, dstate, big_dt)
    dy, dh = (None if x is None else jx.jnp.asarray(x) for x in arrays[6:])
    want = jax_grads(jx, jx.ref.ssm_scan_reference, list(arrays[:6]), dy, dh)
    got = ref.ssm_scan_backward_reference(*tensors(arrays))
    assert all(g.dtype == torch.float32 for g in got)
    assert_normwise(got, want, "u dt a b c h0".split())


@pytest.mark.parametrize("s,state,dstate,extreme", CASES)
def test_wkv_backward_plain_matches_jax_grad(jx, s, state, dstate, extreme):
    arrays = wkv_inputs(4, s, state, dstate, extreme)
    dy, ds = (None if x is None else jx.jnp.asarray(x) for x in arrays[6:])
    want = jax_grads(jx, jx.ref.wkv6_reference, list(arrays[:6]), dy, ds)
    got = ref.wkv6_backward_reference(*tensors(arrays))
    assert all(g.dtype == torch.float32 for g in got)
    assert_normwise(got, want, "r k v w u state0".split())


# --------------------------------------------------------------------------- #
# the Functions
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("state", [True, False])
def test_ssm_scan_function_gradcheck(state):
    u, dt, a, b, c, h0, _, _ = tensors(ssm_inputs(5, 5, state, False, False, di=3, n=4),
                                       torch.float64)
    ins = [x.requires_grad_(True) for x in (u, dt, a, b, c, h0) if x is not None]
    assert torch.autograd.gradcheck(
        lambda *x: ops.SsmScanFunction.apply(*x, *([] if state else [None])), ins)


@pytest.mark.parametrize("state", [True, False])
def test_wkv6_function_gradcheck(state):
    r, k, v, w, u, s0, _, _ = tensors(wkv_inputs(6, 5, state, False, False, h=2, kd=4),
                                      torch.float64)
    # the Function takes the model's (B, S, H, K) layout
    r, k, v, w = (x.transpose(1, 2).contiguous() for x in (r, k, v, w))
    ins = [x.requires_grad_(True) for x in (r, k, v, w, u, s0) if x is not None]
    assert torch.autograd.gradcheck(
        lambda *x: ops.Wkv6Function.apply(*x, *([] if state else [None])), ins)


def test_ops_take_the_functions_under_autograd():
    """Under grad mode with an input that requires grad, ``ops.ssm_scan`` and
    ``ops.wkv6`` run the Functions and match autograd through the plain
    versions; without grad they call the wrappers (no autograd node)."""
    u, dt, a, b, c, h0, dy, dh = tensors(ssm_inputs(7, 11, True, True, False))
    u.requires_grad_(True)
    y, h = ops.ssm_scan(u, dt, a, b, c, h0)
    assert "SsmScanFunction" in type(y.grad_fn).__name__
    yp, hp = ops.ssm_scan(u, dt, a, b, c, h0, plain=True)
    torch.testing.assert_close(y, yp, rtol=0, atol=0)
    got = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), u)
    want = torch.autograd.grad((yp * dy).sum() + (hp * dh).sum(), u)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        assert ops.ssm_scan(u, dt, a, b, c, h0)[0].grad_fn is None

    r, k, v, w, uu, s0, dy, ds = tensors(wkv_inputs(8, 11, True, True, False))
    r, k, v, w, dy = (x.transpose(1, 2) for x in (r, k, v, w, dy))
    w.requires_grad_(True)
    y, st = ops.wkv6(r, k, v, w, uu, s0)
    assert "Wkv6Function" in type(y.grad_fn).__name__
    yp, sp = ops.wkv6(r, k, v, w, uu, s0, plain=True)
    torch.testing.assert_close(y, yp, rtol=0, atol=0)
    got = torch.autograd.grad((y * dy).sum() + (st * ds).sum(), w)
    want = torch.autograd.grad((yp * dy).sum() + (sp * ds).sum(), w)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert ops.wkv6(r.detach(), k, v, w.detach(), uu, s0)[0].grad_fn is None


def test_in_place_state_under_autograd_raises():
    """A decode step's carried state, written in place, cannot be
    differentiated: under autograd the call raises instead of cutting the
    gradient."""
    u, dt, a, b, c, h0, _, _ = tensors(ssm_inputs(9, 1, True, False, False))
    u.requires_grad_(True)
    with pytest.raises(RuntimeError, match="in place"):
        ops.ssm_scan(u, dt, a, b, c, h0, h_out=h0)
    r, k, v, w, uu, s0, _, _ = tensors(wkv_inputs(10, 1, True, False, False))
    r = r.transpose(1, 2).requires_grad_(True)
    k, v, w = (x.transpose(1, 2) for x in (k, v, w))
    with pytest.raises(RuntimeError, match="in place"):
        ops.wkv6(r, k, v, w, uu, s0, state_out=s0)
    with torch.no_grad():          # the decode step itself is untouched
        ops.ssm_scan(u, dt, a, b, c, h0, h_out=h0)
        ops.wkv6(r, k, v, w, uu, s0, state_out=s0)


def test_cpu_backward_wrappers_count_nothing():
    """On the CPU the backward wrappers run the plain backwards and count
    no launch; their counters are among the package's."""
    tk.reset_launch_counts()
    args = tensors(ssm_inputs(11, 3, True, True, False))
    got = k5.ssm_scan_backward(*args)
    for g, w in zip(got, ref.ssm_scan_backward_reference(*args)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    k6.wkv6_backward(*tensors(wkv_inputs(12, 3, True, True, False)))
    counts = tk.launch_counts()
    assert counts["ssm_scan_bwd"] == counts["wkv6_bwd"] == 0
    with tk.captured_launches() as graph:
        k5.BWD_LAUNCHES += 2
    assert graph["ssm_scan_bwd"] == 2 and tk.launch_counts()["ssm_scan_bwd"] == 0
    tk.count_replay(graph, 3)
    assert k5.BWD_LAUNCHES == 6
    tk.reset_launch_counts()
    assert set(tk.launch_counts().values()) == {0}


# --------------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("s,state,dstate,edge", CASES + [(2048, False, False, False)])
def test_backward_kernels_match_plain_on_card(cuda, s, state, dstate, edge):
    """K5's and K6's backward kernels against their plain backwards on the
    card, per element within 1e-3 (1 + |plain|) (chip_smoke.py's readings:
    3.3e-4 at the worst, K5's db and dc under large dt), at hymba-1.5b's
    and rwkv6-3b's widths, twice for the same bits."""
    before = tk.launch_counts()
    args = [None if x is None else x.to(cuda) for x in tensors(
        ssm_inputs(13, s, state, dstate, edge, bsz=2, di=3200, n=16))]
    got, again = k5.ssm_scan_backward(*args), k5.ssm_scan_backward(*args)
    for g, a, w in zip(got, again, ref.ssm_scan_backward_reference(*args)):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)
    s6 = min(s, 128)
    args = [None if x is None else x.to(cuda) for x in tensors(
        wkv_inputs(14, s6, state, dstate, edge, bsz=2, h=40, kd=64))]
    got, again = k6.wkv6_backward(*args), k6.wkv6_backward(*args)
    for g, a, w in zip(got, again, ref.wkv6_backward_reference(*args)):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)
    after = tk.launch_counts()
    assert after["ssm_scan_bwd"] - before["ssm_scan_bwd"] == 2
    assert after["wkv6_bwd"] - before["wkv6_bwd"] == 2
