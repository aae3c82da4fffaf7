"""The port's recurrent kernels (K5 Mamba selective scan, K6 RWKV-6 WKV)
against the JAX package's.

On the CPU the port's wrappers run their plain versions; these are held to
the Pallas kernels (interpret mode, as tests/test_kernels.py runs them) and
to ``repro.kernels.ref`` on the same numpy inputs, at that file's
tolerances (2e-3 for the selective scan, 1e-3 for WKV: the Pallas kernels'
chunked closed forms sum in another order than the sequential oracle). A
carried state, which the Pallas kernels do not take, is held to the JAX
models' own single-step recurrences. The card's kernels are held to the
plain versions by the ``gpu`` test, which skips where there is no card.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv6_scan import wkv6, wkv6_plain
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_plain
from repro_torch.models import hymba

SSM_TOL = dict(rtol=2e-3, atol=2e-3)
WKV_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def jk():
    """The JAX package's Pallas kernels, oracles and models. Imported here,
    not at the top: the machine with the card, where the ``gpu`` test runs,
    has no JAX."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ref
    from repro.kernels import run_replay as rr
    from repro.kernels.rwkv6_scan import wkv6 as pallas_wkv6
    from repro.kernels.ssm_scan import ssm_scan as pallas_ssm_scan
    from repro.models import hymba as jhymba
    from repro.models import rwkv as jrwkv
    return types.SimpleNamespace(jax=jax, jnp=jnp, ref=ref, interpret=rr.default_interpret(),
                                 wkv6=pallas_wkv6, ssm_scan=pallas_ssm_scan,
                                 hymba=jhymba, rwkv=jrwkv)


def _rng(seed):
    return np.random.default_rng(seed)


def ssm_inputs(seed, bsz, s, di, n):
    """The cases of tests/test_kernels.py::test_ssm_scan, drawn with numpy:
    u, B, C standard normal, dt = softplus(normal), a = -exp(0.5 normal)."""
    rng = _rng(seed)
    u = rng.standard_normal((bsz, s, di))
    dt = np.log1p(np.exp(rng.standard_normal((bsz, s, di))))
    a = -np.exp(rng.standard_normal((di, n)) * 0.5)
    b = rng.standard_normal((bsz, s, n))
    c = rng.standard_normal((bsz, s, n))
    return [x.astype(np.float32) for x in (u, dt, a, b, c)]


def wkv_inputs(seed, b, h, s, kd, extreme=False):
    """The cases of tests/test_kernels.py::test_wkv6: r, k, v normal, w =
    0.4 + 0.55 sigmoid(normal), u = 0.1 normal; ``extreme`` draws each decay
    from {1e-4, 0.999} and sets u = 0, as test_wkv6_extreme_decay."""
    rng = _rng(seed)
    r, k, v = (rng.standard_normal((b, h, s, kd)) for _ in range(3))
    if extreme:
        w = np.where(rng.random((b, h, s, kd)) < 0.5, 0.999, 1e-4)
        u = np.zeros((h, kd))
    else:
        w = 0.4 + 0.55 / (1.0 + np.exp(-rng.standard_normal((b, h, s, kd))))
        u = rng.standard_normal((h, kd)) * 0.1
    return [x.astype(np.float32) for x in (r, k, v, w, u)]


def t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **tol)


# --------------------------------------------------------------------------- #
# K5 selective scan
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("bsz,s,di,n,chunk,bi", [
    (2, 64, 32, 8, 16, 32), (1, 96, 64, 16, 32, 32), (2, 128, 128, 16, 32, 64),
])
def test_ssm_scan_plain_matches_pallas(jk, bsz, s, di, n, chunk, bi):
    arrs = ssm_inputs(0, bsz, s, di, n)
    y, h = ssm_scan(*t(*arrs))
    assert y.shape == (bsz, s, di) and h.shape == (bsz, di, n)
    assert y.dtype == h.dtype == torch.float32
    jy, jh = jk.ssm_scan(*(jk.jnp.asarray(a) for a in arrs), chunk=chunk, block_i=bi,
                         interpret=jk.interpret)
    ry, rh = jk.ref.ssm_scan_reference(*(jk.jnp.asarray(a) for a in arrs))
    close(y, jy, SSM_TOL)
    close(h, jh, SSM_TOL)
    close(y, ry, SSM_TOL)
    close(h, rh, SSM_TOL)


def test_ssm_scan_large_dt_decays_to_input():
    """Large dt drives exp(dt a) to 0: the state forgets, stays finite, and
    equals dt B u of the last step."""
    u, dt, a, b, c = ssm_inputs(1, 2, 9, 16, 8)
    dt = np.full_like(dt, 200.0)
    y, h = ssm_scan(*t(u, dt, a, b, c))
    assert torch.isfinite(y).all() and torch.isfinite(h).all()
    want = dt[:, -1, :, None] * b[:, -1, None, :] * u[:, -1, :, None]
    close(h, want, SSM_TOL)


@pytest.mark.parametrize("split", [1, 17, 36])
def test_ssm_scan_state_carried_across_calls(split):
    """Two calls, the second from the first's final state (written in place
    over its h0), equal one call over the concatenation."""
    u, dt, a, b, c = t(*ssm_inputs(2, 2, 37, 24, 16))
    y, h = ssm_scan(u, dt, a, b, c)
    y1, h1 = ssm_scan(u[:, :split], dt[:, :split], a, b[:, :split], c[:, :split])
    y2, h2 = ssm_scan(u[:, split:], dt[:, split:], a, b[:, split:], c[:, split:],
                      h0=h1, h_out=h1)
    assert h2 is h1
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(h2, h, rtol=1e-5, atol=1e-5)


def test_ssm_scan_single_step_matches_jax_selective_scan(jk):
    """S = 1 from a carried state, plus the D-skip, equals the JAX model's
    ``selective_scan`` with ``h0``."""
    u, dt, a, b, c = ssm_inputs(3, 4, 1, 48, 16)
    h0 = _rng(4).standard_normal((4, 48, 16)).astype(np.float32)
    d_skip = _rng(5).standard_normal(48).astype(np.float32)
    y, h = ssm_scan(*t(u, dt, a, b, c), h0=torch.from_numpy(h0))
    y = y + torch.from_numpy(u) * torch.from_numpy(d_skip)
    jy, jh = jk.hymba.selective_scan(*(jk.jnp.asarray(x) for x in (u, dt, a, b, c, d_skip)),
                                     h0=jk.jnp.asarray(h0))
    close(y, jy, SSM_TOL)
    close(h, jh, SSM_TOL)


def test_mamba_step_matches_jax(jk):
    """The port's ``mamba_step`` (K5 at S = 1, states advanced in place)
    equals the JAX model's, whose recurrence is written out inline."""
    cfg = dataclasses.replace(get_smoke_config("hymba-1.5b"), dtype="float32")
    from repro.configs import get_smoke_config as jax_smoke_config
    jcfg = dataclasses.replace(jax_smoke_config("hymba-1.5b"), dtype="float32")
    rng = _rng(6)
    lp = jk.jax.tree.map(np.asarray, jk.hymba.init_params(jk.jax.random.PRNGKey(1), jcfg))
    lp = {k: np.array(v, np.float32) for k, v in lp["layers"][0].items()}
    lp["dt_bias"] = (0.1 * rng.standard_normal(lp["dt_bias"].shape)).astype(np.float32)
    lp["d_skip"] = (1 + 0.1 * rng.standard_normal(lp["d_skip"].shape)).astype(np.float32)
    x = rng.standard_normal((3, 1, cfg.d_model)).astype(np.float32)
    conv = rng.standard_normal((3, cfg.conv_kernel - 1, cfg.d_inner)).astype(np.float32)
    ssm = rng.standard_normal((3, cfg.d_inner, cfg.ssm_state)).astype(np.float32)
    tconv, tssm = t(conv.copy(), ssm.copy())     # advanced in place
    out = hymba.mamba_step(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in lp.items()},
                           cfg, tconv, tssm)
    jout, jconv, jssm = jk.hymba.mamba_step(
        jk.jnp.asarray(x), {k: jk.jnp.asarray(v) for k, v in lp.items()}, jcfg,
        jk.jnp.asarray(conv), jk.jnp.asarray(ssm))
    close(out, jout, dict(rtol=1e-4, atol=1e-4))
    close(tconv, jconv, dict(rtol=1e-6, atol=1e-6))
    close(tssm, jssm, dict(rtol=1e-4, atol=1e-4))


def test_ssm_scan_model_layout():
    """ops.ssm_scan passes the Mamba branch's (B, S, I) views (B and C cut
    from one projection) straight to the kernel module."""
    u, dt, a, b, c = t(*ssm_inputs(7, 2, 11, 32, 8))
    proj = torch.cat([torch.zeros(2, 11, 3), b, c], dim=-1)
    y, h = ops.ssm_scan(u, dt, a, proj[..., 3:11], proj[..., 11:])
    ye, he = ssm_scan(u, dt, a, b, c)
    torch.testing.assert_close(y, ye, rtol=0, atol=0)
    torch.testing.assert_close(h, he, rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# K6 WKV
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b,h,s,kd,chunk", [
    (2, 3, 64, 16, 16), (1, 2, 128, 32, 32), (1, 1, 96, 64, 32), (2, 2, 64, 32, 64),
])
def test_wkv6_plain_matches_pallas(jk, b, h, s, kd, chunk):
    arrs = wkv_inputs(10, b, h, s, kd)
    y, st = wkv6(*t(*arrs))
    assert y.shape == (b, h, s, kd) and st.shape == (b, h, kd, kd)
    jy, jst = jk.wkv6(*(jk.jnp.asarray(a) for a in arrs), chunk=chunk,
                      interpret=jk.interpret)
    ry, rst = jk.ref.wkv6_reference(*(jk.jnp.asarray(a) for a in arrs))
    close(y, jy, WKV_TOL)
    close(st, jst, WKV_TOL)
    close(y, ry, WKV_TOL)
    close(st, rst, WKV_TOL)


def test_wkv6_extreme_decay_matches_pallas(jk):
    """Decays of 1e-4 and 0.999 stay finite (tests/test_kernels.py's
    extreme-decay case)."""
    arrs = wkv_inputs(11, 1, 1, 64, 16, extreme=True)
    y, st = wkv6(*t(*arrs))
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    jy, _ = jk.wkv6(*(jk.jnp.asarray(a) for a in arrs), chunk=32, interpret=jk.interpret)
    ry, _ = jk.ref.wkv6_reference(*(jk.jnp.asarray(a) for a in arrs))
    close(y, jy, WKV_TOL)
    close(y, ry, WKV_TOL)


@pytest.mark.parametrize("split", [1, 20, 36])
def test_wkv6_state_carried_across_calls(split):
    """Two calls, the second from the first's final state (written in place
    over its state0), equal one call over the concatenation."""
    r, k, v, w, u = t(*wkv_inputs(12, 2, 3, 37, 16))
    y, st = wkv6(r, k, v, w, u)
    y1, st1 = wkv6(r[:, :, :split], k[:, :, :split], v[:, :, :split], w[:, :, :split], u)
    y2, st2 = wkv6(r[:, :, split:], k[:, :, split:], v[:, :, split:], w[:, :, split:], u,
                   state0=st1, state_out=st1)
    assert st2 is st1
    torch.testing.assert_close(torch.cat([y1, y2], dim=2), y, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(st2, st, rtol=1e-5, atol=1e-5)


def test_wkv6_single_step_matches_jax_wkv_step(jk):
    """S = 1 from a carried state equals the JAX model's ``wkv_step``."""
    r, k, v, w, u = wkv_inputs(13, 4, 5, 1, 64)
    state = _rng(14).standard_normal((4, 5, 64, 64)).astype(np.float32)
    y, st = wkv6(*t(r, k, v, w, u), state0=torch.from_numpy(state))
    jy, jst = jk.rwkv.wkv_step(*(jk.jnp.asarray(x[:, :, 0]) for x in (r, k, v, w)),
                               jk.jnp.asarray(u), jk.jnp.asarray(state))
    close(y[:, :, 0], jy, WKV_TOL)
    close(st, jst, WKV_TOL)


def test_wkv6_model_layout():
    """ops.wkv6 takes the model's (B, S, H, K) projections and equals the
    head-major kernel module on transposed inputs."""
    r, k, v, w, u = t(*wkv_inputs(15, 2, 4, 9, 16))
    bshk = [x.transpose(1, 2).contiguous() for x in (r, k, v, w)]
    y, st = ops.wkv6(*bshk, u)
    ye, ste = wkv6(r, k, v, w, u)
    assert y.shape == (2, 9, 4, 16)
    torch.testing.assert_close(y, ye.transpose(1, 2), rtol=0, atol=0)
    torch.testing.assert_close(st, ste, rtol=0, atol=0)


def test_cpu_tensors_never_launch():
    """On the CPU both wrappers take the plain version and count nothing."""
    tk.reset_launch_counts()
    ops.ssm_scan(*t(*ssm_inputs(16, 1, 3, 8, 8)))
    r, k, v, w, u = t(*wkv_inputs(17, 1, 2, 3, 16))
    ops.wkv6(*(x.transpose(1, 2) for x in (r, k, v, w)), u)
    assert set(tk.launch_counts().values()) == {0}


# --------------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_recurrent_kernels_match_plain_on_card(cuda):
    """K5 and K6 against their plain versions per element, |kernel - plain|
    <= tol (1 + |plain|): the serving shapes, a ragged length, S = 1 from a
    carried state, a state carried across two calls, large dt and extreme
    decays."""
    before = tk.launch_counts()

    def dev(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in arrays]

    for bsz, s, di, n, big_dt in [(1, 32, 3200, 16, False), (4, 1, 3200, 16, False),
                                  (2, 37, 200, 8, False), (2, 40, 160, 16, True)]:
        u, dt, a, b, c = ssm_inputs(20, bsz, s, di, n)
        if big_dt:
            dt = dt * 100.0
        args = dev(u, dt, a, b, c)
        h0 = torch.randn(bsz, di, n, device=cuda)
        for got, want in zip(ssm_scan(*args, h0=h0), ssm_scan_plain(*args, h0=h0)):
            torch.testing.assert_close(got, want, **SSM_TOL)
        y1, h1 = ssm_scan(*(x[:, :13] if x.ndim == 3 else x for x in args))
        y2, h2 = ssm_scan(*(x[:, 13:] if x.ndim == 3 else x for x in args), h0=h1, h_out=h1)
        y, h = ssm_scan_plain(*args)
        torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, **SSM_TOL)
        torch.testing.assert_close(h2, h, **SSM_TOL)
    for b, h, s, kd, extreme in [(1, 40, 32, 64, False), (4, 40, 1, 64, False),
                                 (2, 3, 37, 16, False), (1, 2, 70, 32, True)]:
        args = dev(*wkv_inputs(21, b, h, s, kd, extreme))
        st0 = torch.randn(b, h, kd, kd, device=cuda)
        for got, want in zip(wkv6(*args, state0=st0), wkv6_plain(*args, state0=st0)):
            torch.testing.assert_close(got, want, **WKV_TOL)
        part = [x[:, :, :13] if x.ndim == 4 else x for x in args]
        rest = [x[:, :, 13:] if x.ndim == 4 else x for x in args]
        y1, st1 = wkv6(*part)
        y2, st2 = wkv6(*rest, state0=st1, state_out=st1)
        y, st = wkv6_plain(*args)
        torch.testing.assert_close(torch.cat([y1, y2], dim=2), y, **WKV_TOL)
        torch.testing.assert_close(st2, st, **WKV_TOL)
    torch.cuda.synchronize()
    after = tk.launch_counts()
    assert {k: after[k] - before[k] for k in after} == dict(
        dict.fromkeys(after, 0), ssm_scan=12, wkv6=12)
