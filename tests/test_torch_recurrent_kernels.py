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
from repro_torch.kernels import rwkv6_scan as k6
from repro_torch.kernels import ssm_scan as k5
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
# launch plans
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("bsz,s,di,n,aligned,plan", [
    (4, 1, 3200, 16, True, (4, 4, 128, 1, 100)),       # hymba-1.5b decode: 51,200 threads
    (2, 5, 3200, 16, True, (4, 4, 128, 5, 100)),
    (1, 32, 3200, 16, True, (2, 8, 128, 32, 200)),     # hymba-1.5b prefill, B = 1
    (1, 2048, 3200, 16, True, (2, 8, 128, 32, 200)),
    (1, 5, 1600, 16, True, (1, 16, 128, 5, 200)),
    (4, 1, 3200, 16, False, (1, 16, 128, 1, 400)),     # the scalar path
    (8, 1, 3200, 8, True, (4, 2, 128, 1, 50)),
    (2, 37, 200, 8, True, (1, 8, 128, 32, 13)),        # I not a multiple of the block
    (1, 3, 3, 8, True, (1, 8, 128, 3, 1)),             # most of the block past I
])
def test_ssm_launch_plan(bsz, s, di, n, aligned, plan):
    assert dataclasses.astuple(k5.launch_plan(bsz, s, di, n, aligned)) == plan


@pytest.mark.parametrize("n", k5.STATE_SIZES)
@pytest.mark.parametrize("aligned", [True, False])
def test_ssm_launch_plan_covers_the_scan(n, aligned):
    """Every plan: lanes x group = N, whole warps, every channel in a block,
    the tile within the shared memory, G = 1 off the 16-byte grid; G
    falls as B I falls; each group can be asked for when aligned."""
    for bsz in (1, 2, 4, 16):
        for di in (1, 7, 33, 200, 1600, 3200, 4096):
            for s in (0, 1, 31, 32, 33, 2048):
                groups = [None, *k5.GROUPS] if aligned else [None, 1]
                for group in groups:
                    p = k5.launch_plan(bsz, s, di, n, aligned, group)
                    assert p.lanes * p.group == n
                    assert p.threads == k5.BLOCK_THREADS and p.threads % p.lanes == 0
                    assert p.blocks * p.channels >= di > (p.blocks - 1) * p.channels
                    assert 1 <= p.steps <= max(1, min(s, k5.TILE_STEPS))
                    assert p.smem_bytes <= k5.SMEM_LIMIT
                    assert aligned or p.group == 1
                    if group is not None:
                        assert p.group == group
                    else:
                        assert (p.group == 1 or bsz * di * p.lanes >= k5.TARGET_THREADS)
    with pytest.raises(ValueError):
        k5.launch_plan(4, 1, 3200, n, False, 4)    # strided or misaligned a: scalar only


@pytest.mark.parametrize("bsz,h,s,kd,plan", [
    (4, 40, 1, 64, (2, 4, 128, 1, 2560, 320)),      # rwkv6-3b decode
    (1, 40, 32, 64, (2, 4, 128, 20, 46336, 80)),    # rwkv6-3b prefill, B = 1
    (8, 40, 1, 64, (1, 8, 128, 1, 3328, 320)),
    (16, 40, 64, 64, (1, 8, 128, 14, 43264, 640)),  # the tile cut to fit
    (2, 3, 37, 16, (2, 1, 32, 32, 15424, 12)),      # K = 16: at most 2 slices
    (1, 2, 70, 32, (2, 1, 128, 32, 36992, 4)),
])
def test_wkv_launch_plan(bsz, h, s, kd, plan):
    assert dataclasses.astuple(k6.launch_plan(bsz, h, s, kd)) == plan


@pytest.mark.parametrize("kd", k6.HEAD_SIZES)
def test_wkv_launch_plan_covers_the_state(kd):
    """Every plan: the column slices tile K in quads, a block of whole warps
    and whole row groups a warp covers all K rows, the tile within the
    shared memory; the fewest slices that reach the target."""
    for bsz in (1, 2, 4, 64):
        for h in (1, 3, 40, 64):
            for s in (0, 1, 13, 32, 33, 512):
                for slices in (None, *k6.SLICES):
                    p = k6.launch_plan(bsz, h, s, kd, slices)
                    cols = kd // p.slices
                    quads = cols // 4
                    assert p.slices * cols == kd and cols % 4 == 0
                    assert kd % p.rows == 0 and p.threads == quads * (kd // p.rows)
                    assert p.threads % 32 == 0 and 32 <= p.threads <= k6.BLOCK_THREADS
                    assert 32 % quads == 0
                    assert 1 <= p.steps <= max(1, min(s, k6.TILE_STEPS))
                    assert p.steps <= 32 // quads or p.steps % (32 // quads) == 0
                    assert p.smem_bytes <= k6.SMEM_LIMIT
                    assert p.blocks == bsz * h * p.slices
                    if slices is None and p.slices > 1:
                        assert bsz * h * (p.slices // 2) < k6.TARGET_BLOCKS


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
    <= tol (1 + |plain|), at every branch of their launch plans: K5 with 1,
    2 and 4 state entries a thread (by shape and asked for), I not a
    multiple of the block, a strided and a misaligned a (the scalar path);
    K6 with 1 and 2 column slices (by shape and asked for), the model's
    (B, S, H, K) views and a state off the 16-byte grid (moved as single
    floats), carried and in place. Both at
    the serving shapes, a ragged length, S = 1 from a carried state, a state
    carried across two calls (the second in place), large dt and extreme
    decays; every call twice for the same bits."""
    before = tk.launch_counts()
    launches = {"ssm_scan": 0, "wkv6": 0}

    def dev(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in arrays]

    def twice(name, fn, *args, **kw):
        got = fn(*args, **kw)
        again = fn(*args, **kw)
        assert all(torch.equal(x, y) for x, y in zip(got, again))
        launches[name] += 2
        return got

    def check_ssm(args, h0, plan=None):
        want = ssm_scan_plain(*args, h0=h0)
        for got, ref_ in zip(twice("ssm_scan", ssm_scan, *args, h0=h0, plan=plan), want):
            torch.testing.assert_close(got, ref_, **SSM_TOL)

    for bsz, s, di, n, big_dt, group in [
            (1, 32, 3200, 16, False, 2), (4, 1, 3200, 16, False, 4),
            (1, 5, 1600, 16, False, 1), (4, 3, 3000, 16, False, 4),
            (2, 37, 200, 8, False, 1), (8, 2, 3200, 8, False, 4),
            (2, 40, 160, 16, True, 1)]:
        u, dt, a, b, c = ssm_inputs(20, bsz, s, di, n)
        if big_dt:
            dt = dt * 100.0
        args = dev(u, dt, a, b, c)
        h0 = torch.randn(bsz, di, n, device=cuda)
        assert k5.launch_plan(bsz, s, di, n, True).group == group
        check_ssm(args, h0)
        if (bsz, s, di) == (4, 1, 3200):            # every group asked for
            for g in k5.GROUPS:
                check_ssm(args, h0, k5.launch_plan(bsz, s, di, n, True, g))
        y1, h1 = ssm_scan(*(x[:, :13] if x.ndim == 3 else x for x in args))
        y2, h2 = ssm_scan(*(x[:, 13:] if x.ndim == 3 else x for x in args), h0=h1, h_out=h1)
        launches["ssm_scan"] += 2
        assert h2 is h1
        y, h = ssm_scan_plain(*args)
        torch.testing.assert_close(torch.cat([y1, y2], dim=1), y, **SSM_TOL)
        torch.testing.assert_close(h2, h, **SSM_TOL)
    # the scalar path: a transposed (strided) a, and an a off the 16-byte grid;
    # B and C cut from one projection, as the Mamba branch passes them
    u, dt, a, b, c = dev(*ssm_inputs(22, 4, 1, 3200, 16))
    proj = torch.cat([torch.zeros(4, 1, 3, device=cuda), b, c], dim=-1)
    strided = a.t().contiguous().t()
    shifted = torch.empty(a.numel() + 1, device=cuda)[1:].view(a.shape).copy_(a)
    h0 = torch.randn(4, 3200, 16, device=cuda)
    for a_ in (strided, shifted):
        check_ssm([u, dt, a_, proj[..., 3:19], proj[..., 19:]], h0)
    with pytest.raises(ValueError):
        ssm_scan(u, dt, strided, b, c, h0, plan=k5.launch_plan(4, 1, 3200, 16, True, 4))

    def check_wkv(args, st0, plan=None):
        want = wkv6_plain(*args, state0=st0)
        for got, ref_ in zip(twice("wkv6", wkv6, *args, state0=st0, plan=plan), want):
            torch.testing.assert_close(got, ref_, **WKV_TOL)

    for b, h, s, kd, extreme, slices in [(1, 40, 32, 64, False, 2), (4, 40, 1, 64, False, 2),
                                         (8, 40, 1, 64, False, 1), (2, 3, 37, 16, False, 2),
                                         (1, 2, 70, 32, True, 2)]:
        args = dev(*wkv_inputs(21, b, h, s, kd, extreme))
        st0 = torch.randn(b, h, kd, kd, device=cuda)
        assert k6.launch_plan(b, h, s, kd).slices == slices
        check_wkv(args, st0)
        if (b, s) in ((4, 1), (1, 32)):             # every slice count asked for
            for c in k6.SLICES:
                check_wkv(args, st0, k6.launch_plan(b, h, s, kd, c))
        part = [x[:, :, :13] if x.ndim == 4 else x for x in args]
        rest = [x[:, :, 13:] if x.ndim == 4 else x for x in args]
        y1, st1 = wkv6(*part)
        y2, st2 = wkv6(*rest, state0=st1, state_out=st1)
        launches["wkv6"] += 2
        assert st2 is st1
        y, st = wkv6_plain(*args)
        torch.testing.assert_close(torch.cat([y1, y2], dim=2), y, **WKV_TOL)
        torch.testing.assert_close(st2, st, **WKV_TOL)
        # the model's (B, S, H, K) projections, read through head-major views
        bshk = [x.transpose(1, 2).contiguous().transpose(1, 2) if x.ndim == 4 else x
                for x in args]
        check_wkv(bshk, st0)
    # a state off the 16-byte grid moves as single floats, also in place
    shifted = torch.empty(st0.numel() + 1, device=cuda)[1:].view(st0.shape).copy_(st0)
    check_wkv(args, shifted)
    want = wkv6_plain(*args, state0=st0)
    got = wkv6(*args, state0=shifted, state_out=shifted)
    launches["wkv6"] += 1
    assert got[1] is shifted
    for x, ref_ in zip(got, want):
        torch.testing.assert_close(x, ref_, **WKV_TOL)
    torch.cuda.synchronize()
    after = tk.launch_counts()
    assert launches == {"ssm_scan": 38, "wkv6": 41}
    assert {k: after[k] - before[k] for k in after} == dict(dict.fromkeys(after, 0), **launches)
