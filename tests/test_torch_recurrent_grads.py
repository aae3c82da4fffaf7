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

The backward kernels' launch plans (``ssm_scan.backward_plan``,
``rwkv6_scan.backward_plan``) are checked at every shape chip_smoke.py runs
them at, and the decompositions the kernels compute are written here in
plain PyTorch and held in float64 to the plain backwards and in float32 to
``jax.grad``: K5′ split into time segments whose carries compose through
exp(a sum dt), K6′ computed column slice by column slice with the
cross-column partials summed afterwards, both recomputing each chunk's
states from the state kept at its start.
"""
import importlib.util
import pathlib
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rwkv6_scan as k6
from repro_torch.kernels import ssm_scan as k5

#: chip_smoke.py, for the backward cases and plans it runs on the card
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)

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
# the backward kernels' launch plans
# --------------------------------------------------------------------------- #
#: shared memory a block may opt into on an H100 (227 KB); an SM's, and what
#: the card keeps back for each block
SMEM_OPT_IN = 232_448
SM_SMEM = 228 * 1024
BLOCK_RESERVED_SMEM = 1024
#: (B, S, I, N) of every K5′ launch chip_smoke.py makes, hymba-1.5b's first
SSM_BWD_SHAPES = sorted({(2, 2048, 3200, 16)} | {
    (c[0], c[1], c[5], c[6]) for c in cs.SSM_BWD_CASES + cs.SSM_BWD_PLAN_CASES})
#: (B, H, S, K) of every K6′ launch, rwkv6-3b's first
WKV_BWD_SHAPES = sorted({(8, 40, 128, 64)} | {
    (c[0], c[5], c[1], c[6]) for c in cs.WKV_BWD_CASES})


@pytest.mark.parametrize("shape", SSM_BWD_SHAPES)
def test_ssm_backward_plans_are_valid(shape):
    """Every plan of K5′'s backward at the shape (each group, each segment
    count the length allows, and the default): whole rows of whole lanes, a
    block's shared memory within the opt-in limit and at least one block an
    SM, every segment non-empty, the channels and chunks covered; the
    default's grid at least as busy (``_fill``) as any other segment count's
    of its group."""
    bsz, s, di, n = shape
    plans = cs.ssm_bwd_plans(bsz, s, di, n)
    default = k5.backward_plan(bsz, s, di, n)
    assert plans and default in plans
    for plan in plans:
        assert plan.lanes * plan.group == n and k5.BWD_THREADS % plan.lanes == 0
        assert plan.channels * plan.lanes == k5.BWD_THREADS
        # two blocks an SM, as the kernel's __launch_bounds__(256, 2) plans
        assert plan.smem_bytes <= SMEM_OPT_IN
        assert 2 * (plan.smem_bytes + BLOCK_RESERVED_SMEM) <= SM_SMEM
        assert plan.tiles * plan.channels >= di > (plan.tiles - 1) * plan.channels
        assert plan.seg_chunks * plan.segments >= plan.chunks
        assert plan.segments == 1 or (plan.segments - 1) * plan.seg_chunks < plan.chunks
        assert plan.chunk % plan.lanes == 0 and plan.chunks * plan.chunk >= s
        assert plan.scratch_bytes == 4 * bsz * plan.chunks * di * n
        assert plan.bc_part_bytes == 4 * 2 * bsz * plan.tiles * s * n
    same_group = [p for p in plans if p.group == default.group]
    assert k5._fill(default) == max(k5._fill(p) for p in same_group)


def test_ssm_backward_plan_at_hymba_training_shape():
    """hymba-1.5b's 2 x 2,048 tokens: 4 entries a thread, 64 channels a
    block, so each db, dc partial that leaves a block covers 64 channels:
    26.2 MB (25.0 MiB) of partials against the first design's 105 MB, and
    the card filled by 8 segments (800 blocks, 2 an SM)."""
    plan = k5.backward_plan(2, 2048, 3200, 16)
    assert (plan.group, plan.channels, plan.chunk, plan.segments) == (4, 64, 8, 8)
    assert plan.blocks == 800 and 2 * (plan.smem_bytes + BLOCK_RESERVED_SMEM) <= SM_SMEM
    assert plan.bc_part_bytes <= 26 * 2**20
    assert plan.scratch_bytes == 104_857_600 and plan.cumdt_bytes == 6_553_600
    with pytest.raises(ValueError):
        k5.backward_plan(2, 2048, 3200, 16, segments=3)
    with pytest.raises(ValueError):
        k5.backward_plan(1, 1, 3200, 16, segments=2)


@pytest.mark.parametrize("shape", WKV_BWD_SHAPES)
def test_wkv_backward_plans_are_valid(shape):
    """K6′'s plan: K / 16 column slices a (row, head), 4 K threads a block,
    shared memory within the opt-in limit and two blocks an SM; the scratch
    keeps the state every 16 steps."""
    bsz, h, s, kd = shape
    plan = k6.backward_plan(bsz, h, s, kd)
    assert plan.slices * k6.BWD_COLS == kd and plan.threads == 4 * kd
    assert plan.blocks == bsz * h * plan.slices
    assert 2 * (plan.smem_bytes + BLOCK_RESERVED_SMEM) <= SM_SMEM
    assert plan.chunks == -(-s // k6.BWD_CHUNK)
    assert plan.scratch_bytes == 4 * bsz * h * plan.chunks * kd * kd


def test_wkv_backward_plan_at_rwkv_training_shape():
    """rwkv6-3b's 8 x 128 tokens: 1,280 blocks (4 slices of 16 columns),
    a 42 MB scratch of chunk states against the first design's 671 MB of
    every step's."""
    plan = k6.backward_plan(8, 40, 128, 64)
    assert plan.blocks == 1280 and plan.slices == 4
    assert plan.scratch_bytes <= 84e6 and plan.scratch_bytes == 41_943_040
    with pytest.raises(ValueError):
        k6.backward_plan(8, 40, 128, 48)


# --------------------------------------------------------------------------- #
# the decompositions the kernels compute
# --------------------------------------------------------------------------- #
def ssm_backward_segmented(u, dt, a, b, c, h0, dy, dh_out, segments, chunk):
    """K5′'s algorithm in PyTorch ops: S split into ``segments`` of whole
    ``chunk``-step chunks. Each segment walks forward from a zero state (the
    first from h0), keeping the state entering each chunk, the sum of dt from
    its start to each chunk, and per entry the product D of its dA's, its end
    state and gl = sum_t (prod_{s <= t} dA_s) c_t dy_t. The carries compose in
    segment order (h_in = D h_in' + h_end', g_in = D g_in' + gl'); each
    segment then walks back chunk by chunk, adding exp(a sum dt) h_in to each
    kept state and recomputing the chunk's states from it. Returns (du, ddt,
    da, db, dc, dh0) as ``ref.ssm_scan_backward_reference`` does."""
    acc = ref.acc_dtype(u.dtype)
    u, dt, a, b, c, dy = (t.to(acc) for t in (u, dt, a, b, c, dy))
    bsz, s, di = u.shape
    n = a.shape[-1]
    zeros = u.new_zeros((bsz, di, n))
    chunks = -(-s // chunk)
    seg_chunks = max(1, -(-chunks // segments))
    bounds = [(min(s, q * seg_chunks * chunk), min(s, (q + 1) * seg_chunks * chunk))
              for q in range(segments)]

    def step(h, t):
        d_a = torch.exp(dt[:, t, :, None] * a)
        return d_a, d_a * h + dt[:, t, :, None] * b[:, t, None, :] * u[:, t, :, None]

    kept, cum, carries = {}, {}, []
    for q, (t0, t1) in enumerate(bounds):
        h = zeros if q or h0 is None else h0.to(acc)
        d, gl, csum = torch.ones_like(zeros), zeros, u.new_zeros((bsz, di))
        for t in range(t0, t1):
            if (t - t0) % chunk == 0:
                kept[t], cum[t] = h, csum
            d_a, h = step(h, t)
            d = d * d_a
            gl = gl + d * c[:, t, None, :] * dy[:, t, :, None]
            csum = csum + dt[:, t]
        carries.append((d, h, gl))
    h_in, h = [], zeros
    for d, h_end, _ in carries:
        h_in.append(h)
        h = d * h + h_end
    g_in, g = [None] * segments, zeros if dh_out is None else dh_out.to(acc)
    for q in reversed(range(segments)):
        g_in[q] = g
        d, _, gl = carries[q]
        g = d * g + gl
    du, ddt, db, dc = (torch.zeros_like(x) for x in (u, u, b, b))
    da = torch.zeros_like(a)
    dh0 = None
    for q, (t0, t1) in enumerate(bounds):
        g = g_in[q]
        for k0 in reversed(range(t0, t1, chunk)):
            hs = kept[k0] + (torch.exp(a * cum[k0][..., None]) * h_in[q] if q else 0)
            hist, h = [], hs
            for t in range(k0, min(k0 + chunk, t1)):
                h = step(h, t)[1]
                hist.append(h)
            for t in reversed(range(k0, min(k0 + chunk, t1))):
                j = t - k0
                hp = hist[j - 1] if j else hs
                d_a = torch.exp(dt[:, t, :, None] * a)
                g = g + c[:, t, None, :] * dy[:, t, :, None]
                dc[:, t] = torch.einsum("bi,bin->bn", dy[:, t], hist[j])
                db[:, t] = torch.einsum("bin,bi->bn", g, dt[:, t] * u[:, t])
                du[:, t] = dt[:, t] * torch.einsum("bin,bn->bi", g, b[:, t])
                ddt[:, t] = (g * (a * d_a * hp + b[:, t, None, :] * u[:, t, :, None])).sum(-1)
                da += (g * dt[:, t, :, None] * d_a * hp).sum(0)
                g = d_a * g
        if q == 0:
            dh0 = g
    return du, ddt, da, db, dc, dh0


def wkv_backward_sliced(r, k, v, w, u, state0, dy, dstate_out, cols, chunk):
    """K6′'s algorithm in PyTorch ops: the state's columns split into slices
    of ``cols``; each slice walks forward keeping its state every ``chunk``
    steps, then back chunk by chunk from the kept states, with its partial
    dr, dk, dw and du (the sums over its columns, dy . v over them
    included) and its columns' dv and dstate0; the partials are summed over
    the slices in order afterwards. Returns what
    ``ref.wkv6_backward_reference`` does."""
    acc = ref.acc_dtype(r.dtype)
    r, k, v, w, u, dy = (t.to(acc) for t in (r, k, v, w, u, dy))
    bsz, h, s, kd = r.shape
    dv = torch.zeros_like(v)
    parts, grads = [], []
    for c0 in range(0, kd, cols):
        sl = slice(c0, c0 + cols)
        st = (r.new_zeros((bsz, h, kd, cols)) if state0 is None
              else state0.to(acc)[..., sl])
        kept = {}
        for t in range(s):
            if t % chunk == 0:
                kept[t] = st
            st = w[:, :, t, :, None] * st + k[:, :, t, :, None] * v[:, :, t, None, sl]
        g = (r.new_zeros((bsz, h, kd, cols)) if dstate_out is None
             else dstate_out.to(acc)[..., sl])
        dr, dk, dw = (torch.zeros_like(r) for _ in range(3))
        du = torch.zeros_like(u)
        for k0 in reversed(range(0, s, chunk)):
            hist, st = [], kept[k0]
            for t in range(k0, min(k0 + chunk, s)):
                st = w[:, :, t, :, None] * st + k[:, :, t, :, None] * v[:, :, t, None, sl]
                hist.append(st)
            for t in reversed(range(k0, min(k0 + chunk, s))):
                j = t - k0
                prev = hist[j - 1] if j else kept[k0]
                rt, kt, wt = r[:, :, t], k[:, :, t], w[:, :, t]
                vt, dyt = v[:, :, t, sl], dy[:, :, t, sl]
                dyv = (dyt * vt).sum(-1, keepdim=True)
                dr[:, :, t] = torch.einsum("bhkv,bhv->bhk", prev, dyt) + u * kt * dyv
                dk[:, :, t] = rt * u * dyv + torch.einsum("bhkv,bhv->bhk", g, vt)
                dv[:, :, t, sl] = dyt * (rt * u * kt).sum(-1, keepdim=True) + \
                    torch.einsum("bhkv,bhk->bhv", g, kt)
                dw[:, :, t] = (g * prev).sum(-1)
                du += (rt * kt * dyv).sum(0)
                g = wt[..., None] * g + rt[..., None] * dyt[:, :, None, :]
        parts.append((dr, dk, dw, du))
        grads.append(g)
    dr, dk, dw, du = parts[0]
    for p in parts[1:]:
        dr, dk, dw, du = dr + p[0], dk + p[1], dw + p[2], du + p[3]
    return dr, dk, dv, dw, du, torch.cat(grads, dim=-1)


#: (segments, chunk) of the K5′ decomposition: 2 to 8 segments of chunks of
#: 4, 2 and 1 steps, so the CASES' lengths split
SEGMENTS = [(2, 4), (4, 2), (8, 1)]


@pytest.mark.parametrize("segments,chunk", SEGMENTS)
@pytest.mark.parametrize("s,state,dstate,edge", CASES)
def test_ssm_backward_segmented_matches_reference_f64(s, state, dstate, edge, segments, chunk):
    u, dt, a, b, c, h0, dy, dh = tensors(ssm_inputs(15, s, state, dstate, edge), torch.float64)
    want = ref.ssm_scan_backward_reference(u, dt, a, b, c, h0, dy, dh)
    got = ssm_backward_segmented(u, dt, a, b, c, h0, dy, dh, segments, chunk)
    for name, g, w in zip("u dt a b c h0".split(), got, want):
        torch.testing.assert_close(g, w, rtol=F64_TOL, atol=F64_TOL, msg=name)


@pytest.mark.parametrize("s,state,dstate,big_dt", CASES)
def test_ssm_backward_segmented_matches_jax_grad(jx, s, state, dstate, big_dt):
    arrays = ssm_inputs(16, s, state, dstate, big_dt)
    dy, dh = (None if x is None else jx.jnp.asarray(x) for x in arrays[6:])
    want = jax_grads(jx, jx.ref.ssm_scan_reference, list(arrays[:6]), dy, dh)
    got = ssm_backward_segmented(*tensors(arrays), segments=4, chunk=2)
    assert_normwise(got, want, "u dt a b c h0".split())


@pytest.mark.parametrize("di", [5, 6, 7])
@pytest.mark.parametrize("s,state,dstate,edge", CASES)
def test_ssm_backward_zero_channels_add_nothing(s, state, dstate, edge, di):
    """K5′'s wrapper pads an I that is no multiple of 4 with channels of
    zeros (u, dt, dy, a, h0, dh_out) and keeps the first I of du, ddt, da and
    dh0: the plain backward on the padded inputs, so cut, equals it on the
    inputs as given, and db, dc come out the same (the zero channels add
    exact zeros to their sums)."""
    u, dt, a, b, c, h0, dy, dh = tensors(ssm_inputs(19, s, state, dstate, edge, di=di))
    want = ref.ssm_scan_backward_reference(u, dt, a, b, c, h0, dy, dh)
    pad = -di % 4
    pu, pdt, pdy = (torch.nn.functional.pad(x, (0, pad)) for x in (u, dt, dy))
    pa, ph0, pdh = (None if x is None else torch.nn.functional.pad(x, (0, 0, 0, pad))
                    for x in (a, h0, dh))
    du, ddt, da, db, dc, dh0 = ref.ssm_scan_backward_reference(pu, pdt, pa, b, c, ph0, pdy, pdh)
    got = (du[..., :di], ddt[..., :di], da[:di], db, dc, dh0[:, :di])
    for name, g, w in zip("u dt a b c h0".split(), got, want):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6, msg=name)


@pytest.mark.parametrize("cols,chunk", [(2, 4), (4, 3), (8, 16)])
@pytest.mark.parametrize("s,state,dstate,extreme", CASES)
def test_wkv_backward_sliced_matches_reference_f64(s, state, dstate, extreme, cols, chunk):
    r, k, v, w, u, s0, dy, ds = tensors(wkv_inputs(17, s, state, dstate, extreme),
                                        torch.float64)
    want = ref.wkv6_backward_reference(r, k, v, w, u, s0, dy, ds)
    got = wkv_backward_sliced(r, k, v, w, u, s0, dy, ds, cols, chunk)
    for name, g, x in zip("r k v w u state0".split(), got, want):
        torch.testing.assert_close(g, x, rtol=F64_TOL, atol=F64_TOL, msg=name)


@pytest.mark.parametrize("s,state,dstate,extreme", CASES)
def test_wkv_backward_sliced_matches_jax_grad(jx, s, state, dstate, extreme):
    arrays = wkv_inputs(18, s, state, dstate, extreme)
    dy, ds = (None if x is None else jx.jnp.asarray(x) for x in arrays[6:])
    want = jax_grads(jx, jx.ref.wkv6_reference, list(arrays[:6]), dy, ds)
    got = wkv_backward_sliced(*tensors(arrays), cols=4, chunk=4)
    assert_normwise(got, want, "r k v w u state0".split())


# --------------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


#: the backward kernels' plan branches on the card: (S, N, I, group,
#: segments) for K5′ (every group at N = 16 and 8, a ragged last channel
#: tile at I = 100, S = 1, S not a multiple of the chunk, 1 to 8 segments,
#: and I = 98, which the wrapper pads to a multiple of 4), and K6′ at every
#: head size (H = 3) over the same S
BRANCHES = [(s, n, 100, grp, seg) for n in (16, 8) for grp in (4, 2, 1)
            for s, seg in ((1, 1), (37, 2), (301, 4))] + [(301, 16, 100, 4, 8),
                                                          (37, 8, 98, 2, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("s,state,dstate,edge,branch",
                         [c + (None,) for c in CASES + [(2048, False, False, False)]]
                         + [(b[0], True, True, False, b) for b in BRANCHES])
def test_backward_kernels_match_plain_on_card(cuda, s, state, dstate, edge, branch):
    """K5's and K6's backward kernels against their plain backwards on the
    card, per element within 1e-3 (1 + |plain|) (chip_smoke.py's tolerance),
    twice for the same bits: at hymba-1.5b's and rwkv6-3b's widths under the
    default plans, then each plan branch (BRANCHES: K5′ at the given I under
    the given group and segments, at S = 37 on inputs off the 16-byte grid,
    which the wrappers copy onto it; K6′ at every head size)."""
    before = tk.launch_counts()

    def held(kernel, plain, args, **kw):
        got, again = kernel(*args, **kw), kernel(*args, **kw)
        for g, a, w in zip(got, again, plain(*args)):
            assert torch.equal(g, a)
            torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)

    if branch is None:
        n, di, plan, offset = 16, 3200, {}, False
    else:
        _, n, di, grp, seg = branch
        plan = dict(plan=k5.backward_plan(2, s, di, n, group=grp, segments=seg))
        offset = s == 37
    args = [None if x is None else x.to(cuda) for x in tensors(
        ssm_inputs(13, s, state, dstate, edge, bsz=2, di=di, n=n))]
    if offset:
        args = [cs.offset_copy(x) for x in args]
    held(k5.ssm_scan_backward, k5.ssm_scan_backward_plain, args, **plan)
    s6 = min(s, 128)
    for h, kd in ((40, 64),) if branch is None else ((3, 16), (3, 32), (3, 64)):
        args = [None if x is None else x.to(cuda) for x in tensors(
            wkv_inputs(14, s6, state, dstate, edge, bsz=2, h=h, kd=kd))]
        if offset:
            args = [cs.offset_copy(x) for x in args]
        held(k6.wkv6_backward, k6.wkv6_backward_plain, args)
    after = tk.launch_counts()
    assert after["ssm_scan_bwd"] - before["ssm_scan_bwd"] == 2
    assert after["wkv6_bwd"] - before["wkv6_bwd"] == (2 if branch is None else 6)
