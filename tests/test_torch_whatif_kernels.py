"""The what-if replay's kernels, K4 (cap-bucket scan) and K7 (cooldown
chain), against the JAX package's.

On the CPU the wrappers run their plain versions. K4's plain version is held
to the Pallas kernel in interpret mode on float32-exact inputs (JAX runs
float32 here) and to NumPy ``searchsorted`` in float64, exactly. K7's plain
version is held to the NumPy oracle's per-stream decision replay: counts
exact, savings within 1e-9 relative. The ``gpu`` test holds both CUDA
kernels to their plain versions on the card and skips where there is none.
"""
import tempfile
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.cluster import generate_cluster
from repro_torch.core.controller import ControllerConfig, DownscaleMode
from repro_torch.kernels import ops
from repro_torch.kernels.downscale_replay import (downscale_replay,
                                                  downscale_replay_plain)
from repro_torch.kernels.run_replay import cap_bucket_scan, cap_bucket_scan_plain
from repro_torch.telemetry import TelemetryStore
from repro_torch.whatif import DownscalePolicy, get_ir, ir_config_for
from repro_torch.whatif import backend as B
from repro_torch.whatif.policies import DownscaleBatch, _run_downscale

RTOL = ATOL = 1e-9        # float savings: the sum order differs from NumPy's


@pytest.fixture(scope="module")
def jk():
    """The JAX package's K4 (Pallas, interpret mode off the TPU). Imported
    here, not at the top: the machine with the card has no JAX."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import run_replay as rr
    return types.SimpleNamespace(jnp=jnp, rr=rr, interpret=rr.default_interpret())


@pytest.fixture(scope="module")
def packed():
    """The what-if fixture fleet of tests/test_whatif_backend.py, packed."""
    with tempfile.TemporaryDirectory() as d:
        store = TelemetryStore(d, shard_format="npy_dir")
        generate_cluster(n_devices=6, horizon_s=1500, seed=7, store=store, shard_s=500)
        ir = get_ir(TelemetryStore(d), ir_config_for([DownscalePolicy()]))
        yield B.pack_ir(ir, 5, min_job_duration_s=0.0)


def np_cap_counts(sp, caps):
    return np.stack([sp.shape[1] - np.searchsorted(sp[r], caps[r], side="right")
                     for r in range(sp.shape[0])]).astype(np.int32)


def cap_inputs(seed, rows, n, c, pad):
    """float32-exact rows (sorted, ``pad`` leading -inf) and caps, with ties."""
    rng = np.random.default_rng(seed)
    sp = np.sort(rng.integers(-40, 40, (rows, n)).astype(np.float32) * 2.5, axis=1)
    sp[:, :pad] = -np.inf
    caps = rng.integers(-45, 45, (rows, c)).astype(np.float32) * 2.5
    return sp, caps


# --------------------------------------------------------------------------- #
# K4
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("rows,n,c,pad", [(3, 17, 5, 0), (1, 1, 7, 0), (4, 256, 33, 40),
                                          (2, 64, 1, 63), (5, 100, 9, 3)])
def test_cap_scan_plain_matches_pallas_and_numpy(jk, rows, n, c, pad):
    """Exact int32 counts: Np = 1, non-power-of-two Np, ties, -inf pads."""
    sp, caps = cap_inputs(rows * n + c, rows, n, c, pad)
    expect = np_cap_counts(sp.astype(np.float64), caps.astype(np.float64))
    out = cap_bucket_scan(torch.from_numpy(sp).double(), torch.from_numpy(caps).double())
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), expect)
    pallas = jk.rr.cap_bucket_scan(jk.jnp.asarray(sp), jk.jnp.asarray(caps),
                                   interpret=jk.interpret)
    np.testing.assert_array_equal(np.asarray(pallas), out.numpy())


def test_cap_scan_ties_and_padding():
    """Ties follow side="right" (p > cap strictly) and -inf front padding
    never changes a count (tests/test_kernels.py's pinned case)."""
    sp = torch.tensor([[1.0, 2.0, 2.0, 2.0, 3.0, 3.0]], dtype=torch.float64)
    caps = torch.tensor([[0.5, 2.0, 3.0, 4.0, 1.0]], dtype=torch.float64)
    expect = torch.tensor([[6, 2, 0, 0, 5]], dtype=torch.int32)
    padded = torch.cat([torch.full((1, 5), float("-inf"), dtype=torch.float64), sp], 1)
    for rows in (sp, padded):
        assert torch.equal(cap_bucket_scan(rows, caps), expect)
        assert torch.equal(ops.cap_bucket_scan(rows, caps), expect)
        assert torch.equal(ops.cap_bucket_scan(rows, caps, plain=True), expect)


def test_cap_scan_float64_and_strided_caps(packed):
    """The power-cap family's call: [S, 4, Np] float64 rows of the packed
    fleet against [S, C] caps expanded over the 4 buckets (stride 0)."""
    b = packed.buckets[-1]
    sp = torch.from_numpy(b.arrays["cap_sorted"])
    s_dim, n_b, _ = sp.shape
    rng = np.random.default_rng(3)
    caps = torch.from_numpy(rng.uniform(0.0, 800.0, (s_dim, 37)))
    view = caps[:, None, :].expand(s_dim, n_b, 37)
    assert view.stride(1) == 0
    out = cap_bucket_scan(sp, view)
    assert out.shape == (s_dim, n_b, 37) and out.is_contiguous()
    for j in range(n_b):
        np.testing.assert_array_equal(
            out[:, j].numpy(), np_cap_counts(sp[:, j].numpy(), caps.numpy()))
    assert torch.equal(out, cap_bucket_scan_plain(sp, view.contiguous()))


def test_cap_scan_rejects_bad_inputs():
    sp = torch.zeros(2, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="float64"):
        cap_bucket_scan(sp.float(), torch.zeros(2, 3))
    with pytest.raises(ValueError, match="leading axes"):
        cap_bucket_scan(sp, torch.zeros(3, 3, dtype=torch.float64))


# --------------------------------------------------------------------------- #
# K7
# --------------------------------------------------------------------------- #
def dense_batch():
    """Triggers 0..15 s x cooldowns 0.5..20 s at both clock modes."""
    return DownscaleBatch(tuple(
        DownscalePolicy(config=ControllerConfig(threshold_x_s=x, cooldown_y_s=y, mode=m))
        for x in (0.5, 2.0, 5.0, 15.0) for y in (0.5, 1.0, 3.0, 7.5, 20.0)
        for m in (DownscaleMode.SM_ONLY, DownscaleMode.SM_AND_MEM)))


def test_downscale_plain_matches_numpy_oracle(packed):
    """Per stream, K7's plain version (through the backend's family
    evaluator) equals the NumPy run-level replay: counts exact, savings
    within 1e-9 relative."""
    batch = dense_batch()
    nd, nr, th, se, sa = B._run_downscale_family(packed, batch, torch.device("cpu"), 1.0)
    fired = 0
    for i, (s, plat) in enumerate(zip(packed.streams, packed.platforms)):
        o_nd, o_nr, o_th, o_se, o_sa = _run_downscale(
            s, plat, packed.min_samples, 1.0, batch._eps, batch._x, batch._y,
            batch._trig, batch._delta(plat))
        np.testing.assert_array_equal(nd[i], o_nd)
        np.testing.assert_array_equal(nr[i], o_nr)
        np.testing.assert_array_equal(th[i], o_th)
        np.testing.assert_allclose(se[i], o_se, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(sa[i], o_sa, rtol=RTOL, atol=ATOL)
        fired += int(o_nd.sum())
    assert fired > 0


def k7_args(bucket, trig, y):
    a = {k: torch.from_numpy(v) for k, v in bucket.arrays.items()}
    return (a["lr_s0"], a["lr_len"], a["lr_busy"], a["lr_valid"], a["lr_trail"],
            a["cum_res"], a["ds_cum"], a["ts_first"], 1.0,
            torch.as_tensor(trig, dtype=torch.int64), torch.as_tensor(y, dtype=torch.float64))


def test_downscale_never_trigger_and_padding(packed):
    """A pair that can never trigger (1 << 62) fires nowhere, and padded
    low runs (valid = False) never fire."""
    b = packed.buckets[0]
    out = downscale_replay_plain(*k7_args(b, [1 << 62, 0], [1.0, 1.0]))
    assert all(int(t[:, 0].abs().sum()) == 0 for t in out)
    n_real = torch.from_numpy(b.arrays["lr_valid"]).sum(1)
    assert bool((out[0][:, 1] <= n_real).all())


def test_downscale_rejects_bad_inputs(packed):
    args = list(k7_args(packed.buckets[0], [1], [1.0]))
    args[9] = args[9].to(torch.int32)          # trig must be int64
    with pytest.raises(ValueError, match="trig"):
        downscale_replay(*args)
    args = list(k7_args(packed.buckets[0], [1], [1.0, 2.0]))
    with pytest.raises(ValueError, match="y"):
        downscale_replay(*args)


def test_cpu_tensors_never_launch(packed):
    tk.reset_launch_counts()
    b = packed.buckets[0]
    downscale_replay(*k7_args(b, [1, 2], [1.0, 5.0]))
    cap_bucket_scan(torch.from_numpy(b.arrays["cap_sorted"]),
                    torch.ones(b.idx.size, 4, 3, dtype=torch.float64))
    assert tk.launch_counts()["cap_bucket_scan"] == 0
    assert tk.launch_counts()["downscale_replay"] == 0


# --------------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_replay_kernels_match_plain_on_card(cuda, packed):
    """K4 equals its plain version exactly (ties, -inf pads, Np = 1 and a
    non-power-of-two Np); K7's counts are exact and its savings within 1e-9
    relative, on every bucket of the fixture fleet."""
    before = tk.launch_counts()
    for rows, n, c, pad in [(3, 17, 5, 0), (1, 1, 7, 0), (4, 1000, 33, 40), (6, 4096, 513, 9)]:
        sp, caps = cap_inputs(n, rows, n, c, pad)
        sp_t = torch.from_numpy(sp).double().to(cuda)
        caps_t = torch.from_numpy(caps).double().to(cuda)
        assert torch.equal(cap_bucket_scan(sp_t, caps_t), cap_bucket_scan_plain(sp_t, caps_t))
    b = packed.buckets[-1]
    sp = torch.from_numpy(b.arrays["cap_sorted"]).to(cuda)
    caps = torch.rand(sp.shape[0], 65, dtype=torch.float64, device=cuda) * 800
    view = caps[:, None, :].expand(sp.shape[0], 4, 65)
    assert torch.equal(cap_bucket_scan(sp, view), cap_bucket_scan_plain(sp, view))
    batch = dense_batch()
    trig = np.unique(batch._trig)
    pairs = [(t, y) for t in trig for y in np.unique(batch._y)] + [(1 << 62, 1.0)]
    for bucket in packed.buckets:
        args = [a.to(cuda) if isinstance(a, torch.Tensor) else a
                for a in k7_args(bucket, [p[0] for p in pairs], [p[1] for p in pairs])]
        got, want = downscale_replay(*args), downscale_replay_plain(*args)
        for i, (g, w) in enumerate(zip(got, want)):
            if i < 3:
                assert torch.equal(g, w), i
            else:
                torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    torch.cuda.synchronize()
    after = tk.launch_counts()
    assert after["cap_bucket_scan"] - before["cap_bucket_scan"] == 5
    assert after["downscale_replay"] - before["downscale_replay"] == len(packed.buckets)
