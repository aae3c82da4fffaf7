"""The what-if replay's kernels, K4 (cap-bucket scan) and K7 (cooldown
chain), against the JAX package's.

On the CPU the wrappers run their plain versions. K4's plain version is held
to the Pallas kernel in interpret mode on float32-exact inputs (JAX runs
float32 here) and to NumPy ``searchsorted`` in float64, exactly. K7's plain
version is held to the NumPy oracle's per-stream decision replay: counts
exact, savings within 1e-9 relative. The ``gpu`` test holds both CUDA
kernels to their plain versions on the card and skips where there is none.
"""
import dataclasses
import importlib.util
import pathlib
import tempfile
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.cluster import generate_cluster
from repro_torch.core.controller import ControllerConfig, DownscaleMode
from repro_torch.kernels import ops
from repro_torch.kernels.downscale_replay import (chain_rows, downscale_replay,
                                                  downscale_replay_plain)
from repro_torch.kernels.run_replay import cap_bucket_scan, cap_bucket_scan_plain
from repro_torch.telemetry import TelemetryStore
from repro_torch.whatif import DownscalePolicy, get_ir, ir_config_for
from repro_torch.whatif import backend as B
from repro_torch.whatif.policies import DownscaleBatch, _run_downscale

RTOL = ATOL = 1e-9        # float savings: the sum order differs from NumPy's

#: chip_smoke.py, for the synthetic buckets and the byte bound it shares
_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


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


def cap_inputs(seed, rows, n, c, pad, special=False):
    """float32-exact rows (sorted, ``pad`` leading -inf) and caps, with ties;
    ``special`` sets caps to NaN, +inf and -inf in turn from column 0."""
    rng = np.random.default_rng(seed)
    sp = np.sort(rng.integers(-40, 40, (rows, n)).astype(np.float32) * 2.5, axis=1)
    sp[:, :pad] = -np.inf
    caps = rng.integers(-45, 45, (rows, c)).astype(np.float32) * 2.5
    if special:
        caps[:, 0::4] = np.nan
        caps[:, 1::4] = np.inf
        caps[:, 2::4] = -np.inf
    return sp, caps


# --------------------------------------------------------------------------- #
# K4
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("rows,n,c,pad,special", [
    (3, 17, 5, 0, False), (1, 1, 7, 0, False), (4, 256, 33, 40, False), (2, 64, 1, 63, False),
    (5, 100, 9, 3, False),
    # NaN, +inf and -inf caps; a row all padding; a finite tail of 1
    (3, 17, 13, 0, True), (2, 64, 9, 64, True), (2, 33, 8, 32, True), (1, 1, 4, 0, True)])
def test_cap_scan_plain_matches_pallas_and_numpy(jk, rows, n, c, pad, special):
    """Exact int32 counts: Np = 1, non-power-of-two Np, ties, -inf pads, and
    NaN and infinite caps. NumPy holds the counts only where the cap is not
    NaN: the fixed-trip bisection never moves on a NaN and counts Np, where
    searchsorted counts 0."""
    sp, caps = cap_inputs(rows * n + c, rows, n, c, pad, special)
    expect = np_cap_counts(sp.astype(np.float64), caps.astype(np.float64))
    out = cap_bucket_scan(torch.from_numpy(sp).double(), torch.from_numpy(caps).double())
    assert out.dtype == torch.int32
    nan = np.isnan(caps)
    np.testing.assert_array_equal(out.numpy()[~nan], expect[~nan])
    assert (out.numpy()[nan] == n).all()
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


#: (n, c, rows) of the 10^4 run's seven buckets (64 devices x 3 h), a C = 1
#: call, the fixture's shapes, rows either side of the row branch's widest,
#: and more rows than a wave holds
PLAN_CASES = [
    ((8192, 7901, 168), ("row", 256, 8, 2, 0, 65552)),
    ((1024, 7901, 4), ("row", 128, 4, 16, 0, 8208)),
    ((4096, 7901, 12), ("row", 128, 4, 16, 0, 32784)),
    ((4096, 7901, 20), ("row", 128, 4, 16, 0, 32784)),
    ((4096, 7901, 52), ("row", 128, 8, 8, 0, 32784)),
    ((8192, 7901, 76), ("row", 256, 8, 4, 0, 65552)),
    ((16384, 7901, 52), ("row", 256, 8, 2, 0, 131088)),
    ((17, 1, 3), ("row", 32, 1, 1, 0, 144)),
    ((64, 37, 20), ("row", 64, 1, 1, 0, 528)),
    ((29055, 300, 4), ("row", 96, 4, 1, 0, 232448)),
    ((29056, 300, 4), ("tree", 96, 4, 1, 12, 32768)),
    ((40000, 513, 2), ("tree", 96, 4, 2, 12, 32768)),
    ((1 << 17, 7901, 168), ("tree", 256, 8, 4, 12, 32768)),
    ((1024, 7901, 4000), ("row", 256, 8, 1, 0, 8208)),
    ((1, 10, 1), ("row", 32, 1, 1, 0, 16)),
]


@pytest.mark.parametrize("shape,plan", PLAN_CASES)
def test_cap_scan_launch_plan(shape, plan):
    from repro_torch.kernels import run_replay as k4
    assert tuple(dataclasses.astuple(k4.launch_plan(*shape))) == plan


def plan_columns(plan, c):
    """The caps each thread of each tile searches, in the kernel's order
    (``csrc/cap_bucket_scan.cu``: tiles of ceil(C / tiles), rounds of
    threads x caps, slot g of thread t at ``r0 + g * threads + t``)."""
    per_tile = -(-c // plan.tiles)
    for tile in range(plan.tiles):
        c0, c1 = tile * per_tile, min(c, (tile + 1) * per_tile)
        for r0 in range(c0, c1, plan.threads * plan.caps):
            for g in range(plan.caps):
                for t in range(plan.threads):
                    if r0 + g * plan.threads + t < c1:
                        yield r0 + g * plan.threads + t


def test_cap_scan_launch_plan_covers_every_cap():
    """Every plan, the default and each alternative it weighs, is one the
    kernel takes (threads a multiple of 32 up to 256, caps a template
    choice), within 227 KB of shared memory on the 16-byte grid, and covers
    every (row, cap) once; the branch switches where the row stops
    fitting; the default takes the most tiles that keep one wave."""
    from repro_torch.kernels import run_replay as k4
    wide = min(n for n in range(28_000, 30_000) if k4.row_smem_bytes(n) > k4.SMEM_MAX)
    assert k4.row_smem_bytes(wide - 1) <= k4.SMEM_MAX == 232_448 and wide == 29_056
    for n in (1, 2, 17, 1024, 8192, 16384, wide - 1, wide, 40_000, 1 << 17):
        for c in (1, 5, 31, 32, 33, 255, 1000, 7901):
            for rows in (1, 4, 168):
                for tiles in (None, *k4.TILES):
                    for caps in (None, *k4.CAPS):
                        p = k4.launch_plan(n, c, rows, tiles, caps=caps)
                        assert p.branch == ("row" if n < wide else "tree")
                        assert p.threads % 32 == 0 and 32 <= p.threads <= k4.THREADS
                        assert p.caps in k4.CAPS and p.tiles in k4.TILES
                        assert p.smem_bytes <= k4.SMEM_MAX and p.smem_bytes % 16 == 0
                        if p.branch == "row":
                            assert p.smem_bytes >= 8 * (n + 1) and p.levels == 0
                        else:
                            assert p.smem_bytes == max(16, 8 << p.levels)
                            assert p.levels == min(k4.TREE_LEVELS, (n - 1).bit_length())
                        if caps is None:
                            tile = -(-c // p.tiles)
                            assert p.caps == next((g for g in k4.CAPS if tile >= 64 * g), 1)
                        if tiles is None:   # the most tiles in one wave
                            wave = k4.SMS * k4.blocks_per_sm(p.threads, p.smem_bytes)
                            assert p.tiles == 1 or (rows * p.tiles <= wave
                                                    and p.tiles * k4.MIN_TILE_CAPS <= c)
                            if p.tiles < k4.TILES[-1]:
                                q = k4.launch_plan(n, c, rows, 2 * p.tiles, caps=caps)
                                assert (rows * q.tiles > k4.SMS * k4.blocks_per_sm(
                                    q.threads, q.smem_bytes) or q.tiles * k4.MIN_TILE_CAPS > c)
                        if rows == 4 and n == 17:
                            assert sorted(plan_columns(p, c)) == list(range(c))
    with pytest.raises(ValueError, match="branch"):
        k4.launch_plan(wide, 10, 1, branch="row")
    with pytest.raises(ValueError, match="tiles"):
        k4.launch_plan(100, 10, 1, tiles=3)
    with pytest.raises(ValueError, match="caps"):
        k4.launch_plan(100, 10, 1, caps=2)
    assert k4.launch_plan(100, 10, 1, branch="tree").levels == 7
    assert k4.launch_plan(1, 10, 1, branch="tree").smem_bytes == 16


def upper_bound(at, pos, length, cap):
    """The kernel's branchless halving: pos + #{t[pos, pos + length) <= cap}."""
    while length > 1:
        half = length >> 1
        pos += half if at(pos + half) <= cap else 0
        length -= half
    return pos + int(at(pos) <= cap)


def emulate_cap_scan(sp, caps, plan, misaligned=False):
    """The kernel's algorithm in NumPy, step for step: for the row branch
    the padding's end within a step (one probe a thread), the staged row's
    layout in shared memory from the 16-byte boundary at or below that
    (rows ``8 * n`` bytes apart from a base 8 bytes off the 16-byte grid if
    ``misaligned``) and the search over the staged part; for the tree branch
    the probe tree's top ``levels`` levels, then the search over the row in
    global memory; each cap by the slot the plan gives it. Asserts that no
    probe reads a slot the block did not fill."""
    rows, n = sp.shape
    out = np.full(caps.shape, -1, np.int64)
    for r in range(rows):
        row = sp[r]
        smem = np.full(plan.smem_bytes // 8, np.nan)
        filled = np.zeros(plan.smem_bytes // 8, bool)

        def read(i):
            assert filled[i]
            return smem[i]

        if plan.branch == "row":
            step = -(-n // plan.threads)
            coarse = sum(t * step < n and row[t * step] == -np.inf
                         for t in range(plan.threads))
            s0 = (coarse - 1) * step + 1 if coarse else 0
            assert (row[:s0] == -np.inf).all()
            mis = 1 if (8 * (int(misaligned) + r * n + s0)) % 16 else 0
            base = s0 - mis
            q0 = s0 + mis
            chunks = (n - q0) // 2 if q0 < n else 0
            for k in range(chunks):
                d = q0 - base + 2 * k
                assert d % 2 == 0                           # 16-byte aligned in shared memory
                smem[d:d + 2], filled[d:d + 2] = row[q0 + 2 * k:q0 + 2 * k + 2], True
            if mis and s0 < n:
                smem[s0 - base], filled[s0 - base] = row[s0], True
            if q0 + 2 * chunks < n:
                smem[q0 + 2 * chunks - base], filled[q0 + 2 * chunks - base] = row[n - 1], True

            def count(cap):
                if np.isnan(cap):
                    return 0
                return s0 + (upper_bound(lambda i: read(s0 - base + i), 0, n - s0, cap)
                             if s0 < n else 0)
        else:
            for j in range(1, 1 << plan.levels):
                pos, length = 0, n
                for b in range(j.bit_length() - 2, -1, -1):
                    half = length >> 1
                    pos += half if (j >> b) & 1 else 0
                    length -= half
                smem[j], filled[j] = row[pos + (length >> 1)], True

            def count(cap):
                pos, length, node = 0, n, 1
                for _ in range(plan.levels):
                    half = length >> 1
                    right = read(node) <= cap
                    pos += half if right else 0
                    node = 2 * node + int(right)
                    length -= half
                return upper_bound(lambda i: row[i], pos, length, cap)
        for col in plan_columns(plan, caps.shape[1]):
            assert out[r, col] == -1
            out[r, col] = n - count(caps[r, col])
    return out


@pytest.mark.parametrize("n,pad,branch", [
    (17, 0, "row"), (17, 5, "row"), (18, 3, "row"), (64, 64, "row"), (33, 32, "row"),
    (1, 0, "row"), (1, 1, "row"), (300, 211, "row"), (300, 211, "tree"), (17, 4, "tree"),
    (2, 1, "tree"), (1, 0, "tree"), (1000, 999, "row")])
@pytest.mark.parametrize("misaligned", [False, True])
def test_cap_scan_kernel_algorithm_matches_plain(n, pad, branch, misaligned):
    """The kernel's algorithm (:func:`emulate_cap_scan`) gives the plain
    version's counts exactly, NaN and infinite caps included, on rows sorted
    as ``torch.sort`` sorts them (+inf and NaN at the end of one row): odd
    and even padding (a staged part off the 16-byte grid), rows all padding,
    a finite tail of 1, the padding's end far from a thread's probe, both
    branches, the tree with some probes left to global memory; caps in no
    order, every tile count and caps a thread."""
    from repro_torch.kernels import run_replay as k4
    rng = np.random.default_rng(n * 100 + pad)
    rows, c = 3, 70
    sp = np.sort(rng.integers(-20, 20, (rows, n)).astype(np.float64), axis=1)
    sp[1, n - n // 3:] = np.inf
    sp[1, n - n // 5:] = np.nan
    sp[:, :pad] = -np.inf
    caps = rng.integers(-25, 25, (rows, c)).astype(np.float64)
    caps[:, 3:6] = [np.nan, np.inf, -np.inf]
    want = cap_bucket_scan_plain(torch.from_numpy(sp), torch.from_numpy(caps)).numpy()
    for tiles in (1, 2):
        for caps_a_thread in (1, 4):
            plan = dataclasses.replace(k4.launch_plan(n, c, rows, tiles, branch, caps_a_thread),
                                       threads=32)
            if branch == "tree" and n > 4:
                levels = (n - 1).bit_length() - 2
                plan = dataclasses.replace(plan, levels=levels, smem_bytes=max(16, 8 << levels))
            np.testing.assert_array_equal(emulate_cap_scan(sp, caps, plan, misaligned), want)
    np.testing.assert_array_equal(want[:, 3], n)


def test_cap_buckets_without_plans_calls_only_the_two_argument_wrapper(packed, monkeypatch):
    """``chip_smoke.cap_buckets(..., alternatives=False)``, which
    ``cap_scan_buckets.py`` runs on earlier commits' kernels, calls K4 only
    as ``cap_bucket_scan(sorted_p, caps)`` (the form those commits share),
    and checks and reports every bucket (timers stubbed: no card here)."""
    from repro_torch.kernels import run_replay as k4
    calls = []

    def two_argument(sorted_p, caps):
        calls.append(caps.shape)
        return cap_bucket_scan_plain(sorted_p, caps)

    monkeypatch.setattr(k4, "cap_bucket_scan", two_argument)
    monkeypatch.setattr(chip_smoke, "graph_ms", lambda fn, iters=100, replays=5: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "after_read_ms", lambda fn, flush, pattern: (fn(), 2.0)[1])
    monkeypatch.setattr(chip_smoke, "FLUSH_BYTES", 1024)
    monkeypatch.setattr(chip_smoke, "log", lambda msg: None)
    fracs = np.linspace(0.2, 0.99, 40)
    rows = chip_smoke.cap_buckets(torch.device("cpu"), packed, fracs, alternatives=False)
    assert len(rows) == len(packed.buckets) and calls
    assert all(r["ms"] == 1.0 and r["cold_ms"] == 2.0 and "plan" not in r for r in rows)
    assert all(r["real"][0] <= r["stored"][0] for r in rows)


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


#: the bucket arrays K7 reads, in the order of its arguments
K7_ARRAYS = ("lr_s0", "lr_len", "lr_busy", "lr_valid", "lr_trail", "cum_res", "ds_cum",
             "ts_first")


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


def synthetic_bucket(seed, s_dim, k_dim, n_max=None, dt=0.25):
    """``chip_smoke.synthetic_bucket`` as a bucket: runs of 1-20 rows with
    gaps of 1-10 in up to ``k_dim`` slots a stream, random prefix tables."""
    return types.SimpleNamespace(
        arrays=chip_smoke.synthetic_bucket(seed, s_dim, k_dim, n_max, dt), dt=dt)


def walk_chains(arrays, dt, trig, y):
    """Per (stream, pair), the chain walked run by run in Python: the fired
    runs and each one's trigger row, ``s0 + max(trig, searchsorted(ts[s0:e0],
    last_busy + y, "left"))`` on the timestamps ``fl(ts_first + fl(dt * i))``."""
    fired = {}
    s_dim, k_dim = arrays["lr_s0"].shape
    for s in range(s_dim):
        tsf = arrays["ts_first"][s]
        for c, (tr, yc) in enumerate(zip(trig, y)):
            last, fires = -np.inf, []
            for k in range(k_dim):
                s0, ln = int(arrays["lr_s0"][s, k]), int(arrays["lr_len"][s, k])
                t_cd = last + yc
                if arrays["lr_valid"][s, k] and ln > tr and tsf + dt * (s0 + ln - 1) >= t_cd:
                    ts = tsf + dt * np.arange(s0, s0 + ln, dtype=np.float64)
                    fires.append((k, s0 + max(tr, int(np.searchsorted(ts, t_cd, "left")))))
                    last = arrays["lr_busy"][s, k]
            fired[s, c] = fires
    return fired


#: (trigger, cooldown) pairs: every eligible run fires at (0, 0.0); no run
#: passes a trigger of 1 << 62; 25 pairs, not a multiple of any tile
EDGE_PAIRS = [(t, y) for t in (0, 1, 3, 8, 1 << 62) for y in (0.0, 0.5, 2.0, 7.5, 30.0)]


def test_downscale_plain_fires_every_eligible_run():
    """On the synthetic bucket the plain version fires every valid run at
    trigger 0 and cooldown 0 and none at trigger 1 << 62, and its inputs
    hold the layout the kernel reads (runs inside the prefix tables)."""
    b = synthetic_bucket(1, 3, 40)
    a = {k: torch.from_numpy(v) for k, v in b.arrays.items()}
    assert bool(((a["lr_s0"] + a["lr_len"]) < a["cum_res"].shape[1]).all())
    args = list(k7_args(b, [p[0] for p in EDGE_PAIRS], [p[1] for p in EDGE_PAIRS]))
    args[8] = b.dt
    out = downscale_replay_plain(*args)
    assert torch.equal(out[0][:, 0], a["lr_valid"].sum(1))
    never = [i for i, (t, _) in enumerate(EDGE_PAIRS) if t == 1 << 62]
    assert all(int(t[:, never].abs().sum()) == 0 for t in out)


@pytest.fixture(params=["synthetic", "fixture"])
def chain_case(request, packed):
    """A bucket, its seconds per row and EDGE_PAIRS as (trig, y) lists."""
    if request.param == "synthetic":
        b = synthetic_bucket(6, 3, 40)
        return b.arrays, b.dt, [p[0] for p in EDGE_PAIRS], [p[1] for p in EDGE_PAIRS]
    return (packed.buckets[0].arrays, 1.0, [p[0] for p in EDGE_PAIRS],
            [p[1] for p in EDGE_PAIRS])


def test_chain_rows_match_a_walk_in_python(chain_case):
    """The plain version's decisions and trigger rows (``chain_rows``) equal
    a run-by-run walk with an exact ``searchsorted``: the 4-probe window
    finds the same row."""
    arrays, dt, trig, y = chain_case
    a = {k: torch.from_numpy(v) for k, v in arrays.items()}
    fire, gpos = chain_rows(a["lr_s0"], a["lr_len"], a["lr_busy"], a["lr_valid"],
                            a["ts_first"], dt, torch.tensor(trig),
                            torch.tensor(y, dtype=torch.float64))
    want = walk_chains(arrays, dt, trig, y)
    assert sum(len(f) for f in want.values()) > 0
    for (s, c), fires in want.items():
        assert fire[:, s, c].nonzero().flatten().tolist() == [k for k, _ in fires]
        assert [int(gpos[k, s, c]) for k, _ in fires] == [g for _, g in fires]


def test_chain_bound_counts_the_sectors_fires_need(chain_case):
    """``chip_smoke.chain_bound`` counts the run tables, ts_first, the pairs
    and the seven results once each, and of the prefix tables the 32-byte
    sectors that hold a fired run's end or trigger row (in cum_res and each
    of ds_cum's planes): the rows of the walk in Python, counted apart."""
    arrays, dt, trig, y = chain_case
    t = [torch.from_numpy(arrays[name]) for name in K7_ARRAYS]
    args = (*t, dt, torch.tensor(trig), torch.tensor(y, dtype=torch.float64))
    (ms, by), n_bytes = chip_smoke.chain_bound(args)
    s_dim, n1 = arrays["cum_res"].shape
    rows = {(s, int(arrays["lr_s0"][s, k] + arrays["lr_len"][s, k]))
            for (s, _), fires in walk_chains(arrays, dt, trig, y).items() for k, _ in fires}
    rows |= {(s, g) for (s, _), fires in walk_chains(arrays, dt, trig, y).items()
             for _, g in fires}
    res_ptr, ds_ptr = t[5].data_ptr(), t[6].data_ptr()
    sectors = {(res_ptr + (s * n1 + r) * 8) // 32 for s, r in rows}
    sectors |= {(ds_ptr + ((s * 4 + p) * n1 + r) * 8) // 32 for s, r in rows for p in range(4)}
    small = sum(arrays[k].nbytes for k in K7_ARRAYS if k not in ("cum_res", "ds_cum"))
    small += len(trig) * 16 + 7 * s_dim * len(trig) * 8
    assert n_bytes == small + 32 * len(sectors)
    assert n_bytes < small + arrays["cum_res"].nbytes + arrays["ds_cum"].nbytes
    assert by in ("bytes", "operations") and ms > 0


#: the padded run counts of chip_smoke.py's 64-device x 3 h fleet, of the
#: fixture fleet, and one past a chunk
PLAN_KS = (8, 16, 32, 64, 128, 256, 512, 1300)


@pytest.mark.parametrize("k_dim", PLAN_KS)
@pytest.mark.parametrize("c_dim", [1, 25, 544])
def test_replay_plan(k_dim, c_dim):
    """The chunk is a multiple of 32 runs, the whole table where it fits
    (at most CHUNK_RUNS, so K past it takes several passes), within the
    48 KB of static shared memory; the tiles cover every pair; the lanes
    follow K."""
    from repro_torch.kernels import downscale_replay as k7
    for lanes in (None, *k7.LANES):
        p = k7.replay_plan(k_dim, c_dim, lanes)
        assert p.lanes == (k7.lanes_for(k_dim) if lanes is None else lanes)
        assert p.chunk % 32 == 0 and p.chunk == min(k7.CHUNK_RUNS, -(-k_dim // 32) * 32)
        assert p.smem_bytes <= 48 * 1024 and p.pairs_per_block == k7.WARPS * 32 // p.lanes
        assert p.tiles * p.pairs_per_block >= c_dim > (p.tiles - 1) * p.pairs_per_block
    assert [k7.lanes_for(k) for k in PLAN_KS] == [8, 32, 32, 32, 32, 32, 32, 32]
    for lanes in (4, 16):
        with pytest.raises(ValueError, match="lanes"):
            k7.replay_plan(k_dim, c_dim, lanes)


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
    """K4 equals its plain version exactly (ties, -inf pads, Np = 1, a
    non-power-of-two Np, NaN and infinite caps, a row wider than the row
    branch takes); K7's counts are exact and its savings within 1e-9
    relative, on every bucket of the fixture fleet."""
    from repro_torch.kernels import run_replay as k4
    before = tk.launch_counts()
    cases = [(3, 17, 5, 0, False), (1, 1, 7, 0, False), (4, 1000, 33, 40, False),
             (6, 4096, 513, 9, False), (3, 17, 13, 0, True), (2, 40000, 129, 777, True)]
    for rows, n, c, pad, special in cases:
        sp, caps = cap_inputs(n, rows, n, c, pad, special)
        sp_t = torch.from_numpy(sp).double().to(cuda)
        caps_t = torch.from_numpy(caps).double().to(cuda)
        assert torch.equal(cap_bucket_scan(sp_t, caps_t), cap_bucket_scan_plain(sp_t, caps_t))
    assert k4.launch_plan(40000, 129, 2).branch == "tree"
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
    assert after["cap_bucket_scan"] - before["cap_bucket_scan"] == len(cases) + 1
    assert after["downscale_replay"] - before["downscale_replay"] == len(packed.buckets)


@pytest.mark.gpu
def test_downscale_chain_edges_on_card(cuda, packed):
    """K7 at every lanes-per-pair choice on the fixture's bucket and on
    synthetic buckets: K past one staged chunk (1,300 runs), S = 1, a pair
    that fires on every eligible run (trigger 0, cooldown 0) and one that
    never fires (1 << 62), C = 25 (not a multiple of any tile); counts
    exact, savings within 1e-9 relative, and two calls the same bits."""
    from repro_torch.kernels import downscale_replay as k7
    trig = [p[0] for p in EDGE_PAIRS]
    y = [p[1] for p in EDGE_PAIRS]
    cases = [(packed.buckets[0], 1.0), *[(b, b.dt) for b in (
        synthetic_bucket(2, 3, 1300), synthetic_bucket(3, 1, 40),
        synthetic_bucket(4, 5, 512), synthetic_bucket(5, 2, 8))]]
    before = tk.launch_counts()["downscale_replay"]
    calls = 0
    for bucket, dt in cases:
        args = [a.to(cuda) if isinstance(a, torch.Tensor) else a
                for a in k7_args(bucket, trig, y)]
        args[8] = dt
        want = downscale_replay_plain(*args)
        assert torch.equal(want[0][:, 0], args[3].sum(1))       # (0, 0.0) fires on every run
        got = downscale_replay(*args)
        calls += 1
        for g, w in zip(got, downscale_replay(*args)):
            assert torch.equal(g, w)
        calls += 1
        names = [n for n, _, _ in k7._INPUTS]
        tensors = dict(zip(names, args[:8] + args[9:]))
        for lanes in k7.LANES:
            plan = k7.replay_plan(args[0].shape[1], len(trig), lanes)
            outs = [got, k7.launch(tensors, dt, plan)]
            calls += 1
            for out in outs:
                for i, (g, w) in enumerate(zip(out, want)):
                    if i < 3:
                        assert torch.equal(g, w), (lanes, i)
                    else:
                        torch.testing.assert_close(g, w, rtol=RTOL, atol=ATOL)
    torch.cuda.synchronize()
    assert tk.launch_counts()["downscale_replay"] - before == calls

