"""The port's kernels against the JAX package's.

On the CPU the port's wrappers run their plain versions; these are held to
the Pallas kernels (interpret mode, as tests/test_kernels.py runs them) and
to ``repro.kernels.ref`` on the same numpy inputs, at that file's
tolerances. The card's kernels are held to the plain versions by the
``gpu`` test, which skips where there is no card.
"""
import ctypes
import dataclasses
import re
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.kernels import _build, ops
from repro_torch.kernels.decode_attention import decode_attention, decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(scope="module")
def jk():
    """The JAX package's Pallas kernels and oracles. Imported here, not at the
    top: the machine with the card, where the ``gpu`` test runs, has no JAX."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref
    from repro.kernels import run_replay as rr
    from repro.kernels.decode_attention import decode_attention as pallas_decode
    from repro.kernels.flash_attention import flash_attention as pallas_flash
    from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
    return types.SimpleNamespace(
        jnp=jnp, ref=ref, interpret=rr.default_interpret(), flash=pallas_flash,
        decode=pallas_decode, rmsnorm=pallas_rmsnorm)


def tol(name):
    # the tolerances of tests/test_kernels.py
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" \
        else dict(rtol=2e-5, atol=2e-5)


def both(jk, arr, name):
    """The same values as a JAX array and a torch tensor (f32 -> bf16 rounds
    to nearest even in both)."""
    return (jk.jnp.asarray(arr, getattr(jk.jnp, name)),
            torch.from_numpy(arr).to(TORCH_DTYPES[name]))


def f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# --------------------------------------------------------------------------- #
# flash attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b,h,kv,s,d", [(2, 4, 2, 64, 64), (1, 8, 1, 64, 128)])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 32), (False, 0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(jk, b, h, kv, s, d, causal, window, dtype):
    jq, tq = both(jk, normal(0, b, h, s, d), dtype)
    jkk, tk_ = both(jk, normal(1, b, kv, s, d), dtype)
    jv, tv = both(jk, normal(2, b, kv, s, d), dtype)
    out = flash_attention(tq, tk_, tv, causal=causal, window=window)
    assert out.dtype == tq.dtype and out.shape == (b, h, s, d)
    pallas = jk.flash(jq, jkk, jv, causal=causal, window=window,
                      block_q=32, block_k=32, interpret=jk.interpret)
    expect = jk.ref.mha_reference(jq, jkk, jv, causal=causal, window=window)
    np.testing.assert_allclose(f32(out), f32(pallas), **tol(dtype))
    np.testing.assert_allclose(f32(out), f32(expect), **tol(dtype))


@pytest.mark.parametrize("sq,window", [(37, 0), (45, 16)])
def test_flash_attention_ragged_matches_reference(jk, sq, window):
    """Lengths that no tile divides (the Pallas kernel asserts divisibility;
    the port masks the ragged edge)."""
    jq, tq = both(jk, normal(3, 1, 6, sq, 64), "float32")
    jkk, tk_ = both(jk, normal(4, 1, 2, sq, 64), "float32")
    jv, tv = both(jk, normal(5, 1, 2, sq, 64), "float32")
    out = flash_attention(tq, tk_, tv, causal=True, window=window)
    expect = jk.ref.mha_reference(jq, jkk, jv, causal=True, window=window)
    np.testing.assert_allclose(f32(out), f32(expect), **tol("float32"))


def test_flash_attention_model_layout():
    """ops.flash_attention takes (B, S, H, d) and equals the head-major
    kernel on transposed inputs."""
    q, k, v = (torch.from_numpy(normal(i, 2, 40, 4, 32)) for i in (6, 7, 8))
    out = ops.flash_attention(q, k[:, :, :2], v[:, :, :2])
    head_major = flash_attention(q.transpose(1, 2), k[:, :, :2].transpose(1, 2),
                                 v[:, :, :2].transpose(1, 2))
    assert out.shape == (2, 40, 4, 32)
    torch.testing.assert_close(out, head_major.transpose(1, 2), rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# decode attention
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("b,h,kv,s,d,cl", [
    (2, 8, 2, 256, 64, 150), (1, 4, 4, 256, 128, 256), (2, 2, 1, 256, 64, 1),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_matches_pallas(jk, b, h, kv, s, d, cl, dtype):
    jq, tq = both(jk, normal(10, b, h, d), dtype)
    jkk, tk_ = both(jk, normal(11, b, kv, s, d), dtype)
    jv, tv = both(jk, normal(12, b, kv, s, d), dtype)
    out = decode_attention(tq, tk_, tv, cl)
    assert out.dtype == tq.dtype and out.shape == (b, h, d)
    pallas = jk.decode(jq, jkk, jv, cl, block_k=128, interpret=jk.interpret)
    expect = jk.ref.decode_attention_reference(jq, jkk, jv, cl)
    np.testing.assert_allclose(f32(out), f32(pallas), **tol(dtype))
    np.testing.assert_allclose(f32(out), f32(expect), **tol(dtype))


@pytest.mark.parametrize("s,cl", [(100, 57), (100, 100), (100, 101), (64, 500)])
def test_decode_attention_ragged_and_past_end(jk, s, cl):
    """Any cache length, and cache_len at or past S (the reference engine's
    shared length outgrows the cache): every slot then counts as valid."""
    jq, tq = both(jk, normal(13, 2, 6, 64), "float32")
    jkk, tk_ = both(jk, normal(14, 2, 3, s, 64), "float32")
    jv, tv = both(jk, normal(15, 2, 3, s, 64), "float32")
    out = decode_attention(tq, tk_, tv, torch.tensor(cl, dtype=torch.int32))
    expect = jk.ref.decode_attention_reference(jq, jkk, jv, cl)
    np.testing.assert_allclose(f32(out), f32(expect), **tol("float32"))


def test_decode_attention_model_layout_reads_cache_in_place():
    """ops.decode_attention takes q (B,1,H,d) and a (B,S,KV,d) cache slice of
    the model's (L,B,S,KV,d) cache."""
    cache = torch.from_numpy(normal(16, 3, 2, 50, 2, 32))
    q = torch.from_numpy(normal(17, 2, 1, 4, 32))
    out = ops.decode_attention(q, cache[1], cache[2], torch.tensor(20, dtype=torch.int32))
    expect = decode_attention(q[:, 0], cache[1].transpose(1, 2),
                              cache[2].transpose(1, 2), 20)
    assert out.shape == (2, 1, 4, 32)
    torch.testing.assert_close(out[:, 0], expect, rtol=0, atol=0)


# --------------------------------------------------------------------------- #
# rmsnorm
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape", [(4, 128), (3, 50, 128), (1, 7, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas(jk, shape, dtype):
    jx, tx = both(jk, normal(20, *shape), dtype)
    jw, tw = both(jk, normal(21, shape[-1]), dtype)
    out = rmsnorm(tx, tw)
    assert out.dtype == tx.dtype and out.shape == shape
    pallas = jk.rmsnorm(jx, jw, interpret=jk.interpret)
    np.testing.assert_allclose(f32(out), f32(pallas), **tol(dtype))
    np.testing.assert_allclose(f32(out), f32(jk.ref.rmsnorm_reference(jx, jw)),
                               **tol(dtype))


@pytest.mark.parametrize("rows,d,itemsize,aligned,plan", [
    # hymba-1.5b decode and prefill: a warp per row, 8 rows a block
    (4, 1600, 2, True, (8, 8, 128, True, 1)),
    (2048, 1600, 2, True, (8, 8, 256, True, 256)),
    # llama-13b decode and prefill: a block per row of 160 threads x 4 vectors
    (4, 5120, 2, True, (8, 4, 160, False, 4)),
    (32, 5120, 2, True, (8, 4, 160, False, 32)),
    (4, 5120, 4, True, (4, 8, 160, False, 4)),
    (4, 3200, 2, True, (8, 2, 224, False, 4)),
    (1, 8, 2, True, (8, 1, 32, True, 1)),
    # the scalar path: D not a multiple of the vector, or a row not aligned
    (3, 37, 2, True, (1, 2, 96, True, 1)),
    (9, 37, 4, True, (1, 2, 256, True, 2)),
    (4, 5120, 2, False, (1, 8, 512, False, 4)),
    # past 8 vectors a thread at 512 threads: the kernel reads the rest again
    (2, 65536, 2, True, (8, 8, 512, False, 2)),
])
def test_rmsnorm_launch_plan(rows, d, itemsize, aligned, plan):
    from repro_torch.kernels import rmsnorm as k1
    assert tuple(dataclasses.astuple(k1.launch_plan(rows, d, itemsize, aligned))) == plan


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("aligned", [True, False])
def test_rmsnorm_launch_plan_covers_every_row(itemsize, aligned):
    """Every plan is one the kernel takes (threads a multiple of 32 within
    its launch bounds, vpt a template choice), its grid covers the rows, and
    a warp's row fits in the warp's registers."""
    from repro_torch.kernels import rmsnorm as k1
    for d in (1, 7, 8, 37, 256, 257, 1600, 2048, 2049, 3200, 5120, 8192, 20000, 70000):
        for rows in (1, 3, 4, 8, 9, 32, 2048):
            p = k1.launch_plan(rows, d, itemsize, aligned)
            vec = 16 // itemsize
            assert p.width == (vec if aligned and d % vec == 0 else 1)
            assert p.vpt in k1.VPT_CHOICES and p.threads % 32 == 0 and p.threads >= 32
            nv = d // p.width
            if p.warp_rows:
                assert nv <= 32 * p.vpt and p.threads <= 256
                assert p.blocks * (p.threads // 32) >= rows > (p.blocks - 1) * (p.threads // 32)
            else:
                assert nv > k1.WARP_ROW_VECTORS and p.threads <= k1.BLOCK_THREADS_MAX
                assert p.blocks == rows


def test_cpu_tensors_never_launch():
    """On the CPU every wrapper takes the plain version and counts nothing."""
    tk.reset_launch_counts()
    x = torch.from_numpy(normal(22, 4, 1, 8, 32))
    rmsnorm(x, torch.ones(32))
    ops.flash_attention(x, x, x)
    cache = torch.from_numpy(normal(23, 4, 10, 2, 32))
    ops.decode_attention(x, cache, cache, 3)
    assert tk.launch_counts() == {"rmsnorm": 0, "flash_attention": 0,
                                  "decode_attention": 0, "cap_bucket_scan": 0,
                                  "downscale_replay": 0, "ssm_scan": 0, "wkv6": 0,
                                  "ssm_scan_bwd": 0, "wkv6_bwd": 0,
                                  "flash_attention_bwd_dq": 0,
                                  "flash_attention_bwd_dkv": 0}


# --------------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------------- #
@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernels_match_plain_on_card(cuda, dtype):
    """Each CUDA kernel against its plain version: GQA, MQA at d=256, a
    window, ragged lengths and cache_len in {1, mid, >= S}."""
    atol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    g = torch.Generator(device=cuda).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    before = tk.launch_counts()
    x, w = rnd(37, 5120), rnd(5120)
    torch.testing.assert_close(rmsnorm(x, w), rmsnorm_plain(x, w), rtol=atol, atol=atol)
    for (b, h, kv, s, d, window) in [(1, 40, 40, 32, 128, 0), (2, 8, 1, 77, 256, 0),
                                     (1, 6, 2, 130, 64, 48), (1, 4, 4, 33, 32, 0)]:
        q, k, v = rnd(b, h, s, d), rnd(b, kv, s, d), rnd(b, kv, s, d)
        torch.testing.assert_close(
            flash_attention(q, k, v, window=window),
            flash_attention_plain(q, k, v, window=window), rtol=atol, atol=atol)
    for (b, h, kv, s, d) in [(4, 40, 40, 256, 128), (2, 8, 1, 100, 256)]:
        q, kc, vc = rnd(b, h, d), rnd(b, kv, s, d), rnd(b, kv, s, d)
        for cl in (1, s // 2, s, s + 7):
            n = torch.tensor([cl], dtype=torch.int32, device=cuda)
            torch.testing.assert_close(decode_attention(q, kc, vc, n),
                                       decode_attention_plain(q, kc, vc, n),
                                       rtol=atol, atol=atol)
    torch.cuda.synchronize()
    after = tk.launch_counts()
    assert {k: after[k] - before[k] for k in after} == {
        "rmsnorm": 1, "flash_attention": 4, "decode_attention": 8,
        "cap_bucket_scan": 0, "downscale_replay": 0, "ssm_scan": 0, "wkv6": 0,
        "ssm_scan_bwd": 0, "wkv6_bwd": 0, "flash_attention_bwd_dq": 0,
        "flash_attention_bwd_dkv": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_launch_shapes_on_card(cuda, dtype):
    """K1 against its plain version at every launch shape its plan gives:
    a warp per row and a block per row, the scalar path (D = 37, and a row
    view that is not 16-byte aligned), a row past the registers (D = 40000);
    two calls give the same bits."""
    from repro_torch.kernels import rmsnorm as k1
    atol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    g = torch.Generator(device=cuda).manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(dtype)

    before, calls = tk.launch_counts()["rmsnorm"], 0
    for d in (8, 37, 1600, 3200, 5120, 40000):
        for rows in (1, 4, 32, 2048):
            if d * rows > 2**24:        # D = 40000 at up to 32 rows
                continue
            x, w = rnd(rows, 1, d), rnd(d)
            got = rmsnorm(x, w)
            torch.testing.assert_close(got, rmsnorm_plain(x, w), rtol=atol, atol=atol)
            assert torch.equal(got, rmsnorm(x, w)), (d, rows)
            calls += 2
    buf = rnd(4 * 1600 + 3)
    x, w = buf[3:].view(4, 1600), rnd(1600)
    assert x.data_ptr() % 16 and k1.launch_plan(4, 1600, x.element_size(), False).width == 1
    torch.testing.assert_close(rmsnorm(x, w), rmsnorm_plain(x, w), rtol=atol, atol=atol)
    torch.cuda.synchronize()
    assert tk.launch_counts()["rmsnorm"] - before == calls + 1



def _c_entry_points() -> dict[str, str]:
    """Each ``extern "C" int repro_*(...)`` of ``csrc/*.cu``: its parameter
    list, by name."""
    found = {}
    for src in _build.sources():
        for m in re.finditer(r'extern "C" int (repro_\w+)\(([^)]*)\)', src.read_text()):
            found[m.group(1)] = m.group(2)
    return found


_CTYPES = {"int": ctypes.c_int, "int64_t": ctypes.c_int64, "float": ctypes.c_float,
           "double": ctypes.c_double}


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_ctypes_signature_matches_c_entry_point(name):
    """Each binding's argument types match its C function's parameters, one
    for one: a pointer as c_void_p, an integer or float at its width. A
    missing entry would hand the arguments after it to the C function
    converted as the wrong type (a stream pointer cut to 32 bits)."""
    params = [p.strip() for p in _c_entry_points()[name].split(",")]
    want = [ctypes.c_void_p if "*" in p else _CTYPES[p.rsplit(" ", 1)[0]] for p in params]
    assert _build.SIGNATURES[name] == want
