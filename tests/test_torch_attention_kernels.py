"""Prefill (K2) and decode (K3) attention at the edges of their Hopper
designs: K2's choice of kernel by element type, K3's split of the cache over
blocks and the merge of the splits, hymba-1.5b's head layout (25 q / 5 kv
heads of 64) against the Pallas kernels, and, on the card, the kernels
against their plain versions at the tile and split boundaries.
"""
import math
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"bfloat16": dict(rtol=2e-2, atol=2e-2), "float32": dict(rtol=2e-5, atol=2e-5)}
#: (B, KV, S, d) caches of the serving path: llama-13b (MHA), hymba-1.5b's
#: global layers and its window ring
LLAMA, HYMBA_GLOBAL, HYMBA_RING = (4, 40, 256, 128), (4, 5, 2048, 64), (4, 5, 1024, 64)


@pytest.fixture(scope="module")
def jk():
    """The JAX package's Pallas kernels and oracles, imported here: the
    machine with the card has no JAX."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.kernels import ref as jref
    from repro.kernels import run_replay as rr
    from repro.kernels.decode_attention import decode_attention as pallas_decode
    from repro.kernels.flash_attention import flash_attention as pallas_flash
    return types.SimpleNamespace(jnp=jnp, ref=jref, interpret=rr.default_interpret(),
                                 flash=pallas_flash, decode=pallas_decode)


def normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def both(jk, arr, name):
    return (jk.jnp.asarray(arr, getattr(jk.jnp, name)),
            torch.from_numpy(arr).to(TORCH_DTYPES[name]))


def f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


# --------------------------------------------------------------------------- #
# K2: the kernel by element type
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype,kernel", [(torch.bfloat16, "wgmma"),
                                          (torch.float32, "cuda_cores")])
def test_prefill_route_by_dtype(dtype, kernel):
    assert fa.route(dtype) == kernel


def test_prefill_route_refuses_other_dtypes():
    with pytest.raises(ValueError, match="unsupported dtype"):
        fa.route(torch.float16)


def test_16b_rows_rule():
    """Rows must start 16-byte aligned, with every other stride whole 16
    bytes: the model's (B, S, H, d) views pass, an odd offset does not."""
    x = torch.zeros(2, 40, 25, 64, dtype=torch.bfloat16)
    fa.require_16b_rows(x, x.transpose(1, 2), x[:, :, 5:10])
    with pytest.raises(ValueError, match="16-byte rows"):
        fa.require_16b_rows(x.view(-1)[1:1 + 40 * 64].view(40, 64))
    with pytest.raises(ValueError, match="16-byte rows"):
        fa.require_16b_rows(torch.zeros(3, 36, dtype=torch.bfloat16)[:, :32])


# --------------------------------------------------------------------------- #
# K3: the split plan and the merge
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("shape,itemsize,chunk", [
    (LLAMA, 2, 64),                    # 640 blocks; C = 128 would hold 64 KB of K and V
    (HYMBA_GLOBAL, 2, 128),            # 320 blocks
    (HYMBA_RING, 2, 64),               # C = 128 gives 160 blocks, under two waves
    ((1, 40, 256, 128), 2, 32),        # one sequence: 64-slot chunks give 160 blocks
    ((2, 1, 100, 256), 2, 32),         # S not a multiple of C; no C gives two waves
    ((64, 40, 4096, 64), 2, 128),
    ((64, 40, 4096, 256), 4, 32),      # f32 at d 256: only the smallest chunk
])
def test_split_plan(shape, itemsize, chunk):
    b, kv, s, d = shape
    c, n_split = da.split_plan(b, kv, s, d, itemsize)
    assert c == chunk and c % 32 == 0
    assert (n_split - 1) * c < s <= n_split * c          # the splits tile the cache
    if -(-s // 32) * kv * b >= 2 * da.SMS:                # two waves wherever C can give them
        assert n_split * kv * b >= 2 * da.SMS
    if c > 32:
        assert 2 * c * d * itemsize <= da.MAX_CHUNK_BYTES


def split_merge(q, k, v, cache_len):
    """The kernel's algorithm in float64: per-split partials (m, l, acc) over
    the split plan's chunks of the valid slots, merged in split order."""
    b, h, d = q.shape
    _, kv, s, _ = k.shape
    c, n_split = da.split_plan(b, kv, s, d, q.element_size())
    n_valid = max(0, min(int(cache_len), s))
    qd = q.double().reshape(b, kv, h // kv, d)
    parts = []
    for i in range(n_split):
        lo, hi = i * c, min(i * c + c, n_valid)
        if lo >= hi:
            break
        sc = torch.einsum("bgrd,bgkd->bgrk", qd, k[:, :, lo:hi].double()) / math.sqrt(d)
        m = sc.amax(-1, keepdim=True)
        p = torch.exp(sc - m)
        parts.append((m, p.sum(-1, keepdim=True),
                      torch.einsum("bgrk,bgkd->bgrd", p, v[:, :, lo:hi].double())))
    if not parts:
        return torch.zeros_like(q, dtype=torch.float64)
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    l_all = sum(l * torch.exp(m - m_all) for m, l, _ in parts)
    acc = sum(a * torch.exp(m - m_all) for m, _, a in parts)
    return (acc / l_all.clamp_min(1e-30)).reshape(b, h, d)


@pytest.mark.parametrize("b,h,kv,s,d", [(2, 8, 8, 256, 32), (1, 25, 5, 200, 64)])
def test_split_merge_equals_reference(b, h, kv, s, d):
    """Over the plan's splits, at cache lengths around the chunk boundaries
    and past S, the merged partials equal the reference; with no valid slot
    the output is 0, as the Pallas kernel gives."""
    q = torch.from_numpy(normal(30, b, h, d))
    k, v = (torch.from_numpy(normal(i, b, kv, s, d)) for i in (31, 32))
    c, _ = da.split_plan(b, kv, s, d, q.element_size())
    for cl in (0, 1, c - 1, c, c + 1, s // 2 + 1, s, s + 9):
        got = split_merge(q, k, v, cl)
        want = (torch.zeros(b, h, d) if cl == 0 else
                ref.decode_attention_reference(q, k, v, cl))   # f32 arithmetic
        torch.testing.assert_close(got.float(), want, rtol=1e-5, atol=1e-6)


def test_pallas_decode_gives_zero_without_valid_slots(jk):
    """The contract K3 keeps at cache_len = 0: the TPU kernel skips every
    block and returns acc / max(l, 1e-30) = 0 (the plain reference, which
    masks to -1e30, would average V instead)."""
    q, k, v = (jk.jnp.asarray(normal(i, 2, *shape)) for i, shape in
               ((33, (10, 64)), (34, (5, 256, 64)), (35, (5, 256, 64))))
    out = jk.decode(q, k, v, 0, block_k=128, interpret=jk.interpret)
    assert np.array_equal(f32(out), np.zeros((2, 10, 64), np.float32))


# --------------------------------------------------------------------------- #
# hymba-1.5b's head layout against the Pallas kernels
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hymba_prefill_plain_matches_pallas(jk, window, dtype):
    jq, tq = both(jk, normal(40, 1, 25, 128, 64), dtype)
    jkk, tk_ = both(jk, normal(41, 1, 5, 128, 64), dtype)
    jv, tv = both(jk, normal(42, 1, 5, 128, 64), dtype)
    out = fa.flash_attention(tq, tk_, tv, causal=True, window=window)
    pallas = jk.flash(jq, jkk, jv, causal=True, window=window, block_q=64, block_k=64,
                      interpret=jk.interpret)
    np.testing.assert_allclose(f32(out), f32(pallas), **TOL[dtype])


@pytest.mark.parametrize("cl", [1, 65, 256, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hymba_decode_plain_matches_pallas(jk, cl, dtype):
    jq, tq = both(jk, normal(43, 2, 25, 64), dtype)
    jkk, tk_ = both(jk, normal(44, 2, 5, 256, 64), dtype)
    jv, tv = both(jk, normal(45, 2, 5, 256, 64), dtype)
    out = da.decode_attention(tq, tk_, tv, torch.tensor(cl, dtype=torch.int32))
    pallas = jk.decode(jq, jkk, jv, cl, block_k=128, interpret=jk.interpret)
    np.testing.assert_allclose(f32(out), f32(pallas), **TOL[dtype])


# --------------------------------------------------------------------------- #
# the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_edges_on_card(cuda, dtype):
    """K2 at Sq = Sk in {63, 64, 65} (the 64-row tiles' edges), at 2,048
    tokens with and without a 1,024-token window and at every head dim, and
    without the causal mask and at Sq != Sk (Whisper's cross-attention, 65
    queries over 1,500 frames; ragged tiles on either side of Sq = Sk, with
    and without a window, the masks aligned top-left); K3
    at cache_len in {0, 1, C-1, C, C+1, S/2+1, S, S+9} on llama-13b's and
    hymba-1.5b's caches. Each against its plain version (0 at cache_len 0),
    each second call bit-identical, and every bf16 K2 launch on the
    tensor cores."""
    tdt = TORCH_DTYPES[dtype]
    g = torch.Generator(device=cuda).manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda).to(tdt)

    def check(got, want, again):
        torch.testing.assert_close(got, want, **TOL[dtype])
        assert torch.equal(got, again)

    before = tk.launch_counts()
    wgmma_before = fa.WGMMA_LAUNCHES
    flash_cases = [(63, 25, 5, 64, 0), (64, 25, 5, 64, 0), (65, 25, 5, 64, 0),
                   (2048, 25, 5, 64, 0), (2048, 25, 5, 64, 1024),
                   (65, 8, 2, 32, 0), (65, 8, 2, 128, 0), (65, 8, 1, 256, 20)]
    for s, h, kv, d, window in flash_cases:
        # the model's (B, S, H, d) layout, read through head-major views
        q, k, v = rnd(1, s, h, d), rnd(1, s, kv, d), rnd(1, s, kv, d)
        args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        check(fa.flash_attention(*args, window=window),
              fa.flash_attention_plain(*args, window=window),
              fa.flash_attention(*args, window=window))
    cross_cases = [(65, 1500, 20, 20, 64, False, 0), (65, 200, 8, 2, 128, True, 16),
                   (65, 200, 8, 2, 128, False, 16), (130, 70, 8, 2, 64, True, 0),
                   (130, 70, 8, 2, 64, False, 64), (70, 130, 8, 1, 256, False, 0)]
    for sq, sk, h, kv, d, causal, window in cross_cases:
        q, k, v = rnd(1, sq, h, d), rnd(1, sk, kv, d), rnd(1, sk, kv, d)
        args = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        kw = dict(causal=causal, window=window)
        check(fa.flash_attention(*args, **kw), fa.flash_attention_plain(*args, **kw),
              fa.flash_attention(*args, **kw))
    n_decode = 0
    for b, kv, s, d in (LLAMA, HYMBA_GLOBAL):
        h = 40 if kv == 40 else 25
        q, kc, vc = rnd(b, h, d), rnd(b, kv, s, d), rnd(b, kv, s, d)
        c, _ = da.split_plan(b, kv, s, d, kc.element_size())
        for cl in (0, 1, c - 1, c, c + 1, s // 2 + 1, s, s + 9):
            n = torch.tensor([cl], dtype=torch.int32, device=cuda)
            want = (torch.zeros_like(q) if cl == 0 else
                    da.decode_attention_plain(q, kc, vc, n))
            check(da.decode_attention(q, kc, vc, n), want, da.decode_attention(q, kc, vc, n))
            n_decode += 2
    torch.cuda.synchronize()
    after = tk.launch_counts()
    n_flash = 2 * (len(flash_cases) + len(cross_cases))
    assert after["flash_attention"] - before["flash_attention"] == n_flash
    assert after["decode_attention"] - before["decode_attention"] == n_decode
    assert fa.WGMMA_LAUNCHES - wgmma_before == (n_flash if dtype == "bfloat16" else 0)
