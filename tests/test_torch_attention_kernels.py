"""Prefill (K2) and decode (K3) attention at the edges of their Hopper
designs: K2's choice of kernel by element type, K3's split of the cache over
blocks and the merge of the splits, hymba-1.5b's head layout (25 q / 5 kv
heads of 64) against the Pallas kernels, and, on the card, the kernels
against their plain versions at the tile and split boundaries. K2′, the
backward: which backward a call takes (``backward_route``), the plain
log-sum-exp and row term D against ``torch.logsumexp`` and the softmax's
Σ P ∘ dP, the backward kernels' arithmetic in PyTorch against the ops
backward, and, on the card, the kernels against both.
"""
import math
import types

import numpy as np
import pytest
import torch

from repro_torch import kernels as tk
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

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
# K2′: the backward's route, its row statistics and its arithmetic
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("device,dtype,d,backward", [
    ("cuda", torch.bfloat16, 32, "kernels"), ("cuda", torch.bfloat16, 64, "kernels"),
    ("cuda", torch.bfloat16, 128, "kernels"),
    ("cuda", torch.bfloat16, 256, "ops"),     # gemma-2b: 2 x 128 f32 accumulators a thread
    ("cuda", torch.float32, 64, "ops"),       # the f32 checks need f32 arithmetic
    ("cuda", torch.float64, 64, "ops"),
    ("cpu", torch.bfloat16, 64, "ops"), ("cpu", torch.float32, 64, "ops"),
    ("meta", torch.bfloat16, 64, "ops"),      # the dry-run traces the ops backward
])
def test_backward_route(device, dtype, d, backward):
    assert fa.backward_route(device, dtype, d) == backward


def test_cpu_function_takes_the_ops_backward():
    """On the CPU the Function saves no log-sum-exp and its gradients are
    the ops backward's, bit for bit."""
    q, do = (torch.from_numpy(normal(i, 2, 40, 4, 32)) for i in (60, 61))
    k, v = (torch.from_numpy(normal(i, 2, 40, 2, 32)) for i in (62, 63))
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ops.flash_attention(qq, kk, vv, causal=True, window=16)
    assert len(out.grad_fn.saved_tensors) == 4
    got = torch.autograd.grad(out, (qq, kk, vv), do)
    want = ops.attention_backward_ops(q, k, v, out.detach(), do, True, 16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


#: (B, Sq, Sk, H, KV, d, causal, window) of the CPU checks: GQA causal, a
#: window, a ragged length, unmasked Sq != Sk both ways, a window without
#: the causal mask
BWD_CPU_CASES = [(2, 100, 100, 6, 2, 32, True, 0), (1, 130, 130, 4, 1, 64, True, 48),
                 (2, 75, 75, 8, 8, 16, True, 0), (1, 65, 200, 6, 6, 32, False, 0),
                 (1, 130, 70, 8, 2, 32, False, 0), (1, 90, 120, 4, 2, 32, False, 40)]


def bwd_inputs(case, dtype=torch.float64, seed=70):
    b, sq, sk, h, kv, d, _, _ = case
    q, do = (torch.from_numpy(normal(seed + i, b, sq, h, d)).to(dtype) for i in (0, 1))
    k, v = (torch.from_numpy(normal(seed + i, b, sk, kv, d)).to(dtype) for i in (2, 3))
    return q, k, v, do


def heads(*ts):
    return [t.transpose(1, 2) for t in ts]


@pytest.mark.parametrize("case", BWD_CPU_CASES)
def test_softmax_lse_plain_is_logsumexp(case):
    """The plain log-sum-exp equals ``torch.logsumexp`` over the masked
    scores of each q head against its kv head's keys, repeated K the other
    way round (f64; the same sums in another order)."""
    b, sq, sk, h, kv, d, causal, window = case
    q, k, _, _ = bwd_inputs(case)
    qh, kh = heads(q, k)
    s = torch.einsum("bhqd,bhkd->bhqk", qh, torch.repeat_interleave(kh, h // kv, dim=1))
    keep = ref.attention_mask(sq, sk, causal, window, q.device)
    want = torch.logsumexp((s / math.sqrt(d)).masked_fill(~keep, -math.inf), dim=-1)
    got = fa.softmax_lse_plain(qh, kh, causal=causal, window=window)
    assert got.shape == (b, h, sq) and got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", BWD_CPU_CASES)
def test_softmax_delta_plain_is_the_row_term(case):
    """D = rowsum(dO ∘ O) equals the softmax backward's row term Σ_k P dP,
    dP = dO Vᵀ, with P the plain attention's probabilities (f64: exact up to
    the order of the sums), and the ops backward takes its row term from
    it: rounding O to bf16 moves the two apart, not the formula."""
    b, sq, sk, h, kv, d, causal, window = case
    q, k, v, do = bwd_inputs(case)
    qh, kh, vh, doh = heads(q, k, v, do)
    out = ref.mha_reference(qh, kh, vh, causal=causal, window=window)
    s, keep = fa._scores(qh, kh, causal, window)
    p = torch.softmax(s.masked_fill(~keep, -math.inf), dim=-1).reshape(b, h, sq, sk)
    dp = torch.einsum("bhqd,bhkd->bhqk", doh, torch.repeat_interleave(vh, h // kv, dim=1))
    torch.testing.assert_close(fa.softmax_delta_plain(out, doh), (p * dp).sum(dim=-1),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("case", BWD_CPU_CASES)
def test_backward_plain_equals_the_ops_backward(case):
    """The backward kernels' arithmetic (P from the log-sum-exp, masked to
    0, D from O and dO) equals the ops backward (P by softmax under the
    mask's bias) in f64: the same gradient by another road."""
    _, _, _, _, _, _, causal, window = case
    q, k, v, do = bwd_inputs(case)
    qh, kh, vh, doh = heads(q, k, v, do)
    out = ref.mha_reference(qh, kh, vh, causal=causal, window=window)
    lse = fa.softmax_lse_plain(qh, kh, causal=causal, window=window) * math.log2(math.e)
    got = fa.flash_attention_backward_plain(qh, kh, vh, out, lse, doh, causal=causal,
                                            window=window)
    want = ops.attention_backward_ops(q, k, v, out.transpose(1, 2), do, causal, window)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.transpose(1, 2), w, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("case", BWD_CPU_CASES[:3])
def test_backward_plain_in_bf16_rounds_only_p_and_ds(case):
    """With bf16 inputs the plain backward rounds P and dS to bf16 before
    their products, as the kernels do: normwise within 1e-2 of the ops
    backward's f32 on the same inputs (P and dS each rounded at 2^-9
    relative, the gradients to bf16 on both sides), and not equal to it."""
    _, _, _, _, _, _, causal, window = case
    q, k, v, do = bwd_inputs(case, torch.bfloat16)
    qh, kh, vh, doh = heads(q, k, v, do)
    out = fa.flash_attention_plain(qh, kh, vh, causal=causal, window=window)
    lse = fa.softmax_lse_plain(qh, kh, causal=causal, window=window) * math.log2(math.e)
    got = fa.flash_attention_backward_plain(qh, kh, vh, out, lse, doh, causal=causal,
                                            window=window)
    want = ops.attention_backward_ops(q, k, v, out.transpose(1, 2), do, causal, window)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        err = float((a.transpose(1, 2).float() - w.float()).norm() / w.float().norm())
        assert 0 < err < 1e-2


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


#: K2′ on the card, (B, Sq, Sk, H, KV, d, causal, window): hymba-1.5b's layer
#: (2 x 2,048 tokens, 25 q / 5 kv heads of 64) in a window and a global
#: layer, qwen1.5-0.5b's training shape, d 32 and d 128, a ragged 1,000
#: tokens, whisper's unmasked cross-attention (Sq != Sk)
BWD_CARD_CASES = [(2, 2048, 2048, 25, 5, 64, True, 1024), (2, 2048, 2048, 25, 5, 64, True, 0),
                  (8, 128, 128, 16, 16, 64, True, 0), (2, 256, 256, 8, 2, 32, True, 64),
                  (1, 256, 256, 8, 2, 128, True, 0), (2, 1000, 1000, 8, 2, 64, True, 0),
                  (2, 128, 1500, 6, 6, 64, False, 0)]
#: normwise, kernels against the ops backward (f32 P and dS): the kernels
#: round P and dS to bf16 as operands (2^-9 relative each); both sides round
#: the gradients to bf16. An NVIDIA H100 read 2.3e-3 to 2.7e-3 over these cases
BWD_VS_OPS_TOL = 1e-2
#: normwise, kernels against their arithmetic in PyTorch
#: (``flash_attention_backward_plain``): the sums in another order, and a
#: bf16 rounding of P or dS that falls the other way; the H100 read up to 3e-4
BWD_VS_PLAIN_TOL = 2e-3
#: the log-sum-exp, base 2, absolute: f32 sums in another order and the
#: special-function exponent; the H100 read up to 1.9e-6 at |lse| up to ~12
LSE_TOL = 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("case", BWD_CARD_CASES)
def test_attention_backward_kernels_on_card(cuda, case):
    """K2′ through ``ops.FlashAttentionFunction`` on bf16 inputs: the
    forward's log-sum-exp against the plain one; dQ, dK and dV against the
    ops backward in f32 on the same inputs and O (BWD_VS_OPS_TOL) and
    against the kernels' arithmetic in PyTorch (BWD_VS_PLAIN_TOL); a second
    backward gives the same bits; each call launches one training forward,
    one dQ and one dK/dV kernel."""
    b, sq, sk, h, kv, d, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(9)
    q, do = (torch.randn((b, sq, h, d), generator=g, device=cuda).bfloat16() for _ in range(2))
    k, v = (torch.randn((b, sk, kv, d), generator=g, device=cuda).bfloat16() for _ in range(2))
    before, wgmma = tk.launch_counts(), fa.WGMMA_LAUNCHES
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ops.flash_attention(qq, kk, vv, causal=causal, window=window)
    lse = out.grad_fn.saved_tensors[4]
    grads = torch.autograd.grad(out, (qq, kk, vv), do, retain_graph=True)
    again = torch.autograd.grad(out, (qq, kk, vv), do)
    torch.cuda.synchronize()
    after = tk.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {
        n: {"flash_attention": 1, "flash_attention_bwd_dq": 2,
            "flash_attention_bwd_dkv": 2}.get(n, 0) for n in after}
    assert fa.WGMMA_LAUNCHES - wgmma == 1
    assert all(torch.equal(a, c) for a, c in zip(grads, again))

    qh, kh, vh, oh, doh = heads(q, k, v, out.detach(), do)
    want_lse = fa.softmax_lse_plain(qh, kh, causal=causal, window=window) * math.log2(math.e)
    torch.testing.assert_close(lse[..., :sq], want_lse, rtol=0, atol=LSE_TOL)
    opsb = ops.attention_backward_ops(q, k, v, out.detach(), do, causal, window)
    plain = fa.flash_attention_backward_plain(qh, kh, vh, oh, lse, doh, causal=causal,
                                              window=window)
    for name, got, w, p in zip(("dq", "dk", "dv"), grads, opsb, plain):
        assert got.dtype == torch.bfloat16 and got.shape == w.shape and got.is_contiguous()
        err = float((got.float() - w.float()).norm() / w.float().norm())
        assert err <= BWD_VS_OPS_TOL, (name, err)
        err = float((got.float() - p.transpose(1, 2).float()).norm() / p.float().norm())
        assert err <= BWD_VS_PLAIN_TOL, (name, err)
