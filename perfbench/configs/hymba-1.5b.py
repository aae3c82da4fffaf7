"""Plain reference of hymba-1.5b (arXiv:2411.13676), beside its sizes in
``hymba-1.5b.json``.

Plain PyTorch in float32 (TF32 off), written from the layer equations and
importing nothing of the program under test. Each layer runs a GQA attention
branch (sliding window of ``window`` keys except in ``global_layers``) and a
Mamba branch (causal depthwise conv, selective scan with state ``ssm_state``)
on the same RMS-normed input; the two outputs are RMS-normed, scaled by
learned betas, averaged and added to the residual, then a SwiGLU MLP. The
embedding is also the LM head. Departures from the published model: no meta
tokens and no cross-layer KV sharing, as the program under test has none.

Serving follows the serving engine's cache contract: a prefill of one bucket
keeps a window layer's last ``window`` keys at slots ``0..window-1`` and a
global layer's keys at their positions; a decode step at the engine's shared
position ``pos`` rotates by ``pos``, writes a global layer's key at slot
``min(pos, size - 1)`` and a window layer's at ``pos % size``, and attends to
the slots below ``pos + 1``. :func:`serve_logits` replays a request's prompt
and served tokens under those rules and returns the logits of every served
token. :func:`loss` is the training loss.

``mm`` is the matrix product every projection goes through: the harness's
control passes one that rounds its operands to a lower precision.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _mm(x, w):
    return x @ w


def dims(cfg: dict) -> dict:
    d = cfg["d_model"]
    hd = cfg.get("head_dim") or d // cfg["n_heads"]
    return dict(d=d, hd=hd, h=cfg["n_heads"], kv=cfg["n_kv_heads"], di=cfg["d_inner"],
                n=cfg["ssm_state"], k=cfg["conv_kernel"], f=cfg["d_ff"],
                v=cfg["vocab_size"], r=max(1, math.ceil(d / 16)))


# --------------------------------------------------------------------------- #
# parameters: the tree, and how each leaf is drawn
# --------------------------------------------------------------------------- #
def empty_params(cfg: dict, device) -> dict:
    """The parameter tree, uninitialised: matrices and norms in the
    configuration's ``dtype``,
    ``a_log``, ``dt_bias``, ``d_skip`` and the betas in float32."""
    z = dims(cfg)
    d, hd, di = z["d"], z["hd"], z["di"]
    dtype = getattr(torch, cfg["dtype"])

    def e(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    f32 = torch.float32
    layer = lambda: {  # noqa: E731
        "attn_norm": e(d), "wq": e(d, z["h"] * hd), "wk": e(d, z["kv"] * hd),
        "wv": e(d, z["kv"] * hd), "wo": e(z["h"] * hd, d), "attn_out_norm": e(d),
        "in_proj": e(d, 2 * di), "conv_w": e(z["k"], di), "conv_b": e(di),
        "x_proj": e(di, z["r"] + 2 * z["n"]), "dt_proj": e(z["r"], di),
        "dt_bias": e(di, dt=f32), "a_log": e(di, z["n"], dt=f32), "d_skip": e(di, dt=f32),
        "ssm_out_proj": e(di, d), "ssm_out_norm": e(d),
        "beta_attn": e(dt=f32), "beta_ssm": e(dt=f32), "mlp_norm": e(d),
        "w_gate": e(d, z["f"]), "w_up": e(d, z["f"]), "w_down": e(z["f"], d)}
    return {"embed": e(z["v"], d), "final_norm": e(d),
            "layers": [layer() for _ in range(cfg["n_layers"])]}


def fills(cfg: dict, params: dict) -> list[list[tuple]]:
    """How each leaf is drawn, in blocks (the embedding and final norm, then a
    block a layer): ``(leaf, ("normal", scale))``, ``(leaf, ("const", c))``
    or ``(leaf, ("log_arange", n))``: ``log(1..n)`` along the last axis."""
    z = dims(cfg)

    def normal(fan_in):
        return ("normal", 1.0 / math.sqrt(fan_in))

    one, zero = ("const", 1.0), ("const", 0.0)
    blocks = [[(params["embed"], ("normal", 0.02)), (params["final_norm"], one)]]
    for lp in params["layers"]:
        blocks.append([
            (lp["attn_norm"], one), (lp["wq"], normal(z["d"])), (lp["wk"], normal(z["d"])),
            (lp["wv"], normal(z["d"])), (lp["wo"], normal(z["h"] * z["hd"])),
            (lp["attn_out_norm"], one), (lp["in_proj"], normal(z["d"])),
            (lp["conv_w"], ("normal", 0.2)), (lp["conv_b"], zero),
            (lp["x_proj"], normal(z["di"])), (lp["dt_proj"], normal(z["r"])),
            (lp["dt_bias"], zero), (lp["a_log"], ("log_arange", z["n"])),
            (lp["d_skip"], one), (lp["ssm_out_proj"], normal(z["di"])),
            (lp["ssm_out_norm"], one), (lp["beta_attn"], one), (lp["beta_ssm"], one),
            (lp["mlp_norm"], one), (lp["w_gate"], normal(z["d"])),
            (lp["w_up"], normal(z["d"])), (lp["w_down"], normal(z["f"]))])
    return blocks


# --------------------------------------------------------------------------- #
# pieces
# --------------------------------------------------------------------------- #
def rmsnorm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rope(x, pos, theta):
    """x: (R, S, H, hd); pos: (R, S) int. Half-rotation, angles in float64."""
    hd = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64, device=x.device) / hd)
    ang = pos.double()[..., None] * freqs
    cos, sin = ang.cos().float()[:, :, None], ang.sin().float()[:, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def swiglu(x, lp, mm):
    return mm(F.silu(mm(x, lp["w_gate"])) * mm(x, lp["w_up"]), lp["w_down"])


def fuse(attn_out, ssm_out, lp, eps):
    return 0.5 * (rmsnorm(attn_out, lp["attn_out_norm"], eps) * lp["beta_attn"]
                  + rmsnorm(ssm_out, lp["ssm_out_norm"], eps) * lp["beta_ssm"])


def ssm_inputs(u, lp, z, mm):
    proj = mm(u, lp["x_proj"])
    r, n = z["r"], z["n"]
    dt = F.softplus(mm(proj[..., :r], lp["dt_proj"]) + lp["dt_bias"])
    return dt, proj[..., r:r + n], proj[..., r + n:]


def scan(u, dt, a, b, c, h, block: int = 256):
    """The selective scan, one step at a time: h_t = exp(dt_t a) h_{t-1} +
    dt_t b_t u_t, y_t = h_t c_t. u, dt: (R, S, I); a: (I, N); b, c: (R, S,
    N); h: (R, I, N). Returns (y (R, S, I), h)."""
    ys = []
    for t0 in range(0, u.shape[1], block):
        sl = slice(t0, t0 + block)
        decay = torch.exp(dt[:, sl, :, None] * a)
        push = (dt[:, sl] * u[:, sl])[..., None] * b[:, sl, None, :]
        hs = []
        for t in range(decay.shape[1]):
            h = torch.addcmul(push[:, t], decay[:, t], h)
            hs.append(h)
        ys.append(torch.einsum("rtin,rtn->rti", torch.stack(hs, 1), c[:, sl]))
    return torch.cat(ys, 1), h


def attend(q, k, v, keep):
    """q: (R, Sq, H, hd); k, v: (R, Sk, KV, hd); keep: (R or 1, Sq, Sk) bool."""
    g = q.shape[2] // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    s = torch.einsum("rqhd,rkhd->rhqk", q, k) / math.sqrt(q.shape[-1])
    s = s.masked_fill(~keep[:, None], float("-inf"))
    return torch.einsum("rhqk,rkhd->rqhd", torch.softmax(s, -1), v)


# --------------------------------------------------------------------------- #
# the full sequence: prefill and training
# --------------------------------------------------------------------------- #
def full_layer(x, lp, cfg, is_global, mm=_mm, rows_at_once: int = 1):
    """One layer over whole sequences from zero state: (x, k, v, conv state,
    ssm state). Attention runs ``rows_at_once`` rows at a time."""
    z = dims(cfg)
    eps = cfg["norm_eps"]
    rr, s, _ = x.shape
    pos = torch.arange(s, device=x.device).expand(rr, s)
    h = rmsnorm(x, lp["attn_norm"], eps)
    q = rope(mm(h, lp["wq"]).reshape(rr, s, z["h"], z["hd"]), pos, cfg["rope_theta"])
    k = rope(mm(h, lp["wk"]).reshape(rr, s, z["kv"], z["hd"]), pos, cfg["rope_theta"])
    v = mm(h, lp["wv"]).reshape(rr, s, z["kv"], z["hd"])
    i = torch.arange(s, device=x.device)
    keep = i[None, :] <= i[:, None]
    if not is_global:
        keep &= i[None, :] > i[:, None] - cfg["window"]
    attn = torch.cat([attend(q[r:r + rows_at_once], k[r:r + rows_at_once],
                             v[r:r + rows_at_once], keep[None])
                      for r in range(0, rr, rows_at_once)])
    attn_out = mm(attn.reshape(rr, s, -1), lp["wo"])
    xz = mm(h, lp["in_proj"])
    u, zg = xz[..., :z["di"]], xz[..., z["di"]:]
    kk = lp["conv_w"].shape[0]
    up = F.pad(u, (0, 0, kk - 1, 0))
    conv = sum(up[:, j:j + s] * lp["conv_w"][j] for j in range(kk)) + lp["conv_b"]
    conv_state = u[:, s - (kk - 1):]
    u = F.silu(conv)
    dt, b, c = ssm_inputs(u, lp, z, mm)
    a = -torch.exp(lp["a_log"])
    y, ssm_state = scan(u, dt, a, b, c, u.new_zeros((rr, z["di"], z["n"])))
    ssm_out = mm((y + u * lp["d_skip"]) * F.silu(zg), lp["ssm_out_proj"])
    x = x + fuse(attn_out, ssm_out, lp, eps)
    x = x + swiglu(rmsnorm(x, lp["mlp_norm"], eps), lp, mm)
    return x, k, v, conv_state, ssm_state


def loss(params, tokens, labels, cfg, mm=_mm, remat: bool = True):
    """Mean next-token cross-entropy over (R, S) tokens; each layer
    recomputed in the backward when ``remat``."""
    x = params["embed"][tokens]
    for i, lp in enumerate(params["layers"]):
        fn = lambda x, lp=lp, g=i in cfg["global_layers"]: full_layer(  # noqa: E731
            x, lp, cfg, g, mm)[0]
        x = torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    x = rmsnorm(x, params["final_norm"], cfg["norm_eps"])
    logits = mm(x, params["embed"].T)
    return (torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None])[..., 0]).mean()


# --------------------------------------------------------------------------- #
# serving
# --------------------------------------------------------------------------- #
def serve_logits(params, prompts, served, positions, cfg, max_seq_len, mm=_mm):
    """The logits (f32, on the host) of every served token of R requests.

    ``prompts``: (R, bucket) tokens as the engine prefilled them; ``served``:
    R lists, the prefill's token then one a decode step; ``positions``: R
    lists, the engine's shared position at each of those decode steps. Entry
    r of the result is (len(served[r]), vocab)."""
    z = dims(cfg)
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    dev = prompts.device
    rr, s = prompts.shape
    x = params["embed"][prompts]
    caches = []
    for i, lp in enumerate(params["layers"]):
        is_global = i in cfg["global_layers"]
        x, k, v, conv, ssm = full_layer(x, lp, cfg, is_global, mm)
        size = max_seq_len if is_global else min(cfg["window"], max_seq_len)
        keep = s if is_global else min(cfg["window"], s)
        ck = x.new_zeros((rr, size, z["kv"], z["hd"]))
        cv = torch.zeros_like(ck)
        ck[:, :keep], cv[:, :keep] = k[:, s - keep:], v[:, s - keep:]
        caches.append(dict(k=ck, v=cv, conv=conv, ssm=ssm))
    last = mm(rmsnorm(x[:, -1], params["final_norm"], eps), params["embed"].T).cpu()
    out = [[last[r]] for r in range(rr)]
    steps = max(len(p) for p in positions)
    rows = torch.arange(rr, device=dev)
    for j in range(steps):
        # a row with no step j left repeats its last one; its logits are dropped
        tok = torch.tensor([sv[min(j, len(sv) - 2)] for sv in served], device=dev)
        pos = torch.tensor([p[min(j, len(p) - 1)] for p in positions], device=dev)
        x = params["embed"][tok][:, None]
        for i, lp in enumerate(params["layers"]):
            lc = caches[i]
            size = lc["k"].shape[1]
            h = rmsnorm(x, lp["attn_norm"], eps)
            q = rope(mm(h, lp["wq"]).reshape(rr, 1, z["h"], z["hd"]), pos[:, None], theta)
            k = rope(mm(h, lp["wk"]).reshape(rr, 1, z["kv"], z["hd"]), pos[:, None], theta)
            v = mm(h, lp["wv"]).reshape(rr, 1, z["kv"], z["hd"])
            slot = pos.clamp(max=size - 1) if i in cfg["global_layers"] else pos % size
            lc["k"][rows, slot] = k[:, 0]
            lc["v"][rows, slot] = v[:, 0]
            keep = (torch.arange(size, device=dev)[None, :] < (pos + 1)[:, None])[:, None]
            attn_out = mm(attend(q, lc["k"], lc["v"], keep).reshape(rr, 1, -1), lp["wo"])
            xz = mm(h, lp["in_proj"])
            u, zg = xz[..., :z["di"]], xz[..., z["di"]:]
            window = torch.cat([lc["conv"], u], 1)
            lc["conv"] = window[:, 1:]
            u = F.silu(torch.einsum("rki,ki->ri", window, lp["conv_w"]) + lp["conv_b"])[:, None]
            dt, b, c = ssm_inputs(u, lp, z, mm)
            y, lc["ssm"] = scan(u, dt, -torch.exp(lp["a_log"]), b, c, lc["ssm"])
            ssm_out = mm((y + u * lp["d_skip"]) * F.silu(zg), lp["ssm_out_proj"])
            x = x + fuse(attn_out, ssm_out, lp, eps)
            x = x + swiglu(rmsnorm(x, lp["mlp_norm"], eps), lp, mm)
        logits = mm(rmsnorm(x[:, 0], params["final_norm"], eps), params["embed"].T).cpu()
        for r in range(rr):
            if j < len(positions[r]):
                out[r].append(logits[r])
    return [torch.stack(o) for o in out]


# --------------------------------------------------------------------------- #
# the work of the served and trained steps, from their shapes
# --------------------------------------------------------------------------- #
def _counts():
    from perfbench.lib import counts
    return counts


def layer_matmul_params(cfg: dict) -> int:
    """The weights of one layer's matrix products."""
    z = dims(cfg)
    d, hd, di = z["d"], z["hd"], z["di"]
    return (2 * d * z["h"] * hd + 2 * d * z["kv"] * hd + 2 * d * di + di * (z["r"] + 2 * z["n"])
            + z["r"] * di + di * d + 3 * d * z["f"])


def weight_bytes(cfg: dict) -> int:
    """Bytes of every weight, as served (bf16, the float32 leaves in float32)."""
    tree = empty_params(cfg, "meta")
    leaves = [tree["embed"], tree["final_norm"]] + [t for lp in tree["layers"] for t in lp.values()]
    return sum(t.numel() * t.element_size() for t in leaves)


def _sizes(cfg: dict, max_seq_len: int) -> list[int]:
    return [max_seq_len if i in cfg["global_layers"] else min(cfg["window"], max_seq_len)
            for i in range(cfg["n_layers"])]


def decode_work(cfg: dict, slots: int, pos: int, max_seq_len: int):
    """One decode step of ``slots`` rows at the engine's shared position
    ``pos``: (the whole step's work, {"K3": each launch's}). The step reads
    every weight once (the embedding is also the head), each layer's cache
    slots below ``pos + 1``, and reads and writes the states; it writes a key
    and a value a row and layer, and the logits."""
    c, z = _counts(), dims(cfg)
    k3 = [c.decode_attention(slots, z["h"], z["kv"], z["hd"], min(pos + 1, size))
          for size in _sizes(cfg, max_seq_len)]
    per_layer = c.Work(f32_flops=7 * slots * z["di"] * z["n"],
                       bytes=slots * (2 * 2 * z["kv"] * z["hd"] + 2 * 4 * z["di"] * z["n"]
                                      + 2 * 2 * (z["k"] - 1) * z["di"]))
    step = (c.matmul(slots, cfg["n_layers"] * layer_matmul_params(cfg) + z["v"] * z["d"],
                     read_weights=False)
            + c.Work(bytes=weight_bytes(cfg) + 2 * slots * z["v"])
            + per_layer * cfg["n_layers"] + c.total(k3))
    return step, {"K3": k3}


def prefill_work(cfg: dict, bucket: int):
    """One prefill of ``bucket`` tokens: (its work, {"K2": each launch's}),
    the logits of the last position only."""
    c, z = _counts(), dims(cfg)
    k2 = [c.attention(1, bucket, z["h"], z["kv"], z["hd"],
                      0 if i in cfg["global_layers"] else cfg["window"])
          for i in range(cfg["n_layers"])]
    step = (c.matmul(bucket, cfg["n_layers"] * layer_matmul_params(cfg), read_weights=False)
            + c.matmul(1, z["v"] * z["d"], read_weights=False)
            + c.Work(f32_flops=7 * bucket * z["di"] * z["n"] * cfg["n_layers"],
                     bytes=weight_bytes(cfg))
            + c.total(k2))
    return step, {"K2": k2}


def train_work(cfg: dict, batch: int, seq: int):
    """One training step's model work (forward once, backward twice: 6
    operations a weight a token, attention three times its forward), and
    {"K5bwd": each launch of the selective scan's backward}."""
    c, z = _counts(), dims(cfg)
    attn = c.total(c.attention(batch, seq, z["h"], z["kv"], z["hd"],
                               0 if i in cfg["global_layers"] else cfg["window"])
                   for i in range(cfg["n_layers"]))
    step = (c.matmul(3 * batch * seq, cfg["n_layers"] * layer_matmul_params(cfg)
                     + z["v"] * z["d"], read_weights=False) + attn * 3)
    return step, {"K5bwd": [c.ssm_scan_backward(batch, seq, z["di"], z["n"])] * cfg["n_layers"]}
