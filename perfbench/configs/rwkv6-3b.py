"""Plain reference of rwkv6-3b, RWKV-6 "Finch" (arXiv:2404.05892), beside its
sizes in ``rwkv6-3b.json``.

Plain PyTorch in float32 (TF32 off), written from the layer equations and
importing nothing of the program under test. A layer is a time-mix (token
shift, the five-way data-dependent lerp through a LoRA, the WKV recurrence
with the data-dependent decay ``w_t = exp(-exp(decay_t))`` and the bonus
``u``, a per-head GroupNorm, the SiLU gate) and a channel-mix (token shift,
squared-ReLU FFN, sigmoid receptance), each after a LayerNorm. The embedding
is LayerNormed; the head is its own matrix. Layer weights are stacked on
axis 0.

Serving state is O(1) in the sequence: the WKV matrix and the two shifted
tokens a layer, so a request's decode steps are its sequence continued and
the engine's shared position does not enter. :func:`serve_logits` replays a
request's prompt and served tokens and returns the logits of every served
token; :func:`loss` is the training loss.

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
    return dict(d=d, f=cfg["d_ff"], v=cfg["vocab_size"], l=cfg["n_layers"],
                kd=cfg["rwkv_head_size"], h=d // cfg["rwkv_head_size"],
                ml=cfg["rwkv_mix_lora"], dl=cfg["rwkv_decay_lora"])


# --------------------------------------------------------------------------- #
# parameters
# --------------------------------------------------------------------------- #
def _stacked(z: dict) -> dict:
    """Each stacked leaf: (its shape in one layer, its fan-in's dimension
    or the constant it holds)."""
    d, f, ml, dl = z["d"], z["f"], z["ml"], z["dl"]
    return {
        "ln1_w": ((d,), 1.0), "ln1_b": ((d,), 0.0), "ln2_w": ((d,), 1.0),
        "ln2_b": ((d,), 0.0), "mu_x": ((d,), 0.5), "mu": ((5, d), 0.5),
        "tm_w1": ((d, 5 * ml), "d"), "tm_w2": ((5, ml, d), "ml"),
        "decay_base": ((d,), -4.0), "dw1": ((d, dl), "d"), "dw2": ((dl, d), "dl"),
        "u": ((d,), 0.0), "wr": ((d, d), "d"), "wk": ((d, d), "d"), "wv": ((d, d), "d"),
        "wg": ((d, d), "d"), "wo": ((d, d), "d"), "gn_w": ((d,), 1.0), "gn_b": ((d,), 0.0),
        "cm_mu_k": ((d,), 0.5), "cm_mu_r": ((d,), 0.5), "cm_wk": ((d, f), "d"),
        "cm_wv": ((f, d), "f"), "cm_wr": ((d, d), "d"),
    }


#: the stacked leaves kept in float32 under any dtype
_F32 = ("decay_base", "u")


def empty_params(cfg: dict, device) -> dict:
    """The parameter tree, uninitialised, in the configuration's ``dtype``
    but for the float32
    ``decay_base`` and ``u``."""
    z = dims(cfg)
    dtype = getattr(torch, cfg["dtype"])

    def e(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=device)

    layers = {name: e(z["l"], *shape, dt=torch.float32 if name in _F32 else dtype)
              for name, (shape, _) in _stacked(z).items()}
    d = z["d"]
    return {"embed": e(z["v"], d), "ln0_w": e(d), "ln0_b": e(d), "final_ln_w": e(d),
            "final_ln_b": e(d), "head": e(d, z["v"]), "layers": layers}


def fills(cfg: dict, params: dict) -> list[list[tuple]]:
    """How each leaf is drawn, in blocks: the embedding, the head with the
    norms, then a block a layer (its slice of every stack)."""
    z = dims(cfg)
    blocks = [[(params["embed"], ("normal", 0.02))],
              [(params["head"], ("normal", 1.0 / math.sqrt(z["d"]))),
               (params["ln0_w"], ("const", 1.0)), (params["ln0_b"], ("const", 0.0)),
               (params["final_ln_w"], ("const", 1.0)), (params["final_ln_b"], ("const", 0.0))]]
    for i in range(z["l"]):
        blocks.append([(params["layers"][name][i],
                        ("normal", 1.0 / math.sqrt(z[fan])) if isinstance(fan, str)
                        else ("const", fan))
                       for name, (_, fan) in _stacked(z).items()])
    return blocks


def layer_params(params: dict) -> list[dict]:
    names = list(params["layers"])
    return [dict(zip(names, row)) for row in zip(*(params["layers"][n].unbind(0)
                                                   for n in names))]


# --------------------------------------------------------------------------- #
# pieces
# --------------------------------------------------------------------------- #
def layernorm(x, w, b, eps=1e-5):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def groupnorm(x, w, b, heads, eps=1e-5):
    shape = x.shape
    xh = x.reshape(*shape[:-1], heads, shape[-1] // heads)
    mu = xh.mean(-1, keepdim=True)
    var = (xh - mu).square().mean(-1, keepdim=True)
    return ((xh - mu) * torch.rsqrt(var + eps)).reshape(shape) * w + b


def wkv(r, k, v, w, u, state):
    """The WKV recurrence one step at a time: y_t = r_t (S + u k_t v_t^T),
    S = w_t S + k_t v_t^T. r, k, v, w: (R, S, H, K); u: (H, K); state: (R, H,
    K, K). Returns (y (R, S, H, K), state)."""
    ys = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        ys.append(torch.einsum("rhk,rhkv->rhv", r[:, t], state + u[None, :, :, None] * kv))
        state = w[:, t, :, :, None] * state + kv
    return torch.stack(ys, 1), state


def time_mix(x, lp, z, shift, state, mm):
    """x: (R, S, D) normed; shift: (R, 1, D) the last normed token before x;
    state: (R, H, K, K). Returns (out, last token, state)."""
    rr, s, d = x.shape
    dx = torch.cat([shift, x[:, :-1]], 1) - x
    ws = torch.tanh(mm(x + dx * lp["mu_x"], lp["tm_w1"])).reshape(rr, s, 5, z["ml"])
    mix = lp["mu"] + torch.einsum("rsim,imd->rsid", ws, lp["tm_w2"])
    xw, xk, xv, xr, xg = (x + dx * mix[:, :, i] for i in range(5))
    shp = (rr, s, z["h"], z["kd"])
    r, k, v = (mm(a, lp[n]).reshape(shp) for a, n in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
    g = F.silu(mm(xg, lp["wg"]))
    decay = lp["decay_base"] + mm(torch.tanh(mm(xw, lp["dw1"])), lp["dw2"])
    w = torch.exp(-torch.exp(decay)).reshape(shp)
    y, state = wkv(r, k, v, w, lp["u"].reshape(z["h"], z["kd"]), state)
    y = groupnorm(y.reshape(rr, s, d), lp["gn_w"], lp["gn_b"], z["h"]) * g
    return mm(y, lp["wo"]), x[:, -1:], state


def channel_mix(x, lp, shift, mm):
    dx = torch.cat([shift, x[:, :-1]], 1) - x
    r = torch.sigmoid(mm(x + dx * lp["cm_mu_r"], lp["cm_wr"]))
    k = torch.square(F.relu(mm(x + dx * lp["cm_mu_k"], lp["cm_wk"])))
    return r * mm(k, lp["cm_wv"]), x[:, -1:]


def block(x, lp, z, tm, cm, state, mm):
    y, tm, state = time_mix(layernorm(x, lp["ln1_w"], lp["ln1_b"]), lp, z, tm, state, mm)
    x = x + y
    y, cm = channel_mix(layernorm(x, lp["ln2_w"], lp["ln2_b"]), lp, cm, mm)
    return x + y, tm, cm, state


# --------------------------------------------------------------------------- #
# training and serving
# --------------------------------------------------------------------------- #
def loss(params, tokens, labels, cfg, mm=_mm, remat: bool = True):
    """Mean next-token cross-entropy over (R, S) tokens from zero state;
    each layer recomputed in the backward when ``remat``."""
    z = dims(cfg)
    x = layernorm(params["embed"][tokens], params["ln0_w"], params["ln0_b"])
    rr = x.shape[0]
    zeros = x.new_zeros((rr, 1, z["d"]))
    state = x.new_zeros((rr, z["h"], z["kd"], z["kd"]))
    for lp in layer_params(params):
        fn = lambda x, lp=lp: block(x, lp, z, zeros, zeros, state, mm)[0]  # noqa: E731
        x = torch.utils.checkpoint.checkpoint(fn, x, use_reentrant=False) if remat else fn(x)
    x = layernorm(x, params["final_ln_w"], params["final_ln_b"])
    logits = mm(x, params["head"])
    return (torch.logsumexp(logits, -1) - logits.gather(-1, labels[..., None])[..., 0]).mean()


def serve_logits(params, prompts, served, positions, cfg, max_seq_len, mm=_mm):
    """The logits (f32, on the host) of every served token of R requests:
    the prompt (R, bucket) as the engine prefilled it, then each row's served
    tokens but its last, one a step. ``positions`` (the engine's shared
    position at each decode step) only says how many steps a row took."""
    z = dims(cfg)
    rr = prompts.shape[0]
    layers = layer_params(params)

    def run(tokens, carry):
        x = layernorm(params["embed"][tokens], params["ln0_w"], params["ln0_b"])
        new = []
        for lp, (tm, cm, st) in zip(layers, carry):
            x, tm, cm, st = block(x, lp, z, tm, cm, st, mm)
            new.append((tm, cm, st))
        x = layernorm(x[:, -1], params["final_ln_w"], params["final_ln_b"])
        return mm(x, params["head"]).cpu(), new

    zeros = torch.zeros((rr, 1, z["d"]), device=prompts.device)
    carry = [(zeros, zeros, zeros.new_zeros((rr, z["h"], z["kd"], z["kd"])))] * z["l"]
    logits, carry = run(prompts, carry)
    out = [[logits[r]] for r in range(rr)]
    for j in range(max(len(p) for p in positions)):
        tok = torch.tensor([[sv[min(j, len(sv) - 2)]] for sv in served], device=prompts.device)
        logits, carry = run(tok, carry)
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
    d = z["d"]
    return 10 * d * z["ml"] + 2 * d * z["dl"] + 6 * d * d + 2 * d * z["f"]


def weight_bytes(cfg: dict, embed: bool = True) -> int:
    """Bytes of every weight as served (the embedding left out when not
    ``embed``)."""
    tree = empty_params(cfg, "meta")
    leaves = [t for k, t in tree.items() if k != "layers" and (embed or k != "embed")]
    leaves += list(tree["layers"].values())
    return sum(t.numel() * t.element_size() for t in leaves)


def decode_work(cfg: dict, slots: int, pos: int, max_seq_len: int):
    """One decode step of ``slots`` rows: (the whole step's work, {"K6":
    each launch's}). The step reads every weight once but the embedding, of
    which it gathers a row a slot, reads and writes the WKV state and the two
    shifted tokens a layer, and writes the logits; ``pos`` does not enter."""
    c, z = _counts(), dims(cfg)
    k6 = [c.wkv(slots, 1, z["h"], z["kd"])] * z["l"]
    step = (c.matmul(slots, z["l"] * layer_matmul_params(cfg) + z["d"] * z["v"],
                     read_weights=False)
            + c.Work(bytes=weight_bytes(cfg, embed=False) + 2 * slots * z["d"]
                     + z["l"] * 2 * 2 * 2 * slots * z["d"] + 2 * slots * z["v"])
            + c.total(k6))
    return step, {"K6": k6}


def prefill_work(cfg: dict, bucket: int):
    """One prefill of ``bucket`` tokens: (its work, {"K6": each launch's}),
    the logits of the last position only."""
    c, z = _counts(), dims(cfg)
    k6 = [c.wkv(1, bucket, z["h"], z["kd"])] * z["l"]
    step = (c.matmul(bucket, z["l"] * layer_matmul_params(cfg), read_weights=False)
            + c.matmul(1, z["d"] * z["v"], read_weights=False)
            + c.Work(bytes=weight_bytes(cfg, embed=False)) + c.total(k6))
    return step, {"K6": k6}


def train_work(cfg: dict, batch: int, seq: int):
    """One training step's model work (6 operations a weight a token), and
    {"K6bwd": each launch of the WKV recurrence's backward}."""
    c, z = _counts(), dims(cfg)
    step = c.matmul(3 * batch * seq, z["l"] * layer_matmul_params(cfg) + z["d"] * z["v"],
                    read_weights=False)
    return step, {"K6bwd": [c.wkv_backward(batch, z["h"], seq, z["kd"])] * z["l"]}
