"""Performance-tuning knobs, as the JAX package's ``models/tuning.py``.

Module-level switches read each time the code below runs (the reference
reads them at trace time); the dry-run CLI (``launch/dryrun.py --tune``)
sets them before tracing, so baseline and tuned counts come from the same
model code. Their readers:

* ``attn_grouped``, ``attn_probs_bf16``, ``q_block`` and ``attn_block_remat``:
  ``models/common.py``'s ``attention`` and ``decode_attention``, as the
  reference's ``common.attention`` reads them, which pass them on as
  :func:`attention_knobs` to the plain attention and the plain decode
  attention (``kernels/ref.py::mha_reference``,
  ``decode_attention_reference``; the models reach them on the CPU and on
  the ``meta`` device) and to the backward of
  ``kernels/ops.py::FlashAttentionFunction`` (P and dS rebuilt a block of
  query rows at a time; autograd's gradient through the bf16 cast of P);
* ``seq_parallel`` and ``decode_cache_data_only``: the defaults of
  ``distributed/sharding.py``'s ``activation_spec(seq_parallel=)`` and
  ``cache_specs(data_only=)``.

The Hopper kernels read none: K2 (prefill attention) and K3 (decode
attention) group GQA by construction and keep their probabilities in f32,
as the Pallas kernels do; so on the card the attention backward keeps P in
f32 too. The kernels package reads no knob itself: it takes them as
arguments.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.ref import AttentionKnobs


@dataclasses.dataclass
class Tuning:
    #: cast softmax probabilities to bf16 before the AV matmul (halves the
    #: dominant score-traffic term; f32 row-stats retained)
    attn_probs_bf16: bool = False
    #: remat each attention q-block (the backward keeps no per-block probs)
    attn_block_remat: bool = False
    #: Megatron-style sequence parallelism: residual-stream activations
    #: sharded (batch, model, None) between blocks
    seq_parallel: bool = False
    #: decode KV caches sharded over batch axes only
    decode_cache_data_only: bool = False
    #: grouped-query attention without KV expansion: contract per KV group
    #: in the operands' dtype instead of materializing an f32,
    #: q_per_kv-times-repeated copy of K/V
    attn_grouped: bool = False
    #: q-block length used by blocked attention
    q_block: int = 1024

    def describe(self) -> str:
        on = [f.name for f in dataclasses.fields(self)
              if f.name != "q_block" and getattr(self, f.name)]
        if self.q_block != 1024:
            on.append(f"qblk{self.q_block}")
        return "+".join(on) if on else "baseline"


#: the active configuration (mutated by launch code before tracing)
ACTIVE = Tuning()


def set_tuning(**kwargs) -> Tuning:
    global ACTIVE
    ACTIVE = Tuning(**kwargs)
    return ACTIVE


def reset() -> None:
    global ACTIVE
    ACTIVE = Tuning()


def attention_knobs(t: Tuning | None = None) -> AttentionKnobs:
    """The attention knobs of ``t`` (:data:`ACTIVE` for None). Queries go
    in blocks once ``attn_block_remat`` is on or ``q_block`` is set away
    from its default; else in one (the reference's default blocks of 1,024
    rows compute the same rows alike)."""
    t = ACTIVE if t is None else t
    blocked = t.attn_block_remat or t.q_block != Tuning.q_block
    return AttentionKnobs(grouped=t.attn_grouped, probs_bf16=t.attn_probs_bf16,
                          q_block=t.q_block if blocked else 0,
                          block_remat=t.attn_block_remat)


def parse(tune: str) -> dict:
    """``set_tuning``'s arguments from the CLI's comma list, e.g.
    ``"attn_grouped,q_block=512"``."""
    kwargs: dict = {}
    for part in filter(None, tune.split(",")):
        if part.startswith("q_block="):
            kwargs["q_block"] = int(part.split("=")[1])
        else:
            kwargs[part] = True
    return kwargs
