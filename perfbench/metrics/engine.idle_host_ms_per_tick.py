"""The device's idle time while the serving engine works on the host: idle
under every ``engine.*`` span outside ``engine.prefill`` and
``engine.decode`` (staging, the cache splice, the argmax copies, the slots'
bookkeeping, the sampler, the controller), over the number of
``engine.decode_tick`` spans, in ms."""
from perfbench.lib import spans


def read(ctx):
    us = spans.host_idle(ctx["trace"])
    return None if us is None else us / 1e3
