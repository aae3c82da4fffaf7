"""K2 (prefill attention) in the traced window: the sum of its launches'
bounds over the sum of their device times, in percent. A prefill launches
it once a layer, each layer's bound from its window."""
from perfbench.lib.roofline import share


def read(ctx):
    if ctx["trace"] is None:
        return None
    _, per = ctx["cell"].reference.prefill_work(ctx["cell"].config, ctx["ec"].prefill_bucket)
    return share(ctx["trace"], "flash_", "submit", per["K2"])
