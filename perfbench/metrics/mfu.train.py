"""The train step's model operations (6 a weight a token, attention three
times its forward) at 989 TFLOP/s, over the wall time a step of the window
(as ``train_tokens_per_s`` counts steps and time), in percent."""
from perfbench.lib import counts
from perfbench.lib.stats import window_steps


def read(ctx):
    n, seconds = window_steps(ctx)
    if not n:
        return None
    mix = ctx["cell"].traffic
    work, _ = ctx["cell"].reference.train_work(ctx["cell"].config, mix["batch"], mix["seq"])
    return 100.0 * work.flops / counts.BF16_FLOPS_PER_S / (seconds / n)
