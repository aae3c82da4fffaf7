"""The prefill's model operations (its matrix products and attention over
the bucket) at 989 TFLOP/s, over ``step.prefill_ms``, in percent."""
from perfbench.lib import counts
from perfbench.lib.cell import load_module, HERE


def read(ctx):
    ms = load_module(HERE / "metrics" / "step.prefill_ms.py").read(ctx)
    if not ms:
        return None
    work, _ = ctx["cell"].reference.prefill_work(ctx["cell"].config, ctx["ec"].prefill_bucket)
    return 100.0 * work.flops / counts.BF16_FLOPS_PER_S * 1e3 / ms
