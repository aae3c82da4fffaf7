"""K5′ (the selective scan's backward) in the traced steps: the sum of its
launches' bounds over the sum of their device times, in percent."""
from perfbench.lib.roofline import share


def read(ctx):
    if ctx["trace"] is None:
        return None
    mix = ctx["cell"].traffic
    _, per = ctx["cell"].reference.train_work(ctx["cell"].config, mix["batch"], mix["seq"])
    return share(ctx["trace"], "ssm_scan_bwd_kernel", "step", per["K5bwd"])
