"""K3 (decode attention) in the traced window: the sum of its launches'
bounds (the cache slots each reads at the traced position) over the sum of
their device times, in percent."""
from perfbench.lib.roofline import share


def read(ctx):
    if ctx["trace"] is None:
        return None
    ec = ctx["ec"]
    _, per = ctx["cell"].reference.decode_work(ctx["cell"].config, ec.n_slots,
                                               ctx["trace_pos"], ec.max_seq_len)
    return share(ctx["trace"], "decode_split_kernel", "decode_tick", per["K3"])
