"""The whole decode step's share of its least time: the larger of its
operations at peak and its bytes (every weight once, the cache slots below
the position and the states read and written) at 3.35 TB/s, over
``step.decode_ms``, in percent."""
from perfbench.lib.cell import load_module, HERE


def read(ctx):
    ms = load_module(HERE / "metrics" / "step.decode_ms.py").read(ctx)
    if not ms:
        return None
    ec = ctx["ec"]
    work, _ = ctx["cell"].reference.decode_work(ctx["cell"].config, ec.n_slots,
                                                ctx["trace_pos"], ec.max_seq_len)
    return 100.0 * work.bound_s * 1e3 / ms
