"""1 - the union of the device operations' intervals over the traced
stretch of the training window, from torch.profiler, in percent."""


def read(ctx):
    tr = ctx["trace"]
    return None if tr is None else 100.0 * (1.0 - tr.busy_s / tr.window_s)
