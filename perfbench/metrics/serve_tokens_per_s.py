"""Generated tokens delivered to the host within the window (each
request's first token when its prefill returned, then a token an active slot
a decode tick), divided by the window's length."""


def read(ctx):
    start, end = ctx["window"]
    first = sum(1 for s in ctx["sent"] if start <= s.first <= end)
    decoded = sum(t["tokens"] for t in ctx["ticks"] if start <= t["end"] <= end)
    return (first + decoded) / (end - start)
