"""The train step's backward on the card, remat included: the union of the
device operations from its ``backward`` mark to its ``update`` mark, a
traced step, in ms."""
from perfbench.lib import spans


def read(ctx):
    return spans.part_ms(ctx, "backward", "update")
