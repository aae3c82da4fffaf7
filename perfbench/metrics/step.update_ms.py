"""The train step's update on the card, the global-norm clip and the
optimizer: the union of the device operations from its ``update`` mark to
its ``done`` mark, a traced step, in ms."""
from perfbench.lib import spans


def read(ctx):
    return spans.part_ms(ctx, "update", "done")
