"""The train step's forward on the card: the union of the device operations
from its ``forward`` mark to its ``backward`` mark, a traced step, in ms."""
from perfbench.lib import spans


def read(ctx):
    return spans.part_ms(ctx, "forward", "backward")
