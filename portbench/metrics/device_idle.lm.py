"""device_idle.lm: the share of the traced LM window in which no operation ran on the card."""

from portbench import readers


def read(ctx):
    return readers.device_idle(ctx)
