"""device_idle.adam: the share of the traced Adam window in which no operation ran on the card."""

from portbench import readers


def read(ctx):
    return readers.device_idle(ctx)
