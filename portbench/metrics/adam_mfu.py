"""adam_mfu: the whole Adam step's share of the card's TF32 peak (api.py::_train_impl)."""

from portbench import readers, roofline


def read(ctx):
    return readers.mfu(ctx, roofline.adam_step_flops(ctx.shapes))
