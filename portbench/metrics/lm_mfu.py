"""lm_mfu: the whole LM iteration's share of the card's TF32 peak (train/gauss_newton.py)."""

from portbench import readers, roofline


def read(ctx):
    cg = int(ctx.cell.workload["params"]["cg_iters"])
    return readers.mfu(ctx, roofline.lm_iteration_flops(ctx.shapes, cg))
