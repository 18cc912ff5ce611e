"""lm_launches_per_cg: device kernels the LM window launched, per CG iteration."""


def read(ctx):
    n_cg = ctx.units * int(ctx.cell.workload["params"]["cg_iters"])
    n = sum(1 for e in ctx.events if e.kernel)
    return n / n_cg if n and n_cg else None
