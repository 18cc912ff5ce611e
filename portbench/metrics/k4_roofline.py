"""k4_roofline: the fused residual of csrc/dir_residual.cu in precoeff mode (K4, the exact-BC
ansatz folded into per-point coefficients: forward with its per-test-function sum, backward
with its reduction) over its roofline, one value and one directional panel over every point.
Its bytes per point are CoeffData's rows: the n_in scaled coordinates, the n_in direction
rows, csrc and cu."""

from portbench import readers


def read(ctx):
    s = ctx.shapes
    args = (2, s["points"], s["n_in"], s["tests"], s["n_in"] + 2)
    return readers.kernel_roofline(
        ctx, r"\bvr_(fwd|bwd|qsum|reduce)_kernel\b",
        [(r"\bvr_fwd_kernel\b", ("fwd", *readers.net(ctx), *args)),
         (r"\bvr_bwd_kernel\b", ("bwd", *readers.net(ctx), *args))])
