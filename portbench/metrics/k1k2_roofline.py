"""k1k2_roofline: the fused residual of csrc/dir_residual.cu in table mode (K1/K2: forward
with its per-test-function sum, backward with its reduction) over its roofline, one value
and one directional panel over every point."""

from portbench import readers


def read(ctx):
    s = ctx.shapes
    args = (2, s["points"], s["n_in"])
    return readers.kernel_roofline(
        ctx, r"\bvr_(fwd|bwd|qsum|reduce)_kernel\b",
        [(r"\bvr_fwd_kernel\b", ("fwd", *readers.net(ctx), *args, s["tests"])),
         (r"\bvr_bwd_kernel\b", ("bwd", *readers.net(ctx), *args, s["tests"]))])
