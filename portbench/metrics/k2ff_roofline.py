"""k2ff_roofline: the fused residual through the Fourier embedding, csrc/ff_mlp.cu's
ff_fwd_kernel (with its per-test-function sum) and ff_bwd_kernel (with its reduction),
over its roofline: one value and one directional panel over every point."""

from portbench import readers


def read(ctx):
    s = ctx.shapes
    args = (2, s["points"], s["n_in"])
    return readers.kernel_roofline(
        ctx, r"\b(ff_fwd|ff_bwd|ff_reduce|vr_qsum)_kernel\b",
        [(r"\bff_fwd_kernel\b", ("fwd", *readers.net(ctx), *args, s["tests"])),
         (r"\bff_bwd_kernel\b", ("bwd", *readers.net(ctx), *args, s["tests"]))])
