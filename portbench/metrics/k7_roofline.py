"""k7_roofline: the value + input jacobian through the Fourier embedding, csrc/ff_mlp.cu's
ff_fwd_kernel and ff_bwd_kernel (with its reduction) as LM launches them, over its
roofline: 1 + n_in panels over one chunk of the test functions per launch."""

from portbench import readers


def read(ctx):
    s = ctx.shapes
    chunk = s["points"] / int(ctx.cell.workload["params"]["k_chunks"])
    panels = 1 + s["n_in"]
    return readers.kernel_roofline(
        ctx, r"\b(ff_fwd|ff_bwd|ff_reduce)_kernel\b",
        [(r"\bff_fwd_kernel\b", ("fwd", *readers.net(ctx), panels, chunk, s["n_in"])),
         (r"\bff_bwd_kernel\b", ("bwd", *readers.net(ctx), panels, chunk, s["n_in"]))])
