"""k8_roofline: the parameter JVP of the value + input jacobian through the Fourier
embedding, csrc/ff_mlp.cu's ff_jvp_kernel, over its roofline: 1 + n_in panels over one
chunk of the test functions per launch."""

from portbench import readers


def read(ctx):
    s = ctx.shapes
    chunk = s["points"] / int(ctx.cell.workload["params"]["k_chunks"])
    return readers.kernel_roofline(
        ctx, r"\bff_jvp_kernel\b",
        [(r"\bff_jvp_kernel\b", ("jvp", *readers.net(ctx), 1 + s["n_in"], chunk, s["n_in"]))])
