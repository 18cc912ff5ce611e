"""Operations and bytes of the port's kernels, worked out from shapes, and the
card's peaks.

``flops`` / ``n_params`` / ``bounds`` are frozen copies of the arithmetic of
``chip_smoke.py``'s ``_flops`` / ``_n_params`` / ``_bounds``: each f32 layer product
counted once (2 FLOPs per multiply-add), the activations and the embedding's
sin / cos not counted, each byte read or written once.  Only the peak differs:
every kernel runs on the tensor cores, so the compute bound is the dense TF32
tensor-core rate, which no implementation of an f32 product (CUDA cores,
3xTF32 or any split) can pass.  Shares are stated against NVIDIA's published
H100 SXM peaks, at the card's power limit, which the run reports beside them.
"""

from __future__ import annotations

PEAK_FLOPS = 495e12   # FLOP/s, dense TF32 on the tensor cores (H100 SXM data sheet)
PEAK_BYTES = 3.35e12  # bytes/s, HBM3


def bound_seconds(n_flops: float, n_bytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(n_flops / PEAK_FLOPS, n_bytes / PEAK_BYTES)


def flops(kind, widths, k0, panels, points, first_panels=None):
    """FLOPs of the layer products over ``points`` for a net with layer-0 input
    width k0 and hidden widths ``widths``, pushing ``panels`` panels: the
    forward; the backward = recompute + weight gradients + the cotangents of
    the hidden layers; the JVP = W s, W ds and dW s at the hidden and output
    layers, W s and dW s at layer 0 (its input has no tangent: the points and B
    are fixed).  ``first_panels``: the panels that need layer 0's product."""
    hidden = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    first = 2 * (panels if first_panels is None else first_panels) * k0 * widths[0]
    rest = 2 * panels * (hidden + widths[-1])
    fwd = first + rest
    return points * {"fwd": fwd, "bwd": 2 * fwd + 2 * panels * hidden,
                     "jvp": 2 * first + 3 * rest}[kind]


def n_params(widths, k0):
    sizes = [k0] + list(widths) + [1]
    return sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))


def bounds(kind, widths, k0, panels, points, n_in, n_k=None, n_fields=4, first_panels=None):
    """(FLOPs, bytes) of one kernel launch: a residual kernel (n_k test
    functions; reads the coordinates and n_fields field rows, writes r or reads
    its cotangent) or a value+jac kernel (reads the coordinates, writes or reads
    1 + n_in rows); each reads the parameters once (the JVP their tangent too)
    and the backward writes the gradient."""
    params = 4 * n_params(widths, k0)
    if n_k is not None:
        nbytes = 4 * points * (n_in + n_fields) + 4 * n_k + params * (2 if kind == "bwd" else 1)
    else:
        rows = 0 if kind == "bwd" else 1 + n_in
        nbytes = 4 * points * (n_in + rows + (1 + n_in if kind == "bwd" else 0))
        nbytes += params * 2
    return flops(kind, widths, k0, panels, points, first_panels), nbytes


def shapes(config: dict) -> dict:
    """The sizes of a configuration's weak form (``reference/forms/<form>.py``'s
    ``shapes``): test functions, points, boundary and initial points, input
    width n_in, the net's layer-0 width k0 and hidden widths, and the panels
    per point that the form needs."""
    from .reference import forms

    return forms.load(config["form"]).shapes(config)


def adam_step_flops(s: dict) -> float:
    """Layer-product FLOPs one Adam step needs: the residual's forward and
    backward with the form's panels per point, and the penalty points' value
    forward and backward."""
    net, k = (s["widths"], s["k0"]), s["panels"]
    pen = s["bc_points"] + s["ic_points"]
    return (flops("fwd", *net, k, s["points"]) + flops("bwd", *net, k, s["points"])
            + flops("fwd", *net, 1, pen) + flops("bwd", *net, 1, pen))


def lm_iteration_flops(s: dict, cg_iters: int) -> float:
    """Layer-product FLOPs one LM iteration needs: two residual evaluations
    (the linearisation and the candidate's loss), 1 + cg_iters reverse passes
    (J^T r and one per CG iteration) and cg_iters forward-mode passes (J v),
    with the panels of :func:`adam_step_flops`."""
    net = (s["widths"], s["k0"])
    pen = s["bc_points"] + s["ic_points"]
    total = 0.0
    for pts, panels in ((s["points"], s["panels"]), (pen, 1)):
        total += (2 * flops("fwd", *net, panels, pts) + (1 + cg_iters) * flops("bwd", *net, panels, pts)
                  + cg_iters * flops("jvp", *net, panels, pts))
    return total
