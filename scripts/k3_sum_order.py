#!/usr/bin/env python3
"""How the summation order of K3's output-bias gradient (b_out = sum_p g_u(p), the point
cotangents of the value) moves its error, on one case of the card sweep
(``tests/test_torch_cuda.py::test_ff_tensor_core_kernels_match_plain``, jacobian mode
without an embedding), on the CPU.

For each activation it forms the point cotangents g_u in f64 from the f64 plain forward
(``fused_residual._dir_coeffs`` / ``_nl_terms``: g_u = gr cu + gr w N (b . grad u)),
rounds them to f32 as a perfect kernel would hand them on, and sums them in the order of
``csrc/ff_mlp.cuh``'s backward: each thread of an epilogue group (EG of them) adds its
points of a tile (TP points) in a chain, the groups' sums are added in group order into
one partial per tile (one tile per block at this size), and ``ff_reduce_kernel`` adds the
partials in block order.  Printed per activation: the condition number
sum |g_u| / |sum g_u|, and the error against the f64 sum of the exact sum of the f32
terms, of that order in f32, of that order with each thread's chain in f64 (the sin
backward's), and of that order in f64.

    python3 scripts/k3_sum_order.py [--hp 96] [--depth 3] [--nq 64]
"""

import argparse
import importlib.util
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def kernel_sum(terms, tp, eg, chain, part):
    """terms summed in the backward's order: chains of ``chain`` adds, partials in ``part``."""
    partials = []
    for b in range(0, len(terms), tp):
        tile = terms[b:b + tp]
        v = part(0)
        for e in range(eg):
            s = chain(0)
            for x in tile[e::eg]:
                s = chain(s + chain(x))
            v = part(v + part(s))
        partials.append(v)
    total = part(0)
    for v in partials:
        total = part(total + v)
    return float(total)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hp", type=int, default=96)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--nq", type=int, default=64)
    ap.add_argument("--tp", type=int, default=32, help="points of a tile (ng 4 x 8)")
    ap.add_argument("--eg", type=int, default=2, help="epilogue groups (256 threads / HP)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from varnet_tpu_torch.ops import fused_residual as fr
    from varnet_tpu_torch.ops import value_and_jac as vj

    spec = importlib.util.spec_from_file_location(
        "cuda_tests", os.path.join(ROOT, "tests", "test_torch_cuda.py"))
    tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tests)
    seed = args.hp + args.depth + args.nq
    f32, f64 = np.float32, np.float64
    for act in ("tanh", "sigmoid", "sin"):
        params, _, data, gr = tests._ff_sweep_case("jac", None, args.hp, args.depth, args.nq,
                                                   seed=seed, device="cpu")
        d64 = tests._f64_data(data)
        out = vj.vj_fwd_plain(tests._f64(params), d64.xs, act)
        _, cu, _ = fr._dir_coeffs(d64)
        g = gr.double().repeat_interleave(d64.nq)
        wn, dub = fr._nl_terms(d64, out[1:])
        terms = (g * cu + g * wn * dub).numpy()
        ref = terms.sum()
        t32 = terms.astype(f32)

        def err(v):
            return f"{abs(v - ref) / abs(ref):.3e}"

        print(f"{act}: P {len(terms)}, condition {np.abs(terms).sum() / abs(ref):.1f}, "
              f"f32 terms summed exactly {err(t32.astype(f64).sum())}, "
              f"kernel order f32 {err(kernel_sum(t32, args.tp, args.eg, f32, f32))}, "
              f"f64 chains {err(kernel_sum(t32, args.tp, args.eg, f64, f32))}, "
              f"kernel order f64 {err(kernel_sum(t32, args.tp, args.eg, f64, f64))}")


if __name__ == "__main__":
    main()
