#!/usr/bin/env python3
"""Peak device memory of one Adam epoch of the flagship problem (``transient_ad_2d``) on
the plain general path (no fused residual, no value+jac kernel) at a mesh and width: the
size a kernel-vs-plain comparison needs.  Prints the points, the card's memory, and the
peak allocated, or the allocator's message where the epoch does not fit.

    python3 scripts/plain_memory.py --widths 128,128,128 --disc 48 --tdisc 32 \\
        --activation sin
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--widths", default="128,128,128")
    ap.add_argument("--disc", type=int, default=48)
    ap.add_argument("--tdisc", type=int, default=32)
    ap.add_argument("--activation", default="sin")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from varnet_tpu_torch import VarNet
    from varnet_tpu_torch.problems.analytic import transient_ad_2d

    widths = tuple(int(w) for w in args.widths.split(","))
    vn = VarNet(transient_ad_2d()["pde"], layer_width=widths, device="cuda",
                activation=args.activation, use_fused_residual=False, use_pallas=False,
                disc_num=args.disc, b_disc_num=args.disc, t_disc_num=args.tdisc)
    out = {"widths": widths, "disc": args.disc, "tdisc": args.tdisc,
           "activation": args.activation,
           "points": vn.static.n_test * vn.static.n_quad_per_test,
           "card_gib": torch.cuda.get_device_properties(0).total_memory / 2**30}
    torch.cuda.reset_peak_memory_stats()
    try:
        vn.train(epoch_num=1, weight=(1.0, 10.0, 10.0), save_freq=1, verbose=False)
        torch.cuda.synchronize()
        out["fits"] = True
    except torch.OutOfMemoryError as e:   # the answer this script is for, not a failure
        out["fits"] = False
        out["message"] = str(e).splitlines()[0]
    out["peak_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(json.dumps(out))


if __name__ == "__main__":
    main()
