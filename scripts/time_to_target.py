#!/usr/bin/env python3
"""The main path's headline through the PyTorch/CUDA port on one GPU: wall time to
rel-L2 1e-3 with the recipe of ``benchmarks/time_to_target.py`` on
``transient_ad_2d``, width (48, 48):

1. Adam at disc 30 / t_disc 20, 20,000 epochs (lr 2e-3, decay 0.4 every epochs / 4);
2. Adam at disc 48 / t_disc 32, 3,000 epochs, warm-started (lr 5e-4, decay 0.4 every
   epochs / 3);
3. LM (<= 40 iterations, cg 200, cg_segment 40, k_chunks 16), stopping at rel-L2 1e-3;

errors at disc 96 over 7 time slices, weight (1, 10, 10).  Adam runs through K1/K2,
LM through K5 / K6.

    python3 scripts/time_to_target.py
    python3 scripts/time_to_target.py --coarse-epochs 200 --fine-epochs 50 --lm-steps 2

Prints the card's name and power limit, one line per report and last a JSON object
with each stage's seconds and rel-L2, the LM iterations taken and the wall time.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=48)
    ap.add_argument("--coarse-epochs", type=int, default=20000)
    ap.add_argument("--fine-epochs", type=int, default=3000)
    ap.add_argument("--lm-steps", type=int, default=40)
    ap.add_argument("--lm-cg", type=int, default=200)
    args = ap.parse_args(argv)

    import torch

    from varnet_tpu_torch import VarNet
    from varnet_tpu_torch.problems.analytic import transient_ad_2d
    from varnet_tpu_torch.train.optim import OptimizerConfig

    if not torch.cuda.is_available():
        raise SystemExit("time_to_target.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    pde, w, widths = transient_ad_2d()["pde"], (1.0, 10.0, 10.0), (args.width, args.width)
    err = dict(error_disc=96, error_times=7)
    t0 = time.perf_counter()
    vn = VarNet(pde, layer_width=widths, disc_num=30, b_disc_num=30, t_disc_num=20,
                device="cuda", optimizer=OptimizerConfig(
                    lr=2e-3, decay_rate=0.4, decay_steps=max(args.coarse_epochs // 4, 1)))
    r1 = vn.train(epoch_num=args.coarse_epochs, weight=w,
                  save_freq=max(args.coarse_epochs // 4, 1), **err)
    t1 = time.perf_counter()
    vn2 = VarNet(pde, layer_width=widths, disc_num=48, b_disc_num=48, t_disc_num=32,
                 device="cuda", optimizer=OptimizerConfig(
                     lr=5e-4, decay_rate=0.4, decay_steps=max(args.fine_epochs // 3, 1)))
    vn2.theta = vn.theta
    r2_errors = []
    if args.fine_epochs > 0:
        r2_errors = vn2.train(epoch_num=args.fine_epochs, weight=w,
                              save_freq=max(args.fine_epochs // 2, 1), **err).errors
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    r3 = vn2.refine_lm(steps=args.lm_steps, weight=w, cg_iters=args.lm_cg, cg_segment=40,
                       k_chunks=16, save_freq=1, target_error=1e-3, **err)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    finite = lambda errs: [e for e in errs if e == e]  # noqa: E731
    best = min(finite(r1.errors + r2_errors + r3.errors))
    print(json.dumps({
        "target": 1e-3, "reached": best < 1e-3, "best_rel_l2": best,
        "coarse_rel_l2": min(finite(r1.errors), default=None),
        "fine_rel_l2": min(finite(r2_errors), default=None),
        "lm_iterations": len(r3.losses), "width": args.width,
        "device": torch.cuda.get_device_name(0),
        "coarse_s": t1 - t0, "fine_s": t2 - t1, "lm_s": t3 - t2, "wall_to_finish_s": t3 - t0,
    }), flush=True)


if __name__ == "__main__":
    main()
