#!/usr/bin/env python3
"""The 2-D viscous-Burgers front recipe of ``benchmarks/burgers_accuracy.py --two-d``
run through the PyTorch/CUDA port on one GPU: ``burgers_2d_front(nu=0.1)``, disc 32 /
t_disc 20 / b_disc 32 (P = 1,168,576 quadrature points), w32x3, Adam lr 2e-3 decayed
by 0.1 every epochs / 4, weight (1, 10, 10), then Levenberg-Marquardt (cg 200,
k_chunks 2, as the published run passed it: ``benchmarks/tpu_queue7.sh``).  Adam runs
through the jacobian-panel residual K3, LM through K5 / K6.

    python3 scripts/burgers_recipe.py                    # 12,000 epochs + 40 LM x cg 200
    python3 scripts/burgers_recipe.py --epochs 200 --lm-steps 2 --lm-cg 20
    python3 scripts/burgers_recipe.py --init jax --lm-steps 0   # Adam from the JAX init

``--init``: the initial theta, the port's own seeded draw (default), ``jax`` for the
JAX package's seed-0 draw of the published run
(``varnet_tpu_torch/data/burgers_front_2d_jax_init.npz``) or the path of a theta npz.
``--lm-steps 0`` runs the Adam stage only.

Prints the card's name and power limit, one line per report, and last a JSON object
with the best Adam and LM rel-L2 (disc 96, 5 time slices, as the recipe scores), the
seconds of each stage and of the whole run (assembly included).
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
    ap.add_argument("--epochs", type=int, default=12000)
    ap.add_argument("--lm-steps", type=int, default=40)
    ap.add_argument("--lm-cg", type=int, default=200)
    ap.add_argument("--k-chunks", type=int, default=2)
    ap.add_argument("--init", default=None)
    args = ap.parse_args(argv)

    import torch

    from varnet_tpu_torch import VarNet, load_theta_npz, params_from_jax
    from varnet_tpu_torch.problems.analytic import burgers_2d_front
    from varnet_tpu_torch.train.optim import OptimizerConfig
    from varnet_tpu_torch.utils.io import BURGERS_FRONT_2D_JAX_INIT

    if not torch.cuda.is_available():
        raise SystemExit("burgers_recipe.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    weight = (1.0, 10.0, 10.0)
    t0 = time.perf_counter()
    vn = VarNet(burgers_2d_front(nu=0.1)["pde"], layer_width=(32,) * 3, disc_num=32,
                b_disc_num=32, t_disc_num=20, device="cuda",
                optimizer=OptimizerConfig(lr=2e-3, decay_rate=0.1,
                                          decay_steps=max(args.epochs // 4, 1)))
    if args.init is not None:
        path = BURGERS_FRONT_2D_JAX_INIT if args.init == "jax" else args.init
        vn.theta = params_from_jax(load_theta_npz(path), device="cuda")
    t1 = time.perf_counter()
    adam = vn.train(epoch_num=args.epochs, weight=weight, save_freq=max(args.epochs // 6, 1),
                    verbose=True, error_disc=96)
    t2 = time.perf_counter()
    lm_errors = []
    if args.lm_steps > 0:
        lm_errors = vn.refine_lm(steps=args.lm_steps, weight=weight, cg_iters=args.lm_cg,
                                 save_freq=max(args.lm_steps // 8, 1), verbose=True,
                                 error_disc=96, k_chunks=args.k_chunks).errors
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    finite = lambda errs: [e for e in errs if e == e]  # noqa: E731
    print(json.dumps({
        "case": "front_2d", "nu": 0.1, "mesh": "disc=32 tdisc=20 bdisc=32",
        "points": vn.static.n_test * vn.static.n_quad_per_test, "network": "(32,)x3",
        "epochs": args.epochs, "lm": f"{args.lm_steps} iters cg={args.lm_cg}",
        "k_chunks": args.k_chunks, "init": args.init or "port seed 0",
        "device": torch.cuda.get_device_name(0),
        "adam_rel_l2": min(finite(adam.errors), default=None),
        "adam_final_rel_l2": adam.errors[-1] if adam.errors else None,
        "best_rel_l2": min(finite(adam.errors) + finite(lm_errors), default=None),
        "adam_steps_per_sec": adam.steps_per_sec,
        "adam_quad_evals_per_sec": adam.quad_evals_per_sec,
        "assembly_s": t1 - t0, "adam_s": t2 - t1, "lm_s": t3 - t2, "wall_s": t3 - t0,
    }), flush=True)


if __name__ == "__main__":
    main()
