#!/usr/bin/env python3
"""How far 2 LM iterations move when their start moves by f32 rounding, on a SIREN
net, from one of ``chip_smoke.py``'s SIREN LM starts:

* ``--case flagship`` (the default): the flagship problem (``transient_ad_2d``,
  d48/t32), ``init_siren`` at omega0 6 from ``--seed`` (61: siren-wide's start, w128x3;
  35 with ``--widths 48,48``: the siren phase's), then ``--adam`` Adam epochs through
  the kernels; LM at cg ``--cg``, k_chunks 16;
* ``--case contaminant``: the siren-contaminant comparison's start (the first causal
  window, t <= 0.25, at d16/t10, w96x3 behind the committed 128 Fourier features, raw
  inputs, ``VarNet``'s own seed-0 SIREN net, Adam lr 2e-3), then ``--adam`` epochs
  through K2-FF; LM at cg ``--cg``, k_chunks 16, cg_segment 50.

From the start: LM on the plain path, on the plain path from the start perturbed
(theta (1 + eps n), n seeded standard normal, eps 1e-7 and 1e-6), and on the kernel
path from the start and from its 1e-7 perturbation.  Prints each run's losses and their
largest relative distance from the plain run from the start, as ``chip_smoke.py``
measures the kernel run's.

    python3 scripts/lm_spread.py [--case flagship] [--widths 128,128,128] [--seed 61]
                                 [--adam 20] [--cg 20] [--lam0 1e-3]
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHT = (1.0, 10.0, 10.0)
MESH = dict(disc_num=48, b_disc_num=48, t_disc_num=32)
CONT_SMALL = dict(disc_num=16, b_disc_num=16, t_disc_num=10)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", choices=("flagship", "contaminant"), default="flagship")
    ap.add_argument("--widths", default=None,
                    help="hidden widths (flagship: 128,128,128; contaminant: 96,96,96)")
    ap.add_argument("--seed", type=int, default=61, help="init_siren's seed (flagship)")
    ap.add_argument("--adam", type=int, default=20)
    ap.add_argument("--cg", type=int, default=20)
    ap.add_argument("--k-chunks", type=int, default=16)
    ap.add_argument("--lam0", type=float, default=1e-3, help="refine_lm's initial damping")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from varnet_tpu_torch import VarNet
    from varnet_tpu_torch.models.mlp import init_siren
    from varnet_tpu_torch.problems.analytic import contaminant_transport_2d, transient_ad_2d
    from varnet_tpu_torch.train.optim import OptimizerConfig
    from varnet_tpu_torch.utils.io import CONTAMINANT_CAUSAL_FOURIER_B

    flagship = args.case == "flagship"
    widths = tuple(int(w) for w in (args.widths or ("128,128,128" if flagship
                                                    else "96,96,96")).split(","))
    lm_kw = {} if flagship else {"cg_segment": 50}

    def varnet(**kw):
        if flagship:
            return VarNet(transient_ad_2d()["pde"], layer_width=widths, device="cuda",
                          activation="sin", **MESH, **kw)
        return VarNet(contaminant_transport_2d(t_final=0.25)["pde"], layer_width=widths,
                      device="cuda", activation="sin", input_scaling=False,
                      fourier_b=np.load(CONTAMINANT_CAUSAL_FOURIER_B),
                      optimizer=OptimizerConfig(lr=2e-3), **CONT_SMALL, **kw)

    vn = varnet()
    if flagship:
        vn.theta = init_siren(torch.Generator().manual_seed(args.seed), 3, widths,
                              omega0=6.0, device="cuda")
    vn.train(epoch_num=args.adam, weight=WEIGHT, save_freq=args.adam, verbose=False)
    start = vn.theta
    del vn
    gen = torch.Generator().manual_seed(7)
    noise = [{k: torch.randn(v.shape, generator=gen).cuda() for k, v in layer.items()}
             for layer in start]

    def lm(use_pallas, eps):
        v = varnet(use_pallas=use_pallas)
        v.theta = [{k: t * (1 + eps * n[k]) for k, t in layer.items()}
                   for layer, n in zip(start, noise)]
        res = v.refine_lm(weight=WEIGHT, steps=2, cg_iters=args.cg, k_chunks=args.k_chunks,
                          lam0=args.lam0, save_freq=1, verbose=False, **lm_kw)
        return np.array([r["loss"] for r in res.losses])

    ref = lm(False, 0.0)
    out = {"case": args.case, "widths": widths, "seed": args.seed if flagship else 0,
           "adam": args.adam, "cg": args.cg, "lam0": args.lam0, "plain": ref.tolist()}
    for name, use_pallas, eps in (("plain_1e-7", False, 1e-7), ("plain_1e-6", False, 1e-6),
                                  ("kernel", True, 0.0), ("kernel_1e-7", True, 1e-7)):
        losses = lm(use_pallas, eps)
        out[name] = losses.tolist()
        out[name + "_max_rel_diff"] = float(np.max(np.abs(losses - ref) / np.abs(ref)))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
