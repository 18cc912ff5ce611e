#!/usr/bin/env python3
"""Where 2 LM iterations of ``chip_smoke.py``'s inverse-phase comparisons accept their
steps: the inverse-flow shape (``benchmarks/inverse_flow.py``: contaminant_inlet_2d,
d(32, 16)/t20, w32x3, 300 observations, u_max trainable from 0.5, k_chunks 2) and the
``neumann_2d`` CLI's (d30/b20 w20x2).  For each case, Adam through the kernels to each
of ``--epochs``, then LM (cg ``--cg``) from there on the plain and the kernel path at
each damping of ``--lam0``: each iteration's loss and lam (a step is accepted when lam
falls).  A comparison whose steps are all rejected compares only the start.

    python3 scripts/lm_damping.py [--epochs 220,1000,3000] [--lam0 1e-3,1e-2,1e-1,1]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", default="220,1000,3000")
    ap.add_argument("--lam0", default="1e-3,1e-2,1e-1,1")
    ap.add_argument("--cg", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from varnet_tpu_torch import VarNet
    from varnet_tpu_torch.problems import analytic
    from varnet_tpu_torch.train.optim import OptimizerConfig

    flow_obs = cs._flow_obs()
    flow_opt = OptimizerConfig(lr=2e-3, decay_rate=0.1, decay_steps=3000)
    neu_opt = OptimizerConfig(lr=1e-3, decay_rate=0.4, decay_steps=5000)

    def flow(kernels=True):
        return VarNet(analytic.contaminant_inlet_2d(kappa=0.03, u_max=1.0)["pde"],
                      device="cuda", vel_fn=cs._poiseuille, vel_init=np.array([0.5]),
                      obs_data=flow_obs, optimizer=flow_opt, use_pallas=kernels, **cs.FLOW_MESH)

    def neumann(kernels=True):
        return VarNet(analytic.steady_ad_2d_neumann()["pde"], device="cuda", optimizer=neu_opt,
                      use_fused_residual=kernels, use_pallas=kernels, **cs.NEU_MESH)

    def lm(make, kernels, theta, weight, lam0, **kw):
        vn = cs._with_theta(make(kernels), theta)
        res = vn.refine_lm(steps=2, cg_iters=args.cg, weight=weight, lam0=lam0, save_freq=1,
                           verbose=False, **kw)
        return [[r["loss"], r["lam"]] for r in res.losses]

    for name, make, weight, kw in (("flow", flow, cs.FLOW_W, {"k_chunks": 2}),
                                   ("neumann", neumann, cs.NEU_W, {})):
        vn, done = make(), 0
        for epochs in (int(e) for e in args.epochs.split(",")):
            t0 = time.perf_counter()
            res = vn.train(epoch_num=epochs - done, weight=weight, save_freq=epochs - done,
                           verbose=False)
            done = epochs
            out = {"case": name, "adam_epochs": epochs, "loss": res.losses[-1]["loss"],
                   "adam_seconds": time.perf_counter() - t0}
            for lam0 in (float(v) for v in args.lam0.split(",")):
                for kernels in (False, True):
                    key = f"lam0_{lam0:g}_{'kernel' if kernels else 'plain'}"
                    out[key] = lm(make, kernels, vn.theta, weight, lam0, **kw)
            print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
