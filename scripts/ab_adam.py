#!/usr/bin/env python3
"""Adam throughput and the residual kernels of two checkouts of this repository,
alternated on one GPU, each run in a fresh process from its checkout's own
``chip_smoke.py`` (which builds that checkout's kernels on its first run).

    python3 scripts/ab_adam.py OTHER_CHECKOUT . --pairs 3

Each run, CUDA events, median of 20 (10 for K4):

* K1/K2 forward and backward (``dir_residual_fwd`` / ``_bwd``) at the flagship mesh
  (transient 2-D AD, disc 48 / t_disc 32: 4,382,656 points) on a seeded net of widths
  (20, 20) (the bench shape) and (48, 48) (the time-to-1e-3 recipe's net), with a seeded
  cotangent;
* K4 forward and backward (``dirp_residual_fwd`` / ``_bwd``) at the exact-BC 3-D
  transient recipe's mesh (disc 16 / t_disc 10, w64x2, the hard fold: 7,776,000 points),
  as ``chip_smoke.py``'s kernels-dirp phase builds it;
* each of those three forwards split into its kernels (the tensor-core forward and the
  per-test-function sum, or the one kernel of an older tree) under ``torch.profiler``:
  each kernel's own device time, mean over 10 calls;
* 20 Adam epochs of that exact-BC VarNet through K4, after one epoch from its seeded
  net, as ``chip_smoke.py``'s hard-train phase runs them: steps/s;
* 200 (``--epochs``) Adam epochs at d48/t32, w20x2, through K1/K2, as ``chip_smoke.py``'s
  train phase runs them: steps/s and quad-pt evals/s.

Runs A, B, B, A for each pair, so a drift of the shared host over the call falls on
both trees alike.  Prints the card's name and power limit, one JSON line per run and
last a JSON summary with each tree's numbers in run order.
"""

from __future__ import annotations

from ab_common import main as ab_main

CHILD = """
import json, sys
import torch
import chip_smoke as cs
from ab_common import kernel_ms
from varnet_tpu_torch.fem.assembly import pad_quad
from varnet_tpu_torch.ops import fused_residual as fr

epochs = json.loads(sys.argv[1])["epochs"]
torch.backends.cuda.matmul.allow_tf32 = False
cs.phase_build()
out = {}
data = cs._bench_data()
for widths in ((20, 20), (48, 48)):
    params, gen = cs._seeded_net(data.xs.shape[0], widths, 0)
    gr = torch.randn(data.k, generator=gen).cuda()
    tag = "x".join(map(str, widths))
    out["k1_fwd_ms_w" + tag] = cs._median_ms(lambda: fr.dir_residual_fwd(params, data, "tanh"))
    out["k1_fwd_kernels_ms_w" + tag] = kernel_ms(
        lambda: fr.dir_residual_fwd(params, data, "tanh"), n=10)
    out["k1_bwd_ms_w" + tag] = cs._median_ms(
        lambda: fr.dir_residual_bwd(params, data, "tanh", gr))
del data
vn3 = cs._hard_vn("transient_ad_3d", (64, 64), cs.HARD_3DT)
quad = pad_quad(vn3.fixed.quad, 1)
data = fr.prepare_residual_coeffs(quad, vn3.scale, vn3.shift, time_dependent=True,
                                  has_react=vn3.has_react, hard=vn3._hard_tables(quad),
                                  device="cuda")
params, gen = cs._seeded_net(4, (64, 64), 21)
gr = torch.randn(data.k, generator=gen).cuda()
out["k4_fwd_ms_3dt_w64x2"] = cs._median_ms(
    lambda: fr.dirp_residual_fwd(params, data, "tanh"), n=10)
out["k4_fwd_kernels_ms_3dt_w64x2"] = kernel_ms(
    lambda: fr.dirp_residual_fwd(params, data, "tanh"), n=10)
out["k4_bwd_ms_3dt_w64x2"] = cs._median_ms(
    lambda: fr.dirp_residual_bwd(params, data, "tanh", gr), n=10)
del data, quad
torch.cuda.empty_cache()
vn3.train(epoch_num=1, save_freq=1, verbose=False, error_disc=24)
res = vn3.train(epoch_num=20, save_freq=20, verbose=False, error_disc=24)
out["hard_3dt_steps_per_sec"] = res.steps_per_sec
del vn3
torch.cuda.empty_cache()
_, res = cs._train((20, 20), None, epochs, epochs, True)
out.update(steps_per_sec=res.steps_per_sec, quad_evals_per_sec=res.quad_evals_per_sec)
print(json.dumps(out))
"""


def main(argv=None):
    ab_main(CHILD, argv, [("--epochs", int, 200)])


if __name__ == "__main__":
    main()
