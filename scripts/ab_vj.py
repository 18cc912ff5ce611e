#!/usr/bin/env python3
"""K5 forward / backward, K6 times and LM seconds per iteration of two checkouts of this
repository, alternated on one GPU, each run in a fresh process from its checkout's
own ``chip_smoke.py`` (which builds that checkout's kernels on its first run).

    python3 scripts/ab_vj.py OTHER_CHECKOUT . --pairs 3

Each run, at widths (48, 48) (the time-to-1e-3 recipe's LM net) and (48, 48, 48)
(the pinned flagship thetas' net), n_in 3, on the flagship mesh (transient 2-D AD,
disc 48 / t_disc 32: P = 4,382,656 points):

* ``vj_fwd`` (K5 forward), ``vj_bwd`` (K5 backward) and ``vj_jvp`` (K6) on a seeded net
  with a seeded cotangent and tangent, over the full mesh and over one LM chunk (the
  first 1/16 of the test functions), CUDA events, median of 20;
* ``refine_lm`` at cg 20, k_chunks 16 for ``--lm-steps`` iterations (the w48x3 net
  from ``flagship_theta_8.3e-4.npz``, the w48x2 net from its seeded init): seconds
  per iteration over the iterations after the first.

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
from varnet_tpu_torch import VarNet, load_theta_npz, params_from_jax
from varnet_tpu_torch.ops import value_and_jac as vj
from varnet_tpu_torch.problems.analytic import transient_ad_2d

steps = json.loads(sys.argv[1])["lm_steps"]
torch.backends.cuda.matmul.allow_tf32 = False
cs.phase_build()
xs_t, nq = cs._bench_points()
kc = -(-(xs_t.shape[1] // nq) // 16)
out = {}
for widths in ((48, 48), (48, 48, 48)):
    tag = "w" + "x".join(map(str, widths))
    params, gen = cs._seeded_net(3, widths, 0)
    for shape, pts in (("mesh", xs_t), ("chunk", xs_t[:, :kc * nq].contiguous())):
        g = torch.randn(4, pts.shape[1], generator=gen).cuda()
        tangent = [{k: torch.randn(v.shape, generator=gen).cuda() for k, v in layer.items()}
                   for layer in params]
        out[f"fwd_ms_{tag}_{shape}"] = cs._median_ms(lambda: vj.vj_fwd(params, pts, "tanh"))
        out[f"bwd_ms_{tag}_{shape}"] = cs._median_ms(lambda: vj.vj_bwd(params, pts, "tanh", g))
        out[f"jvp_ms_{tag}_{shape}"] = cs._median_ms(
            lambda: vj.vj_jvp(params, pts, "tanh", tangent))
    vn = VarNet(transient_ad_2d()["pde"], layer_width=widths, device="cuda", **cs.BENCH)
    if len(widths) == 3:
        vn.theta = params_from_jax(load_theta_npz(cs.LM_START), device="cuda")
    res = vn.refine_lm(weight=cs.WEIGHT, steps=steps, cg_iters=20, k_chunks=16, save_freq=1,
                       verbose=False, error_disc=48, error_times=3)
    torch.cuda.synchronize()
    out[f"lm_s_per_iter_{tag}"] = (res.wall_times[-1] - res.wall_times[0]) / (steps - 1)
    out[f"lm_loss_{tag}"] = res.losses[-1]["loss"]
print(json.dumps(out))
"""


def _check(args):
    if args.lm_steps < 2:
        raise SystemExit("--lm-steps must be >= 2 (the first iteration is not timed)")


def main(argv=None):
    ab_main(CHILD, argv, [("--lm-steps", int, 3)], _check)


if __name__ == "__main__":
    main()
