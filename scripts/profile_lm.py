#!/usr/bin/env python3
"""Where an LM iteration's time goes on the GPU: ``refine_lm`` of the main path
(``transient_ad_2d``, disc 48 / t_disc 32, cg 20, k_chunks 16) at widths (48, 48) and
(48, 48, 48) under ``torch.profiler``, after one unprofiled warm-up call.

    python3 scripts/profile_lm.py [--steps 2]

For each width prints one JSON line: the profiled window's wall time and seconds per
LM iteration, the device time summed over every kernel (the port's own, launched
through ctypes, included: the profiler records the device's kernels), its share of the
wall time (the device's busy share: the kernels run on one stream), the launches, the
K5 / K6 launch counters over the window, and the kernels with the most device time.
Then, at width (48, 48), one unprofiled LM iteration at cg 20 and one at the
time-to-1e-3 recipe's ``--count-cg`` (200), k_chunks 16: their K5 / K6 launches give the
launches per CG iteration (CG runs exactly ``cg_iters`` iterations, so an LM iteration
launches a + b cg_iters).
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
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--top", type=int, default=8)
    ap.add_argument("--count-cg", type=int, default=200)
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from varnet_tpu_torch import VarNet, load_theta_npz, params_from_jax
    from varnet_tpu_torch.ops import value_and_jac as vj
    from varnet_tpu_torch.problems.analytic import transient_ad_2d

    fns = {"vj_fwd": vj.vj_fwd, "vj_bwd": vj.vj_bwd, "vj_jvp": vj.vj_jvp}

    def counts():
        return {name: fn.launches for name, fn in fns.items()}

    if not torch.cuda.is_available():
        raise SystemExit("profile_lm.py needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    lm = dict(weight=cs.WEIGHT, steps=args.steps, cg_iters=20, k_chunks=16, save_freq=1,
              verbose=False, error_disc=48, error_times=3)
    for widths in ((48, 48), (48, 48, 48)):
        vn = VarNet(transient_ad_2d()["pde"], layer_width=widths, device="cuda", **cs.BENCH)
        if len(widths) == 3:
            vn.theta = params_from_jax(load_theta_npz(cs.LM_START), device="cuda")
        theta0 = [{k: v.clone() for k, v in layer.items()} for layer in vn.theta]
        vn.refine_lm(**lm)  # warm-up: the kernel library, cuBLAS handles, allocator
        vn.theta = theta0
        torch.cuda.synchronize()
        before = counts()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = vn.refine_lm(**lm)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launched = {name: n - before[name] for name, n in counts().items()}
        kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                                   getattr(e, "self_cuda_time_total", 0.0))
        busy = sum(dev_us(e) for e in kernels) * 1e-6
        top = sorted(kernels, key=dev_us, reverse=True)[:args.top]
        print(json.dumps({
            "widths": list(widths), "steps": args.steps, "wall_s": wall,
            "s_per_iter": (res.wall_times[-1] - res.wall_times[0]) / max(args.steps - 1, 1),
            "device_kernel_s": busy, "device_busy_share": busy / wall,
            "kernel_launches": sum(e.count for e in kernels), "counters": launched,
            "top": [{"name": e.key[:80], "calls": e.count, "ms": dev_us(e) * 1e-3}
                    for e in top],
        }), flush=True)
    vn = VarNet(transient_ad_2d()["pde"], layer_width=(48, 48), device="cuda", **cs.BENCH)
    per_lm = {}
    for cg in (lm["cg_iters"], args.count_cg):
        before = counts()
        vn.refine_lm(**{**lm, "steps": 1, "cg_iters": cg})
        torch.cuda.synchronize()
        per_lm[cg] = {name: n - before[name] for name, n in counts().items()}
    lo, hi = lm["cg_iters"], args.count_cg
    per_cg = {name: (per_lm[hi][name] - per_lm[lo][name]) / (hi - lo) for name in fns}
    print(json.dumps({"widths": [48, 48], "k_chunks": lm["k_chunks"],
                      "launches_per_lm_iteration": {f"cg{cg}": v for cg, v in per_lm.items()},
                      "launches_per_cg_iteration": per_cg,
                      "launches_outside_cg": {name: per_lm[lo][name] - lo * per_cg[name]
                                              for name in fns}}), flush=True)


if __name__ == "__main__":
    main()
