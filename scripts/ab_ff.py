#!/usr/bin/env python3
"""The Fourier-feature kernels of ``csrc/ff_mlp.cu`` and the Adam steps through them, of
two checkouts of this repository, alternated on one GPU, each run in a fresh process
from its checkout's own ``chip_smoke.py`` (which builds that checkout's kernels on its
first run).

    python3 scripts/ab_ff.py OTHER_CHECKOUT . --pairs 3

Each run, CUDA events, median of 10 (5 at the full contaminant mesh), at the shapes
``chip_smoke.py`` gives them:

* K2-FF forward and backward (``dir_residual_ff_fwd`` / ``_bwd``) at the full contaminant
  mesh (disc 64 / t_disc 40 / bdisc 64: P = 9,906,624) on the pinned w96x3 net behind 128
  features, seeded cotangent;
* K7 forward and backward and K8 (``ff_vj_fwd`` / ``_bwd`` / ``_jvp``) on the first of
  the 16 LM chunks of that mesh (P = 619,200), seeded cotangent and tangent;
* K3 forward and backward (``jac_residual_fwd`` / ``_bwd``) at the Burgers front_2d
  recipe's mesh (d32/t20/b32, P = 1,168,576, w32x3, seeded);
* K4 on ``ff_mlp.cu`` (``dirp_residual_ff_fwd`` / ``_bwd``) at the hard 2-D order-2
  mesh (disc 48, per-node tables, P = 324,900) at w96x3, seeded;
* each of those split into its kernels' own device time under ``torch.profiler``
  (mean over a few calls);
* the blocks (and warps) resident per SM of each launch
  (``fused_residual.ff_launch_shape``; for the backward also whether it takes
  ``ff_bwd_kernel``'s wgmma engine), the K2-FF and K7 backward launches on that engine
  of all (``bwd_launches``), and ptxas' registers and spills of the ff kernels from the
  build log (``<NI,sin,wgmma>``);
* one contaminant LM iteration at the full mesh from the pinned theta (cg 10, k_chunks
  16, as ``chip_smoke.py``'s lm-ff phase: 2 iterations, the second timed): seconds;
* contaminant Adam at the full window (10 epochs after one) and Burgers front_2d Adam
  (100 epochs after one): steps/s.

The A B B A runner is ``scripts/ab_common.py``'s.
"""

from __future__ import annotations

from ab_common import main as ab_main

CHILD = """
import json, re
import torch
import chip_smoke as cs
from ab_common import kernel_ms
from varnet_tpu_torch.ops import build
from varnet_tpu_torch.ops import fused_residual as fr
from varnet_tpu_torch.ops import value_and_jac as vj

REPS = 10


def ptxas():
    # registers and spill bytes of every ff_mlp.cu kernel instantiation
    out, name = {}, None
    for line in (build.build_dir() / "build.log").read_text().splitlines():
        m = re.search(r"Compiling entry function "
                      r"'_Z\\d+(ff_\\w+?_kernel)(?:ILi(\\d)E(?:Lb([01])E)?(?:Lb([01])E)?)?", line)
        if m:  # the sin instantiations as "<NI,sin>", the backward's wgmma engine ",wgmma"
            name = m.group(1) + (f"<{m.group(2)}{',sin' if m.group(3) == '1' else ''}"
                                 f"{',wgmma' if m.group(4) == '1' else ''}>"
                                 if m.group(2) else "")
            continue
        if name is None:
            continue
        m = re.search(r"(\\d+) bytes spill stores, (\\d+) bytes spill loads", line)
        if m:
            out.setdefault(name, {})["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
            name = None
    return out


# name -> launch shape: kind, panels, points, ke, n_hidden, hp
launch = {}
torch.backends.cuda.matmul.allow_tf32 = False
cs.phase_build()
out = {"ptxas": ptxas()}

# K2-FF at the full contaminant mesh, K7 / K8 on its first LM chunk
vn = cs._contaminant(cs.CONT_FULL)
theta = cs._pinned_ff()
data = fr.prepare_residual_data(vn._to_device(vn.fixed.quad), None, None, time_dependent=True,
                                has_react=vn.has_react, device="cuda", fourier_bt=vn.fourier_bt)
gen = torch.Generator().manual_seed(11)
gr = torch.randn(data.k, generator=gen).cuda()
kc = -(-data.k // cs.LM_FF["k_chunks"])
part = cs._chunk(data, 0, kc)
bt = vn.fourier_bt
n = part.xs.shape[1]
g = torch.randn((4, n), generator=gen).cuda()
tangent = [{k: torch.randn(v.shape, generator=gen).cuda() for k, v in layer.items()}
           for layer in theta]
p_full = data.k * data.nq
calls = {
    "k2ff_fwd": (lambda: fr.dir_residual_ff_fwd(theta, data, "tanh"), 5),
    "k2ff_bwd": (lambda: fr.dir_residual_ff_bwd(theta, data, "tanh", gr), 5),
    "k7_fwd": (lambda: vj.ff_vj_fwd(theta, part.xs, bt, "tanh"), REPS),
    "k7_bwd": (lambda: vj.ff_vj_bwd(theta, part.xs, bt, "tanh", g), REPS),
    "k8": (lambda: vj.ff_vj_jvp(theta, part.xs, bt, "tanh", tangent), REPS),
}
bwds = {"k2ff_bwd": fr.dir_residual_ff_bwd, "k7_bwd": vj.ff_vj_bwd}
for c in bwds.values():
    c.launches = 0
    c.wgmma_launches = 0   # (a tree without the wgmma engine keeps it at 0)
for name, (fn, reps) in calls.items():
    out[name + "_ms"] = cs._median_ms(fn, n=reps, warmup=1)
    out[name + "_kernels_ms"] = kernel_ms(fn, n=2 if name.startswith("k2ff") else 3)
# the backward's engine: launches on ff_bwd_kernel's wgmma engine, of all
out["bwd_launches"] = {name: [c.wgmma_launches, c.launches] for name, c in bwds.items()}
launch.update({"k2ff_fwd": ("fwd", 2, p_full, 256, 3, 96),
               "k2ff_bwd": ("bwd", 2, p_full, 256, 3, 96),
               "k7_fwd": ("fwd", 4, n, 256, 3, 96), "k7_bwd": ("bwd", 4, n, 256, 3, 96),
               "k8": ("jvp", 4, n, 256, 3, 96)})
del data, part, g, gr
torch.cuda.empty_cache()

# K3 at the Burgers front_2d mesh (seeded w32x3)
vb = cs._burgers_vn()
bdata = fr.prepare_residual_data(vb._to_device(vb.fixed.quad), vb.scale, vb.shift,
                                 time_dependent=True, has_react=vb.has_react, device="cuda",
                                 nl_vec=vb.nl_vec, jacobian=True)
seeded, gen = cs._seeded_net(3, cs.BURG_NET, 31)
bgr = torch.randn(bdata.k, generator=gen).cuda()
for name, fn in (("k3_fwd", lambda: fr.jac_residual_fwd(seeded, bdata, "tanh")),
                 ("k3_bwd", lambda: fr.jac_residual_bwd(seeded, bdata, "tanh", bgr))):
    out[name + "_ms"] = cs._median_ms(fn, n=REPS, warmup=1)
    out[name + "_kernels_ms"] = kernel_ms(fn)
pb = bdata.k * bdata.nq
launch.update({"k3_fwd": ("fwd", 4, pb, 32, 3, 32), "k3_bwd": ("bwd", 4, pb, 32, 3, 32)})
del bdata
torch.cuda.empty_cache()

# K4 on ff_mlp.cu at the hard 2-D order-2 mesh, w96x3
vn2 = cs._hard_vn("steady_ad_2d", (48, 48), cs.HARD_2D_O2)
data2 = fr.prepare_residual_coeffs(vn2.fixed.quad, vn2.scale, vn2.shift, time_dependent=False,
                                   has_react=vn2.has_react,
                                   hard=vn2._hard_tables(vn2.fixed.quad), device="cuda")
params3, gen3 = cs._seeded_net(2, cs.HARD_WIDE, 25)
wgr = torch.randn(data2.k, generator=gen3).cuda()
for name, fn in (("k4w_fwd", lambda: fr.dirp_residual_ff_fwd(params3, data2, "tanh")),
                 ("k4w_bwd", lambda: fr.dirp_residual_ff_bwd(params3, data2, "tanh", wgr))):
    out[name + "_ms"] = cs._median_ms(fn, n=REPS, warmup=1)
    out[name + "_kernels_ms"] = kernel_ms(fn)
p2 = data2.k * data2.nq
launch.update({"k4w_fwd": ("fwd", 2, p2, 32, 3, 96), "k4w_bwd": ("bwd", 2, p2, 32, 3, 96)})
del data2, vn2
torch.cuda.empty_cache()
out["launch_shape"] = {name: fr.ff_launch_shape(*shape) for name, shape in launch.items()}

# LM at the full contaminant mesh from the pinned theta (K7 / K8): the second iteration
vn.theta = [{k: v.clone() for k, v in layer.items()} for layer in theta]
res = vn.refine_lm(weight=cs.WEIGHT, save_freq=1, verbose=False, **cs.LM_FF)
torch.cuda.synchronize()
out["contaminant_lm_s_per_iter"] = ((res.wall_times[-1] - res.wall_times[0])
                                    / (cs.LM_FF["steps"] - 1))
torch.cuda.empty_cache()

# Adam: contaminant at the full window (K2-FF), Burgers front_2d (K3)
vn.train(epoch_num=1, weight=cs.WEIGHT, save_freq=1, verbose=False)
res = vn.train(epoch_num=10, weight=cs.WEIGHT, save_freq=10, verbose=False)
out["contaminant_adam_steps_per_sec"] = res.steps_per_sec
del vn
torch.cuda.empty_cache()
vb.train(epoch_num=1, weight=cs.WEIGHT, save_freq=1, verbose=False, error_disc=32)
res = vb.train(epoch_num=100, weight=cs.WEIGHT, save_freq=100, verbose=False, error_disc=32)
out["burgers_adam_steps_per_sec"] = res.steps_per_sec
print(json.dumps(out))
"""


def main(argv=None):
    ab_main(CHILD, argv)


if __name__ == "__main__":
    main()
