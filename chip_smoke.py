#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``varnet_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:  ``python3 chip_smoke.py``.

Phases (each prints one line of numbers; any failure raises, so the exit code
is non-zero and no result line is printed):

1. device   -- requires CUDA (no CPU fallback); prints the card's name and power limit.
2. build    -- builds every kernel of ``varnet_tpu_torch/csrc`` (one nvcc per source,
               started together, linked into one library); prints ptxas' report.
3. kernels  -- at the bench shape (transient 2-D AD, disc 48 / t_disc 32, width
               (20, 20)) and at width (48, 48, 48): the kernel's forward r and
               backward gradients against the plain PyTorch version on the same
               inputs, and the time per call of each (CUDA events, median of 20).
4. train    -- ``VarNet(...).train(200 epochs)`` at the bench shape on the kernel
               path; the launch counters must rise every epoch and the loss fall.
               Then 20 epochs on the kernel path and 20 on the plain path from the
               same theta: the loss trajectories agree within rtol 2e-4.
5. accuracy -- the pinned flagship theta re-scores below 1.25e-4 rel-L2, and the
               kernel-path loss equals the plain-path loss there within rtol 1e-4.
6. kernels-vj -- at the bench mesh (P = 4,382,656 points, n_in 3) for widths (20, 20)
               and (48, 48, 48): the value+jacobian kernels K5 forward (against
               ``mlp_value_and_jac``, rtol 1e-5), K5 backward and K6 JVP (against their
               plain versions, rtol 1e-4; seeded cotangent and tangent), and the time
               per call of each kernel and plain version.
7. lm       -- the third stage of the main path: ``refine_lm`` at width (48, 48, 48),
               disc 48 / t_disc 32, from ``flagship_theta_8.3e-4.npz`` (k_chunks 16),
               on the kernel path (K5/K6 launch counters rise by >= steps x cg_iters)
               and on the plain path; the loss does not rise, the two paths' losses
               agree within rtol 2e-2, and the final rel-L2 stays in (6e-4, 1e-3).
               The kernels are also held to their plain versions at the chunk shape
               the LM calls them with.

8. kernels-ff -- the Fourier-feature kernels at the pinned contaminant net (w96x3 behind
               128 features, scales (0.5, 2.0), committed B and theta, raw inputs) on
               the full contaminant mesh (disc 64 / t_disc 40 / bdisc 64, P =
               9,906,624 points).  K2-FF forward (rtol 5e-5) and backward (rtol 1e-4)
               at the full mesh, the shape Adam gives it, against the plain version run
               over the 16 LM chunks of test functions (r concatenated, gradients
               summed: the plain panels of the whole mesh would not fit the card).  K7
               forward and backward and K8 (rtol 1e-4) on the first LM chunk (P =
               619,200), the shape LM gives them.  Kernel and plain timed at the same
               shape.
9. causal   -- the slice's main path: ``train_causal`` over windows 0.25 / 0.5 / 0.75 /
               1.0 at the full mesh and width on the kernel path (Adam lr 2e-3, decay
               0.4 every epochs / 4, weight (1, 10, 10)); K2-FF launches rise by >= 1
               per epoch per window and the loss falls within each window from its second
               epoch on (a fresh Adam's first step kicks a warm start up).  Then 20
               epochs kernel vs plain at disc 16 / t_disc 10 from the seeded net
               (rtol 2e-4).
10. contaminant-accuracy -- the pinned theta re-scores below 2.0% against the CN-FDM
               field (t > 0 slices), and kernel and plain loss agree there within rtol
               1e-4 (at disc 16 / t_disc 10).
11. lm-ff   -- ``refine_lm`` from the pinned theta at the full mesh (k_chunks 16,
               cg_segment 50) on the kernel path: K7 / K8 launches rise by >= steps x
               cg_iters, the loss does not rise, the FDM rel-L2 stays below 2.0%;
               seconds per LM iteration.  Kernel vs plain (rtol 2e-2) at disc 16 /
               t_disc 10.

Cuts: the contaminant recipe (``benchmarks/contaminant_causal.py``) runs 8000 Adam
epochs per window and 12 LM iterations of cg 150; here 8 epochs per window and 2 LM
iterations of cg 10 (widths, features, mesh and the rest of the recipe are as
published).  The kernel-vs-plain runs use disc 16 / t_disc 10, since the plain
versions' [P, 256] panels at the full mesh would not fit the card.  The flagship
phases keep PR 1 and PR 2's depths.  The bounds (``_bounds``) count the layer products
of each kernel's work at the timed shape.

The line before last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
PINNED = os.path.join(ROOT, "benchmarks", "results", "flagship_theta_1.0e-04.npz")
LM_START = os.path.join(ROOT, "benchmarks", "results", "flagship_theta_8.3e-4.npz")
BENCH = dict(disc_num=48, b_disc_num=48, t_disc_num=32)
WEIGHT = (1.0, 10.0, 10.0)
R_RTOL, G_RTOL = 1e-5, 1e-4      # r: f32 q-sums; grads: sums over ~4.4M points
VJ_FWD_RTOL, VJ_RTOL = 1e-5, 1e-4  # K5 forward; K5 backward and K6 (longer f32 chains)
LM = dict(steps=2, cg_iters=20, k_chunks=16)


def log(phase, **nums):
    print(f"[{phase}] " + "  ".join(f"{k}={v}" for k, v in nums.items()), flush=True)


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: chip_smoke needs an NVIDIA GPU")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0],
        flush=True)
    log("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)


def phase_build():
    from varnet_tpu_torch.ops import build

    t0 = time.perf_counter()
    lib = build.load_library()
    secs = time.perf_counter() - t0
    for line in (build.build_dir() / "build.log").read_text().splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)
    log("build", seconds=f"{secs:.3f}", nvcc_seconds=f"{build.load_library.build_seconds:.3f}",
        sources=len(build.sources()), library=lib._name)


def _median_ms(fn, n=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def phase_kernels(widths, seed=0):
    """Kernel vs plain at the bench mesh for one width; returns the numbers."""
    import torch

    from varnet_tpu_torch.fem.assembly import build_fixed_data
    from varnet_tpu_torch.models.mlp import init_mlp, make_input_scaling
    from varnet_tpu_torch.ops import fused_residual as fr
    from varnet_tpu_torch.problems.analytic import transient_ad_2d

    torch.backends.cuda.matmul.allow_tf32 = False
    fd = build_fixed_data(transient_ad_2d()["pde"], BENCH["disc_num"],
                          b_disc_num=BENCH["b_disc_num"], t_disc_num=BENCH["t_disc_num"])
    st = fd.static
    scale, shift = make_input_scaling(st.input_lo, st.input_hi)
    data = fr.prepare_residual_data(fd.quad, scale, shift, time_dependent=True,
                                    has_react=False, device="cuda")
    gen = torch.Generator().manual_seed(seed)
    params = init_mlp(gen, st.n_inputs, widths, device="cuda")
    for layer in params:
        layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=gen).cuda()
    gr = torch.randn(data.k, generator=gen).cuda()

    r_k = fr.dir_residual_fwd(params, data, "tanh")
    r_p = fr.dir_residual_fwd_plain(params, data, "tanh")
    g_k = fr.dir_residual_bwd(params, data, "tanh", gr)
    g_p = fr.dir_residual_bwd_plain(params, data, "tanh", gr)
    torch.cuda.synchronize()
    r_err = _rel_err(r_k, r_p)
    g_err = max(_rel_err(a[k], b[k]) for a, b in zip(g_k, g_p) for k in ("w", "b"))
    r_abs = float((r_k - r_p).abs().max())
    g_abs = max(float((a[k] - b[k]).abs().max()) for a, b in zip(g_k, g_p) for k in ("w", "b"))
    if not (np.isfinite(r_err) and r_err <= R_RTOL):
        raise AssertionError(f"width {widths}: kernel r differs from plain by {r_err:.3e}")
    if not (np.isfinite(g_err) and g_err <= G_RTOL):
        raise AssertionError(f"width {widths}: kernel grads differ from plain by {g_err:.3e}")

    out = {
        "points": data.k * data.nq, "k": data.k,
        "r_rel_err": r_err, "g_rel_err": g_err, "r_abs_err": r_abs, "g_abs_err": g_abs,
        "fwd_ms": _median_ms(lambda: fr.dir_residual_fwd(params, data, "tanh")),
        "fwd_plain_ms": _median_ms(lambda: fr.dir_residual_fwd_plain(params, data, "tanh")),
        "bwd_ms": _median_ms(lambda: fr.dir_residual_bwd(params, data, "tanh", gr)),
        "bwd_plain_ms": _median_ms(
            lambda: fr.dir_residual_bwd_plain(params, data, "tanh", gr)),
    }
    log(f"kernels w{'x'.join(map(str, widths))}",
        **{k: f"{v:.4g}" for k, v in out.items()})
    return out


def _train(widths, theta, epochs, save_freq, fused):
    """Adam at the bench mesh: through K1/K2 (fused) or the plain general path
    (no fused residual, no value+jac kernel)."""
    import torch

    from varnet_tpu_torch import VarNet
    from varnet_tpu_torch.problems.analytic import transient_ad_2d

    vn = VarNet(transient_ad_2d()["pde"], layer_width=widths, device="cuda",
                use_fused_residual=fused, use_pallas=fused, **BENCH)
    if theta is not None:
        vn.theta = [{k: v.clone() for k, v in layer.items()} for layer in theta]
    res = vn.train(epoch_num=epochs, weight=WEIGHT, save_freq=save_freq, verbose=False)
    torch.cuda.synchronize()
    return vn, res


def phase_train():
    """The main path: 200 Adam epochs at the bench shape through the kernel."""
    from varnet_tpu_torch.ops import fused_residual as fr

    _, first = _train((20, 20), None, 1, 1, True)     # the initial loss (seed 0)
    fr.dir_residual_fwd.launches = fr.dir_residual_bwd.launches = 0
    vn, res = _train((20, 20), None, 200, 100, True)
    launches = {"fwd": fr.dir_residual_fwd.launches, "bwd": fr.dir_residual_bwd.launches}
    loss0, loss_end = first.losses[0]["loss"], res.losses[-1]["loss"]
    if min(launches.values()) < 200:
        raise AssertionError(f"kernel launches {launches} < 1 per epoch over 200 epochs")
    if not (np.isfinite(loss_end) and loss_end < loss0):
        raise AssertionError(f"loss did not fall: {loss0} -> {loss_end}")
    log("train kernel", epochs=200, fwd_launches=launches["fwd"],
        bwd_launches=launches["bwd"], loss_start=f"{loss0:.6e}", loss_end=f"{loss_end:.6e}",
        rel_l2=f"{res.errors[-1]:.4e}", quad_evals_per_sec=f"{res.quad_evals_per_sec:.6e}",
        steps_per_sec=f"{res.steps_per_sec:.4f}")
    _, plain = _train((20, 20), None, 200, 100, False)
    log("train plain", epochs=200, loss_end=f"{plain.losses[-1]['loss']:.6e}",
        quad_evals_per_sec=f"{plain.quad_evals_per_sec:.6e}",
        steps_per_sec=f"{plain.steps_per_sec:.4f}")

    # 20 epochs on each path from the same theta: the trajectories agree
    theta = vn.theta
    _, rk = _train((20, 20), theta, 20, 1, True)
    _, rp = _train((20, 20), theta, 20, 1, False)
    lk = np.array([r["loss"] for r in rk.losses])
    lp = np.array([r["loss"] for r in rp.losses])
    worst = float(np.max(np.abs(lk - lp) / np.abs(lp)))
    if not worst <= 2e-4:
        raise AssertionError(f"kernel vs plain 20-epoch trajectories differ by {worst:.3e}")
    log("train 20-epoch kernel vs plain", max_rel_diff=f"{worst:.3e}",
        loss_end_kernel=f"{lk[-1]:.6e}", loss_end_plain=f"{lp[-1]:.6e}")
    return launches


def phase_accuracy():
    """The pinned flagship theta: rel-L2 below its pin, kernel loss == plain loss."""
    from varnet_tpu_torch import VarNet, load_theta_npz, params_from_jax
    from varnet_tpu_torch.problems.analytic import transient_ad_2d

    theta = params_from_jax(load_theta_npz(PINNED), device="cuda")
    vn = VarNet(transient_ad_2d()["pde"], layer_width=(48, 48, 48), device="cuda", **BENCH)
    err = vn.compute_error(theta, disc=96, n_times=7)
    if not err < 1.25e-4:
        raise AssertionError(f"pinned theta re-scores {err:.4e} >= 1.25e-4")
    _, rk = _train((48, 48, 48), theta, 1, 1, True)
    _, rp = _train((48, 48, 48), theta, 1, 1, False)
    lk, lp = rk.losses[0]["loss"], rp.losses[0]["loss"]
    if not abs(lk - lp) <= 1e-4 * abs(lp):
        raise AssertionError(f"pinned-theta loss: kernel {lk} vs plain {lp}")
    log("accuracy", rel_l2=f"{err:.6e}", loss_kernel=f"{lk:.8e}", loss_plain=f"{lp:.8e}",
        rel_diff=f"{abs(lk - lp) / abs(lp):.3e}")


def _bench_points():
    """Scaled quadrature coordinates xs_t [n_in, P] of the bench mesh (CUDA),
    P = K * nq, and nq."""
    import torch

    from varnet_tpu_torch.fem.assembly import build_fixed_data
    from varnet_tpu_torch.models.mlp import make_input_scaling
    from varnet_tpu_torch.problems.analytic import transient_ad_2d

    fd = build_fixed_data(transient_ad_2d()["pde"], BENCH["disc_num"],
                          b_disc_num=BENCH["b_disc_num"], t_disc_num=BENCH["t_disc_num"])
    scale, shift = make_input_scaling(fd.static.input_lo, fd.static.input_hi, device="cuda")
    coords = torch.from_numpy(np.array(fd.quad.coords, dtype=np.float32)).cuda()
    xs_t = ((coords.reshape(-1, coords.shape[-1]) - shift) * scale).T.contiguous()
    return xs_t, coords.shape[1]


def _vj_compare(params, xs_t, seed, label, timed):
    """K5 forward / backward and K6 against their plain versions on xs_t."""
    import torch

    from varnet_tpu_torch.ops import value_and_jac as vj

    gen = torch.Generator().manual_seed(seed)
    g = torch.randn(xs_t.shape[0] + 1, xs_t.shape[1], generator=gen).cuda()
    tangent = [{k: torch.randn(v.shape, generator=gen).cuda() for k, v in layer.items()}
               for layer in params]
    checks = {
        "fwd": (lambda: vj.vj_fwd(params, xs_t, "tanh"),
                lambda: vj.vj_fwd_plain(params, xs_t, "tanh"), VJ_FWD_RTOL),
        "bwd": (lambda: vj._leaves(vj.vj_bwd(params, xs_t, "tanh", g)),
                lambda: vj._leaves(vj.vj_bwd_plain(params, xs_t, "tanh", g)), VJ_RTOL),
        "jvp": (lambda: vj.vj_jvp(params, xs_t, "tanh", tangent),
                lambda: vj.vj_jvp_plain(params, xs_t, "tanh", tangent), VJ_RTOL),
    }
    out = {}
    for name, (kernel, plain, rtol) in checks.items():
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        # per parameter leaf (bwd) or per output row (u, then each du/dxs_j)
        rel = max(_rel_err(a, b) for a, b in zip(got, ref))
        abs_err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        if not (np.isfinite(rel) and rel <= rtol):
            raise AssertionError(f"{label}: vj_{name} differs from plain by {rel:.3e} > {rtol}")
        out[name] = {"rel_err": rel, "abs_err": abs_err}
        if timed:
            out[name]["ms"] = _median_ms(kernel)
            out[name]["plain_ms"] = _median_ms(plain)
        del got, ref
        torch.cuda.empty_cache()
    log(label, points=xs_t.shape[1], **{f"{k}_{m}": f"{v:.4g}" for k, d in out.items()
                                        for m, v in d.items()})
    return out


def phase_kernels_vj(widths, xs_t, seed=0):
    """K5 / K6 kernels vs plain at the bench mesh for one width."""
    import torch

    from varnet_tpu_torch.models.mlp import init_mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(seed)
    params = init_mlp(gen, xs_t.shape[0], widths, device="cuda")
    for layer in params:
        layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=gen).cuda()
    return _vj_compare(params, xs_t, seed + 1, f"kernels-vj w{'x'.join(map(str, widths))}",
                       timed=True)


def _lm(theta, use_pallas):
    import torch

    from varnet_tpu_torch import VarNet
    from varnet_tpu_torch.problems.analytic import transient_ad_2d

    vn = VarNet(transient_ad_2d()["pde"], layer_width=(48, 48, 48), device="cuda",
                use_pallas=use_pallas, **BENCH)
    vn.theta = [{k: v.clone() for k, v in layer.items()} for layer in theta]
    t0 = time.perf_counter()
    res = vn.refine_lm(weight=WEIGHT, save_freq=1, verbose=False, error_disc=96,
                       error_times=7, **LM)
    torch.cuda.synchronize()
    return vn, res, time.perf_counter() - t0


def phase_lm(xs_t, nq):
    """The main path's LM stage from the flagship 8.3e-4 theta, kernel and plain."""
    import torch

    from varnet_tpu_torch import load_theta_npz, params_from_jax
    from varnet_tpu_torch.fem.assembly import pad_points, pad_quad
    from varnet_tpu_torch.ops import value_and_jac as vj
    from varnet_tpu_torch.train.gauss_newton import make_residual_fn

    theta = params_from_jax(load_theta_npz(LM_START), device="cuda")
    # the chunk shape the LM gives the kernels (K padded to a multiple of k_chunks)
    kc = -(-(xs_t.shape[1] // nq) // LM["k_chunks"])
    _vj_compare(theta, xs_t[:, :kc * nq].contiguous(), 7, "lm chunk-shape kernels", False)

    vj.vj_fwd.launches = vj.vj_bwd.launches = vj.vj_jvp.launches = 0
    vn, rk, secs_k = _lm(theta, True)
    launches = {"vj_fwd": vj.vj_fwd.launches, "vj_bwd": vj.vj_bwd.launches,
                "vj_jvp": vj.vj_jvp.launches}
    _, rp, secs_p = _lm(theta, False)

    # the loss at the start (sum r^2 of the LM residual, plain path)
    quad = vn._to_device(pad_quad(vn.fixed.quad, LM["k_chunks"]))
    res_fn = make_residual_fn(vn.static, k_chunks=LM["k_chunks"], device="cuda")
    with torch.no_grad():
        r0 = res_fn(theta, quad, vn._to_device(pad_points(vn.fixed.bc, 1)),
                    vn._to_device(pad_points(vn.fixed.ic, 1)), list(WEIGHT) + [0.0])
    loss0 = float(torch.dot(r0, r0))
    lk = np.array([r["loss"] for r in rk.losses])
    lp = np.array([r["loss"] for r in rp.losses])
    need = LM["steps"] * LM["cg_iters"]
    if min(launches.values()) < need:
        raise AssertionError(f"LM kernel launches {launches} < steps x cg_iters = {need}")
    # the start loss is re-evaluated on the plain path: allow its f32 rounding
    if not (np.all(np.isfinite(lk)) and lk[0] <= loss0 * (1 + 1e-5)
            and np.all(np.diff(lk) <= 0)):
        raise AssertionError(f"LM loss rose: start {loss0} -> {lk.tolist()}")
    worst = float(np.max(np.abs(lk - lp) / np.abs(lp)))
    if not worst <= 2e-2:
        raise AssertionError(f"LM kernel vs plain losses differ by {worst:.3e}: {lk} vs {lp}")
    err = rk.errors[-1]
    if not 6e-4 < err < 1e-3:
        raise AssertionError(f"LM final rel-L2 {err:.4e} outside (6e-4, 1e-3)")
    per_it = {"kernel": (rk.wall_times[-1] - rk.wall_times[0]) / (LM["steps"] - 1),
              "plain": (rp.wall_times[-1] - rp.wall_times[0]) / (LM["steps"] - 1)}
    log("lm kernel", **LM, loss_start=f"{loss0:.6e}",
        losses=",".join(f"{v:.6e}" for v in lk),
        lams=",".join(f"{r['lam']:.3g}" for r in rk.losses), rel_l2=f"{err:.6e}",
        s_per_iter=f"{per_it['kernel']:.4f}", call_seconds=f"{secs_k:.3f}", **launches)
    log("lm plain", losses=",".join(f"{v:.6e}" for v in lp),
        rel_l2=f"{rp.errors[-1]:.6e}", s_per_iter=f"{per_it['plain']:.4f}",
        call_seconds=f"{secs_p:.3f}", max_rel_diff=f"{worst:.3e}")
    return launches

# ---------------------------------------------------------------------------
# The Fourier-feature contaminant slice (K2-FF, K7, K8)

CONT_FULL = dict(disc_num=64, b_disc_num=64, t_disc_num=40)   # P = 9,906,624 points
CONT_SMALL = dict(disc_num=16, b_disc_num=16, t_disc_num=10)  # kernel-vs-plain runs
CONT_NET = dict(layer_width=(96, 96, 96), input_scaling=False)
CONT_THETA = os.path.join(ROOT, "benchmarks", "results", "theta_contaminant_causal.npz")
CONT_FDM = os.path.join(ROOT, "benchmarks", "data", "contaminant_fdm.npz")
CAUSAL = dict(windows=(0.25, 0.5, 0.75, 1.0), epochs=8, lr=2e-3)
LM_FF = dict(steps=2, cg_iters=10, k_chunks=16, cg_segment=50)
# K2-FF r, relative to max |r|: the raw-input angles reach ~76 rad and carry ~5e-6 rad of
# f32 rounding in either sum, and at the pinned optimum r is a small difference of large
# terms (1.975e-5 measured on an H100 against the plain version)
FF_R_RTOL = 5e-5
FF_RTOL = 1e-4     # gradients, K7 / K8 rows: longer f32 chains over the same angles


def _contaminant(mesh, t_final=1.0, **kw):
    from varnet_tpu_torch import VarNet
    from varnet_tpu_torch.problems.analytic import contaminant_transport_2d
    from varnet_tpu_torch.utils.io import CONTAMINANT_CAUSAL_FOURIER_B

    return VarNet(contaminant_transport_2d(t_final=t_final)["pde"], device="cuda",
                  fourier_b=np.load(CONTAMINANT_CAUSAL_FOURIER_B), **CONT_NET, **mesh, **kw)


def _pinned_ff():
    from varnet_tpu_torch import load_theta_npz, params_from_jax

    return params_from_jax(load_theta_npz(CONT_THETA), device="cuda")


def _fdm_rel_l2(vn, theta):
    """rel-L2 of ``vn.evaluate`` against the CN-FDM field, t > 0 slices
    (the metric of benchmarks/fdm_scoring.py)."""
    from varnet_tpu_torch.utils.helpers import rel_l2_error

    z = np.load(CONT_FDM)
    x = z["x"].astype(np.float64)
    preds, trues = [], []
    for s, tval in enumerate(z["times"]):
        if tval <= 0:
            continue
        preds.append(vn.evaluate(x, t=np.full(x.shape[0], tval), theta=theta))
        trues.append(z["u"][s].astype(np.float64))
    return rel_l2_error(np.concatenate(preds), np.concatenate(trues))


def _chunk(data, k0, k1):
    """Test functions k0 .. k1 - 1 of a ResidualData."""
    a, b = k0 * data.nq, k1 * data.nq
    return data._replace(xs=data.xs[:, a:b].contiguous(), flds=data.flds[:, a:b].contiguous(),
                         k=k1 - k0)


def phase_kernels_ff():
    """K2-FF (fwd, bwd) at the full mesh against its plain version run chunk by
    chunk over the same mesh; K7 (fwd, bwd) and K8 on the first LM chunk of test
    functions against theirs.  Kernel and plain timed at the same shape."""
    import torch

    from varnet_tpu_torch.ops import fused_residual as fr
    from varnet_tpu_torch.ops import value_and_jac as vj

    torch.backends.cuda.matmul.allow_tf32 = False
    vn = _contaminant(CONT_FULL)
    theta = _pinned_ff()
    data = fr.prepare_residual_data(vn._to_device(vn.fixed.quad), None, None,
                                    time_dependent=True, has_react=vn.has_react,
                                    device="cuda", fourier_bt=vn.fourier_bt)
    kc = -(-data.k // LM_FF["k_chunks"])
    bounds = [(k0, min(k0 + kc, data.k)) for k0 in range(0, data.k, kc)]
    chunks = [_chunk(data, *kb) for kb in bounds]
    part = chunks[0]
    bt = vn.fourier_bt
    gen = torch.Generator().manual_seed(11)
    gr = torch.randn(data.k, generator=gen).cuda()
    n = part.xs.shape[1]
    g = torch.randn((4, n), generator=gen).cuda()
    tangent = [{k: torch.randn(v.shape, generator=gen).cuda() for k, v in layer.items()}
               for layer in theta]
    leaves = vj._leaves

    def res_fwd_plain():
        # r is one number per test function: the chunks' r concatenate
        return [torch.cat([fr.dir_residual_fwd_plain(theta, c, "tanh") for c in chunks])]

    def res_bwd_plain():
        # the gradient of <gr, r> is the sum of the chunks' gradients
        total = None
        for c, (k0, k1) in zip(chunks, bounds):
            part_g = leaves(fr.dir_residual_bwd_plain(theta, c, "tanh", gr[k0:k1]))
            total = part_g if total is None else [a + b for a, b in zip(total, part_g)]
        return total

    checks = {
        "ff_res_fwd": (lambda: [fr.dir_residual_ff_fwd(theta, data, "tanh")], res_fwd_plain,
                       FF_R_RTOL),
        "ff_res_bwd": (lambda: leaves(fr.dir_residual_ff_bwd(theta, data, "tanh", gr)),
                       res_bwd_plain, FF_RTOL),
        "ff_vj_fwd": (lambda: list(vj.ff_vj_fwd(theta, part.xs, bt, "tanh")),
                      lambda: list(vj.ff_vj_fwd_plain(theta, part.xs, bt, "tanh")), FF_RTOL),
        "ff_vj_bwd": (lambda: leaves(vj.ff_vj_bwd(theta, part.xs, bt, "tanh", g)),
                      lambda: leaves(vj.ff_vj_bwd_plain(theta, part.xs, bt, "tanh", g)),
                      FF_RTOL),
        "ff_vj_jvp": (lambda: list(vj.ff_vj_jvp(theta, part.xs, bt, "tanh", tangent)),
                      lambda: list(vj.ff_vj_jvp_plain(theta, part.xs, bt, "tanh", tangent)),
                      FF_RTOL),
    }
    out = {}
    for name, (kernel, plain, rtol) in checks.items():
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        # per output row (K7 / K8: u, then each du/dxs_j) or parameter leaf
        rel = max(_rel_err(a, b) for a, b in zip(got, ref))
        abs_err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        if not (np.isfinite(rel) and rel <= rtol):
            raise AssertionError(f"{name} differs from plain by {rel:.3e} > {rtol}")
        del got, ref
        torch.cuda.empty_cache()
        out[name] = {"rel_err": rel, "abs_err": abs_err,
                     "ms": _median_ms(kernel, n=5, warmup=1),
                     "plain_ms": _median_ms(plain, n=3, warmup=1)}
        torch.cuda.empty_cache()
    log("kernels-ff", points=data.k * data.nq, chunk_points=n,
        **{f"{k}_{m}": f"{v:.4g}" for k, d in out.items() for m, v in d.items()})
    return out, data.k * data.nq, data.k, n


def phase_causal():
    """The main path of the slice: ``train_causal`` over four windows at the
    full mesh and width on the kernel path (K2-FF), then 20 epochs kernel vs
    plain at the reduced mesh from the seeded initial net."""
    import torch

    from varnet_tpu_torch.ops import fused_residual as fr
    from varnet_tpu_torch.problems.analytic import contaminant_transport_2d
    from varnet_tpu_torch.train.causal import train_causal
    from varnet_tpu_torch.train.optim import OptimizerConfig
    from varnet_tpu_torch.utils.io import CONTAMINANT_CAUSAL_FOURIER_B

    epochs = CAUSAL["epochs"]
    kw = dict(CONT_NET, disc_num=CONT_FULL["disc_num"], b_disc_num=CONT_FULL["b_disc_num"],
              device="cuda", fourier_b=np.load(CONTAMINANT_CAUSAL_FOURIER_B),
              optimizer=OptimizerConfig(lr=CAUSAL["lr"], decay_rate=0.4,
                                        decay_steps=max(epochs // 4, 1)))
    fr.dir_residual_ff_fwd.launches = fr.dir_residual_ff_bwd.launches = 0
    t0 = time.perf_counter()
    vn, stages = train_causal(
        lambda t_end: contaminant_transport_2d(t_final=t_end)["pde"],
        windows=CAUSAL["windows"], epoch_num=epochs, weight=WEIGHT,
        t_disc_full=CONT_FULL["t_disc_num"], varnet_kwargs=kw,
        train_kwargs=dict(save_freq=1), verbose=False)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"fwd": fr.dir_residual_ff_fwd.launches, "bwd": fr.dir_residual_ff_bwd.launches}
    need = epochs * len(CAUSAL["windows"])
    if min(launches.values()) < need:
        raise AssertionError(f"K2-FF launches {launches} < 1 per epoch per window ({need})")
    for st in stages:
        # each stage starts a fresh Adam state, whose first step (lr x sign of the
        # gradient on every weight) kicks a warm-started loss up (0.133 -> 1.73 at
        # window 1.0 on an H100), as in the JAX recipe; the loss must fall from there
        losses = [r["loss"] for r in st["result"].losses]
        if not (np.all(np.isfinite(losses)) and losses[-1] < losses[1]):
            raise AssertionError(f"window {st['t_end']}: loss did not fall: {losses}")
    log("causal kernel", windows=",".join(f"{w:g}" for w in CAUSAL["windows"]),
        epochs_per_window=epochs, points_full=vn.static.n_test * vn.static.n_quad_per_test,
        losses=",".join(f"{st['result'].losses[0]['loss']:.4e}->{st['final_loss']:.4e}"
                        for st in stages),
        steps_per_sec=",".join(f"{st['result'].steps_per_sec:.4f}" for st in stages),
        seconds=f"{secs:.3f}", ff_res_fwd=launches["fwd"], ff_res_bwd=launches["bwd"])

    # from the seeded initial net (both paths draw the same one): near the pinned
    # optimum the gradients are small, and Adam's normalisation amplifies the f32
    # differences of the two sums into different steps
    runs = {}
    for fused in (True, False):
        vk = _contaminant(CONT_SMALL, use_fused_residual=fused, use_pallas=fused,
                          optimizer=OptimizerConfig(lr=CAUSAL["lr"]))
        runs[fused] = np.array([r["loss"] for r in vk.train(
            epoch_num=20, weight=WEIGHT, save_freq=1, verbose=False).losses])
    worst = float(np.max(np.abs(runs[True] - runs[False]) / np.abs(runs[False])))
    if not worst <= 2e-4:
        raise AssertionError(f"FF kernel vs plain 20-epoch trajectories differ by {worst:.3e}")
    log("causal 20-epoch kernel vs plain", mesh="d16/t10", max_rel_diff=f"{worst:.3e}",
        loss_end_kernel=f"{runs[True][-1]:.6e}", loss_end_plain=f"{runs[False][-1]:.6e}")
    return launches


def phase_contaminant_accuracy():
    """The pinned theta re-scores below 2.0% against the FDM field on the card,
    and the kernel-path loss equals the plain-path loss there (reduced mesh)."""
    from varnet_tpu_torch.train.optim import OptimizerConfig

    theta = _pinned_ff()
    err = _fdm_rel_l2(_contaminant(CONT_SMALL), theta)
    if not err < 0.02:
        raise AssertionError(f"pinned contaminant theta re-scores {err:.4e} >= 2.0e-2")
    loss = {}
    for fused in (True, False):
        vn = _contaminant(CONT_SMALL, use_fused_residual=fused, use_pallas=fused,
                          optimizer=OptimizerConfig(lr=0.0))
        vn.theta = theta
        loss[fused] = vn.train(epoch_num=1, weight=WEIGHT, save_freq=1,
                               verbose=False).losses[0]["loss"]
    rel = abs(loss[True] - loss[False]) / abs(loss[False])
    if not rel <= 1e-4:
        raise AssertionError(f"pinned contaminant loss: kernel {loss[True]} vs plain {loss[False]}")
    log("contaminant-accuracy", fdm_rel_l2=f"{err:.6e}", loss_kernel=f"{loss[True]:.8e}",
        loss_plain=f"{loss[False]:.8e}", rel_diff=f"{rel:.3e}")


def _lm_ff(mesh, use_pallas, theta):
    import torch

    vn = _contaminant(mesh, use_pallas=use_pallas)
    vn.theta = [{k: v.clone() for k, v in layer.items()} for layer in theta]
    with torch.no_grad():
        start = _lm_loss(vn, theta)
    t0 = time.perf_counter()
    res = vn.refine_lm(weight=WEIGHT, save_freq=1, verbose=False, **LM_FF)
    torch.cuda.synchronize()
    return vn, res, start, time.perf_counter() - t0


def _lm_loss(vn, theta):
    """sum r^2 of the LM residual at theta (plain path)."""
    import torch

    from varnet_tpu_torch.fem.assembly import pad_points, pad_quad
    from varnet_tpu_torch.train.gauss_newton import make_residual_fn

    res_fn = make_residual_fn(vn.static, k_chunks=LM_FF["k_chunks"], device="cuda",
                              has_react=vn.has_react, input_scaling=False,
                              apply_fn=vn._apply_fn(),
                              value_and_jac=vn._value_and_jac(False))
    r = res_fn(theta, vn._to_device(pad_quad(vn.fixed.quad, LM_FF["k_chunks"])),
               vn._to_device(pad_points(vn.fixed.bc, 1)), vn._to_device(pad_points(vn.fixed.ic, 1)),
               list(WEIGHT) + [0.0])
    return float(torch.dot(r, r))


def phase_lm_ff():
    """``refine_lm`` from the pinned theta at the full mesh on the kernel path
    (K7 / K8); the kernel-vs-plain comparison at the reduced mesh."""
    from varnet_tpu_torch.ops import value_and_jac as vj

    theta = _pinned_ff()
    vj.ff_vj_fwd.launches = vj.ff_vj_bwd.launches = vj.ff_vj_jvp.launches = 0
    vn, rk, start, secs = _lm_ff(CONT_FULL, True, theta)
    launches = {"ff_vj_fwd": vj.ff_vj_fwd.launches, "ff_vj_bwd": vj.ff_vj_bwd.launches,
                "ff_vj_jvp": vj.ff_vj_jvp.launches}
    need = LM_FF["steps"] * LM_FF["cg_iters"]
    if min(launches.values()) < need:
        raise AssertionError(f"K7/K8 launches {launches} < steps x cg_iters = {need}")
    lk = np.array([r["loss"] for r in rk.losses])
    # the start loss is evaluated on the plain path: allow its f32 rounding
    if not (np.all(np.isfinite(lk)) and lk[0] <= start * (1 + 1e-5) and np.all(np.diff(lk) <= 0)):
        raise AssertionError(f"LM loss rose: start {start} -> {lk.tolist()}")
    err = _fdm_rel_l2(vn, None)
    if not err < 0.02:
        raise AssertionError(f"LM-refined contaminant theta re-scores {err:.4e} >= 2.0e-2")
    per_it = (rk.wall_times[-1] - rk.wall_times[0]) / (LM_FF["steps"] - 1)
    log("lm-ff kernel", mesh="d64/t40", **LM_FF, loss_start=f"{start:.6e}",
        losses=",".join(f"{v:.6e}" for v in lk), fdm_rel_l2=f"{err:.6e}",
        s_per_iter=f"{per_it:.4f}", call_seconds=f"{secs:.3f}", **launches)
    _, sk, _, _ = _lm_ff(CONT_SMALL, True, theta)
    _, sp, _, _ = _lm_ff(CONT_SMALL, False, theta)
    a = np.array([r["loss"] for r in sk.losses])
    b = np.array([r["loss"] for r in sp.losses])
    worst = float(np.max(np.abs(a - b) / np.abs(b)))
    if not worst <= 2e-2:
        raise AssertionError(f"FF LM kernel vs plain losses differ by {worst:.3e}: {a} vs {b}")
    log("lm-ff kernel vs plain", mesh="d16/t10", losses_kernel=",".join(f"{v:.6e}" for v in a),
        losses_plain=",".join(f"{v:.6e}" for v in b), max_rel_diff=f"{worst:.3e}")
    return launches


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a kernel's work

PEAK_F32 = 67e12   # FLOP/s, f32 outside the tensor cores (H100 SXM data sheet)
HBM = 3.35e12      # bytes/s


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32, nbytes / HBM
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _flops(kind, widths, k0, panels, points):
    """FLOPs of the layer products (2 per multiply-add) over ``points`` for a
    net with layer-0 input width k0 and hidden widths ``widths``, pushing
    ``panels`` panels: the forward; the backward = recompute + weight gradients
    + the cotangents of the hidden layers; the JVP = W s, W ds and dW s at the
    hidden and output layers, W s and dW s at layer 0 (its input has no
    tangent: the points and B are fixed).  The activations and the embedding's
    sin / cos are not counted."""
    hidden = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    first, rest = 2 * panels * k0 * widths[0], 2 * panels * (hidden + widths[-1])
    fwd = first + rest
    return points * {"fwd": fwd, "bwd": 2 * fwd + 2 * panels * hidden,
                     "jvp": 2 * first + 3 * rest}[kind]


def _n_params(widths, k0):
    sizes = [k0] + list(widths) + [1]
    return sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))


def _bounds(kind, widths, k0, panels, points, n_in, n_k=None, n_fields=4):
    """Bound of one kernel: a residual kernel (n_k test functions; reads the
    coordinates and n_fields field rows, writes r or reads its cotangent) or
    a value+jac kernel (reads the coordinates, writes or reads 1 + n_in rows);
    each reads the parameters once (the JVP their tangent too) and the
    backward writes the gradient."""
    params = 4 * _n_params(widths, k0)
    if n_k is not None:
        nbytes = 4 * points * (n_in + n_fields) + 4 * n_k + params * (2 if kind == "bwd" else 1)
    else:
        rows = 0 if kind == "bwd" else 1 + n_in
        nbytes = 4 * points * (n_in + rows + (1 + n_in if kind == "bwd" else 0))
        nbytes += params * 2
    return _bound(_flops(kind, widths, k0, panels, points), nbytes)


def _entry(name, source, replaces, launches, nums, bound):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": nums["abs_err"], "ms": nums["ms"],
            "plain_ms": nums["plain_ms"], **bound, "library_ms": None}


def main():
    import torch

    phase_device()
    phase_build()
    k20 = phase_kernels((20, 20))
    phase_kernels((48, 48, 48))
    launches = phase_train()
    phase_accuracy()
    xs_t, nq = _bench_points()
    phase_kernels_vj((20, 20), xs_t)
    v48 = phase_kernels_vj((48, 48, 48), xs_t)
    lm_launches = phase_lm(xs_t, nq)
    del xs_t
    torch.cuda.empty_cache()
    ff, p_ff, k_ff, p_chunk = phase_kernels_ff()
    ff_launches = phase_causal()
    phase_contaminant_accuracy()
    lm_ff_launches = phase_lm_ff()

    p_bench, k_bench = k20["points"], k20["k"]
    src = "varnet_tpu_torch/csrc/"
    res_py, mlp_py = "varnet_tpu/ops/pallas_residual.py", "varnet_tpu/ops/pallas_mlp.py"
    ff_net = dict(widths=(96, 96, 96), k0=256, n_in=3)
    kernels = [
        _entry("dir_residual_fwd", src + "dir_residual.cu", res_py + ":788", launches["fwd"],
               {"abs_err": k20["r_abs_err"], "ms": k20["fwd_ms"], "plain_ms": k20["fwd_plain_ms"]},
               _bounds("fwd", (20, 20), 3, 2, p_bench, 3, n_k=k_bench)),
        _entry("dir_residual_bwd", src + "dir_residual.cu", res_py + ":820", launches["bwd"],
               {"abs_err": k20["g_abs_err"], "ms": k20["bwd_ms"], "plain_ms": k20["bwd_plain_ms"]},
               _bounds("bwd", (20, 20), 3, 2, p_bench, 3, n_k=k_bench)),
    ] + [
        _entry(f"vj_{k}", src + "value_and_jac.cu", mlp_py + line, lm_launches[f"vj_{k}"],
               v48[k], _bounds(kind, (48, 48, 48), 3, 4, p_bench, 3))
        for k, line, kind in (("fwd", ":266", "fwd"), ("bwd", ":825", "bwd"),
                              ("jvp", ":508", "jvp"))
    ] + [
        _entry("dir_residual_ff_fwd", src + "ff_mlp.cu", res_py + ":611", ff_launches["fwd"],
               ff["ff_res_fwd"], _bounds("fwd", panels=2, points=p_ff, n_k=k_ff, **ff_net)),
        _entry("dir_residual_ff_bwd", src + "ff_mlp.cu", res_py + ":611", ff_launches["bwd"],
               ff["ff_res_bwd"], _bounds("bwd", panels=2, points=p_ff, n_k=k_ff, **ff_net)),
        _entry("ff_vj_fwd", src + "ff_mlp.cu", mlp_py + ":872", lm_ff_launches["ff_vj_fwd"],
               ff["ff_vj_fwd"], _bounds("fwd", panels=4, points=p_chunk, **ff_net)),
        _entry("ff_vj_bwd", src + "ff_mlp.cu", mlp_py + ":896", lm_ff_launches["ff_vj_bwd"],
               ff["ff_vj_bwd"], _bounds("bwd", panels=4, points=p_chunk, **ff_net)),
        _entry("ff_vj_jvp", src + "ff_mlp.cu", mlp_py + ":532", lm_ff_launches["ff_vj_jvp"],
               ff["ff_vj_jvp"], _bounds("jvp", panels=4, points=p_chunk, **ff_net)),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
