#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``varnet_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:  ``python3 chip_smoke.py``.

Phases (each prints one line of numbers; any failure raises, so the exit code
is non-zero and no result line is printed):

1. device   -- requires CUDA (no CPU fallback); prints the card's name and power limit.
2. build    -- builds every kernel of ``varnet_tpu_torch/csrc`` (one nvcc per source,
               started together, linked into one library); prints ptxas' report.
3. kernels  -- at the bench shape (transient 2-D AD, disc 48 / t_disc 32, width
               (20, 20)) and at widths (48, 48) and (48, 48, 48): the kernel's forward r and
               backward gradients against the plain PyTorch version on the same
               inputs, and the time per call of each (CUDA events, median of 20).
               Then kernels-nq1296: K1 (table mode, order 1) and K4 (precoeff, exact BC,
               order 2) forward (rtol 1e-5) and backward (rtol 1e-4) against their plain
               versions on the 3-D transient problem with integ_p_num 3 (disc 3 / t_disc
               3, w64x2: 1296 points per test function, 16 and 625 test functions), untimed.
4. train    -- ``VarNet(...).train(200 epochs)`` at the bench shape on the kernel
               path; the launch counters must rise every epoch and the loss fall.
               Then 20 epochs on the kernel path and 20 on the plain path from the
               same theta: the loss trajectories agree within rtol 2e-4.
5. accuracy -- the pinned flagship theta re-scores below 1.25e-4 rel-L2, and the
               kernel-path loss equals the plain-path loss there within rtol 1e-4.
6. kernels-vj -- at the bench mesh (P = 4,382,656 points, n_in 3) for widths (20, 20),
               (48, 48) (the time-to-1e-3 recipe's LM net) and (48, 48, 48): the
               value+jacobian kernels K5 forward (against
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
7b. resume  -- checkpoints and fault recovery on the main path: 40 Adam epochs at the
               bench shape (w20x2, save_freq 20) against 20 epochs in one ``VarNet``
               and a ``resume=True`` to 40 in a fresh one on the same folder, through
               K1/K2 (max |dtheta| printed, must be 0); the save and restore times of a
               checkpoint; Adam steps/s over 300 epochs at save_freq 50 (the exact-BC
               recipe's epochs / 6) without, with, and again without a folder.  LM at
               the lm phase's shape (w48x3, cg 20, k_chunks 16) from the 8.3e-4 theta: 2
               iterations straight against 1 and a resume to 2 (lam from the meta) through
               K5/K6 (|dtheta| must be 0); then a hook makes the first LM attempt ask the
               allocator for twice the card's memory after its first checkpoint, a real
               ``torch.cuda.OutOfMemoryError``: ``refine_lm(max_retries=1)`` resumes from
               ``lm/`` with k_chunks doubled and ends within rtol 2e-2 of the straight
               run's loss.  Last, the ``ad2d_transient`` CLI in a subprocess (disc 16 /
               t_disc 8): 40 epochs with ``--folder``, then ``--epochs 60 --resume``
               ("resumed from epoch 40", ``ckpt_*`` of epochs 20, 40, 60).

8. kernels-ff -- the Fourier-feature kernels at the pinned contaminant net (w96x3 behind
               128 features, scales (0.5, 2.0), committed B and theta, raw inputs) on
               the full contaminant mesh (disc 64 / t_disc 40 / bdisc 64, P =
               9,906,624 points).  K2-FF forward (rtol 5e-5) and backward (rtol 1e-4)
               at the full mesh, the shape Adam gives it, against the plain version run
               over the 16 LM chunks of test functions (r concatenated, gradients
               summed: the plain panels of the whole mesh would not fit the card); the
               same on seeded w128x3 and w256x3 nets (256: the widest the kernels take,
               warp groups of four).  K7 forward and backward and K8 (rtol 1e-4) on the
               first LM chunk (P = 619,200), the shape LM gives them, on the pinned net and
               the seeded w256x3 one.  Kernel and plain timed at the same shape; then the
               launch shape of each (threads, blocks and warps resident per SM).
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

12. hard-tables -- exact BC on the 3-D transient case at the recipe's mesh (disc 16 /
               t_disc 10, w64x2: 30,375 test functions x 256 points, P = 7,776,000,
               n_in 4): the host f64 transform tables, built once for the phases below
               (seconds on their own line).
13. kernels-dirp -- K4 (precoeff residual) forward (rtol 1e-5) and backward (rtol 1e-4)
               against its plain version on that mesh with the hard fold, and at the 2-D
               order-2 mesh (disc 48, integ_p_num 3: per-node tables, 9,025 x 36 points)
               with the hard fold, there at w48x2 and at w96x3 (K4 on ``ff_mlp.cu``, the
               route of a net wider than 64); kernel and plain timed at the same shape.
14. hard-train -- 20 Adam epochs of ``VarNet(hard_bc=True)`` at the 3-D transient mesh
               through K4 (launches rise every epoch, the loss falls); 20 epochs kernel vs
               plain at disc 8 / t_disc 6 (rtol 2e-4); 20 epochs of the order-2 2-D hard
               case through K4; a penalty 2-D net at disc 48 on K1/K2, one
               ``refine_tests`` round, then epochs on K4; 20 epochs of the order-2 2-D
               hard case at w96x3 through K4 on ``ff_mlp.cu``.
15. hard-accuracy -- the pinned hard-BC thetas re-score on the card: 3-D transient
               < 3e-4, 2-D steady < 4.0e-5, 1-D transient < 5e-6.
16. hard-lm -- 2 LM iterations (cg 10, k_chunks 16) from ``theta_hardbc_3dt.npz`` at the
               3-D transient mesh on K5 / K6: launches rise by >= steps x cg_iters, the
               loss does not rise, rel-L2 stays < 3e-4.  Kernel vs plain (rtol 2e-2) at
               disc 8 / t_disc 6.

17. burgers-kernels -- K3 (the jacobian-panel residual, ``ff_mlp.cu``'s jacobian mode)
               at the 2-D Burgers front recipe's mesh (``burgers_accuracy.py --two-d``:
               disc 32 / t_disc 20 / b_disc 32, 18,259 test functions x 64 points, P =
               1,168,576, n_in 3, w32x3, b = (1, 1)): forward (rtol 1e-5) and backward
               (rtol 1e-4) against the plain version on a seeded net; at the pinned theta
               the backward (rtol 1e-4) and the forward against an f64 evaluation of the
               plain version (within 1e-3 of max |r|: there r cancels its terms to ~1e-3,
               and the f32 plain version is itself ~2e-4 of max |r| from f64, both
               printed); then with the nonlinear term off at the flagship bench shape
               (d48/t32, w20x2, the layout of ``fused_directional=False``).  Kernel and
               plain timed at each shape.
18. burgers-train -- the slice's main path: 100 Adam epochs of ``burgers_2d_front(nu=0.1)``
               at that mesh and width (lr 2e-3, weight (1, 10, 10)) through K3: its
               launches rise every epoch, no other residual or value+jac kernel runs, the
               loss falls; steps/s and quad-pt evals/s.  20 epochs kernel vs plain from
               the seeded net (rtol 2e-4); 20 epochs of the 1-D traveling front with exact
               BC (disc 48 / t_disc 32) on the general path through K5, where the loss
               falls; then K5 / K6 against their plain versions at that run's inputs
               (the trained net, n_in 2, the cotangent the hard loss hands K5).
19. burgers-accuracy -- the five pinned Burgers thetas re-score under the bounds of
               ``tests/test_accuracy_pin.py``: traveling front < 1e-4, steady shock <
               8e-4, front_2d < 2e-4, traveling front hard < 2e-6, steady shock hard <
               7e-4.
20. burgers-lm -- K5 / K6 against their plain versions at the pinned front_2d theta on
               one LM chunk of the mesh (the shape LM gives them, seeded cotangent and
               tangent); 2 LM iterations (cg 20, k_chunks 16) from
               ``theta_burgers_front_2d.npz`` at the recipe's mesh on K5 / K6 with the
               nonlinear term: launches rise by >= steps x cg_iters, the loss does not
               rise, rel-L2 stays < 2e-4; the same on the plain path, whose losses agree
               within rtol 2e-2.

Cuts: the contaminant recipe (``benchmarks/contaminant_causal.py``) runs 8000 Adam
epochs per window and 12 LM iterations of cg 150; here 8 epochs per window and 2 LM
iterations of cg 10 (widths, features, mesh and the rest of the recipe are as
published).  The kernel-vs-plain runs use disc 16 / t_disc 10, since the plain
versions' [P, 256] panels at the full mesh would not fit the card.  The flagship
phases keep PR 1 and PR 2's depths.  The exact-BC recipe (``benchmarks/hardbc_tpu.py
--case 3dt``: 24,000 Adam epochs, 50 LM iterations of cg 200) is cut to 20 epochs and
2 LM iterations of cg 10 at its published mesh and width.  The Burgers front_2d
recipe (12,000 Adam epochs, 40 LM iterations of cg 200) is cut to 100 epochs and 2 LM
iterations of cg 20 (k_chunks 16), never in width or mesh.  The bounds (``_bounds``) count the layer products
of each kernel's work at the timed shape.

The line before last is the per-kernel JSON summary; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
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


def _seeded_net(n_in, widths, seed):
    """A seeded random net on the card (biases drawn too) and its generator."""
    import torch

    from varnet_tpu_torch.models.mlp import init_mlp

    gen = torch.Generator().manual_seed(seed)
    params = init_mlp(gen, n_in, widths, device="cuda")
    for layer in params:
        layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=gen).cuda()
    return params, gen


def _rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _bench_data(jacobian=False):
    """The fused residual's data at the bench mesh (CUDA): the directional
    layout, or the jacobian-panel one (K3, ``fused_directional=False``)."""
    from varnet_tpu_torch.fem.assembly import build_fixed_data
    from varnet_tpu_torch.models.mlp import make_input_scaling
    from varnet_tpu_torch.ops import fused_residual as fr
    from varnet_tpu_torch.problems.analytic import transient_ad_2d

    fd = build_fixed_data(transient_ad_2d()["pde"], BENCH["disc_num"],
                          b_disc_num=BENCH["b_disc_num"], t_disc_num=BENCH["t_disc_num"])
    scale, shift = make_input_scaling(fd.static.input_lo, fd.static.input_hi)
    return fr.prepare_residual_data(fd.quad, scale, shift, time_dependent=True,
                                    has_react=False, device="cuda", jacobian=jacobian)


def phase_kernels(widths, seed=0):
    """Kernel vs plain at the bench mesh for one width; returns the numbers."""
    import torch

    from varnet_tpu_torch.ops import fused_residual as fr

    torch.backends.cuda.matmul.allow_tf32 = False
    data = _bench_data()
    params, gen = _seeded_net(data.xs.shape[0], widths, seed)
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


def _vj_compare(params, xs_t, seed, label, timed, g=None):
    """K5 forward / backward and K6 against their plain versions on xs_t; the
    backward's cotangent g [1 + n_in, P] is seeded unless given."""
    import torch

    from varnet_tpu_torch.ops import value_and_jac as vj

    gen = torch.Generator().manual_seed(seed)
    if g is None:
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

    torch.backends.cuda.matmul.allow_tf32 = False
    params, _ = _seeded_net(xs_t.shape[0], widths, seed)
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
    return launches, vn, rk

# ---------------------------------------------------------------------------
# Checkpoints, resume and fault recovery on the main path (K1 / K2, K5 / K6)

RESUME_DIR = os.path.join(ROOT, "build", "chip_smoke_resume")
RESUME_ADAM = dict(lr=2e-3, decay_rate=0.4, decay_steps=100)
RECIPE_EPOCHS, RECIPE_SAVE = 300, 50     # hardbc_tpu.py's save_freq = epochs // 6


def _resume_vn(widths, **kw):
    from varnet_tpu_torch import OptimizerConfig, VarNet
    from varnet_tpu_torch.problems.analytic import transient_ad_2d

    return VarNet(transient_ad_2d()["pde"], layer_width=widths, device="cuda",
                  optimizer=OptimizerConfig(**RESUME_ADAM), **BENCH, **kw)


def _max_dtheta(a, b):
    return max(float((x[k] - y[k]).abs().max()) for x, y in zip(a, b) for k in ("w", "b"))


def phase_resume(theta_full, r_full):
    """Adam through K1/K2 and LM through K5/K6, each cut in half and resumed in a
    fresh VarNet, against the uninterrupted run (LM: the lm phase's kernel run,
    ``theta_full`` and ``r_full``); a real out-of-memory error retried with
    k_chunks doubled; a CLI through --folder / --resume; the save and restore
    times and the Adam steps/s with and without checkpoints."""
    import shutil

    import torch

    from varnet_tpu_torch import VarNet, load_theta_npz, params_from_jax
    from varnet_tpu_torch.ops import fused_residual as fr
    from varnet_tpu_torch.ops import value_and_jac as vj
    from varnet_tpu_torch.train.checkpoint import (
        list_checkpoint_steps, load_checkpoint, load_meta)
    from varnet_tpu_torch.train.optim import make_optimizer

    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    t0 = time.perf_counter()
    tk = dict(weight=WEIGHT, save_freq=20, verbose=False, error_disc=32, error_times=3)
    full = _resume_vn((20, 20))
    full.train(epoch_num=40, folderpath=os.path.join(RESUME_DIR, "adam_full"), **tk)
    cut_dir = os.path.join(RESUME_DIR, "adam_cut")
    _resume_vn((20, 20)).train(epoch_num=20, folderpath=cut_dir, **tk)
    before = fr.dir_residual_fwd.launches
    resumed = _resume_vn((20, 20))
    res = resumed.train(epoch_num=40, folderpath=cut_dir, resume=True, **tk)
    k1 = fr.dir_residual_fwd.launches - before
    d_adam = _max_dtheta(resumed.theta, full.theta)
    if k1 < 20 or res.epochs != [40] or list_checkpoint_steps(cut_dir) != [20, 40]:
        raise AssertionError(f"Adam resume: K1 launches {k1}, epochs {res.epochs}, "
                             f"steps {list_checkpoint_steps(cut_dir)}")
    if d_adam != 0.0:
        raise AssertionError(f"Adam resumed theta differs from the uninterrupted run's by "
                             f"{d_adam:.3e}")
    log("resume adam", widths="20x20", epochs="20+20", k1_launches=k1,
        max_abs_dtheta=f"{d_adam:.3e}", seconds=f"{time.perf_counter() - t0:.1f}")

    # save / restore times of a checkpoint of the bench net and its Adam state
    theta = [{k: v.clone().requires_grad_(True) for k, v in layer.items()}
             for layer in resumed.theta]
    opt = make_optimizer(resumed.optimizer_cfg, [l[k] for l in theta for k in ("w", "b")])
    opt.load_state_dict(load_checkpoint(cut_dir, {"theta": resumed.theta,
                                                  "opt_state": opt.state_dict()},
                                        map_location="cuda")[0]["opt_state"])
    t_dir = os.path.join(RESUME_DIR, "timing")
    save_ms, load_ms = [], []
    for i in range(10):
        t1 = time.perf_counter()
        resumed._save(t_dir, i + 1, theta, {"seed": 0}, opt)
        save_ms.append(1e3 * (time.perf_counter() - t1))
        t1 = time.perf_counter()
        load_checkpoint(t_dir, {"theta": resumed.theta, "opt_state": opt.state_dict()},
                        map_location="cuda")
        torch.cuda.synchronize()
        load_ms.append(1e3 * (time.perf_counter() - t1))
    log("checkpoint", widths="20x20", save_ms=f"{statistics.median(save_ms):.3f}",
        restore_ms=f"{statistics.median(load_ms):.3f}",
        bytes=os.path.getsize(os.path.join(t_dir, f"ckpt_{10:010d}", "state.pt")))

    # Adam steps/s at the recipe's save period: without a folder, with one, and
    # with one whose checkpoint writes are taken out (the log alone), in turns
    t0 = time.perf_counter()
    rates = {"none": [], "folder": [], "log_only": []}
    real_save = VarNet._save
    rate_vn = _resume_vn((20, 20))
    for i, mode in enumerate(("none", "folder", "log_only", "log_only", "folder", "none")):
        folder = None if mode == "none" else os.path.join(RESUME_DIR, f"rate{i}")
        if mode == "log_only":
            VarNet._save = lambda *args, **kw: None
        try:
            r = rate_vn.train(epoch_num=RECIPE_EPOCHS, weight=WEIGHT, save_freq=RECIPE_SAVE,
                              folderpath=folder, verbose=False, error_disc=32, error_times=3)
        finally:
            VarNet._save = real_save
        rates[mode].append(r.steps_per_sec)
    log("checkpoint steps/s", epochs=RECIPE_EPOCHS, save_freq=RECIPE_SAVE,
        **{k: ",".join(f"{x:.4f}" for x in v) for k, v in rates.items()},
        seconds=f"{time.perf_counter() - t0:.1f}")

    # LM: the lm phase's 2 iterations against 1 and a resume to 2 (lam from the meta)
    t0 = time.perf_counter()
    lm = dict(weight=WEIGHT, save_freq=1, verbose=False, error_disc=32, error_times=3,
              cg_iters=LM["cg_iters"], k_chunks=LM["k_chunks"])
    theta0 = params_from_jax(load_theta_npz(LM_START), device="cuda")
    lm_vn = _resume_vn((48, 48, 48), use_pallas=True)

    def lm_run(**kw):
        lm_vn.theta = [{k: v.clone() for k, v in layer.items()} for layer in theta0]
        return lm_vn.refine_lm(**lm, **kw)

    lm_cut = os.path.join(RESUME_DIR, "lm_cut")
    lm_run(steps=1, folderpath=lm_cut)
    lam_meta = load_meta(os.path.join(lm_cut, "lm"), 1)["lam"]
    before = (vj.vj_bwd.launches, vj.vj_jvp.launches)
    lm_res = _resume_vn((48, 48, 48), use_pallas=True)
    r_res = lm_res.refine_lm(steps=2, folderpath=lm_cut, resume=True, **lm)
    k56 = (vj.vj_bwd.launches - before[0], vj.vj_jvp.launches - before[1])
    d_lm = _max_dtheta(lm_res.theta, theta_full)
    if min(k56) < LM["cg_iters"] or r_res.epochs != [2]:
        raise AssertionError(f"LM resume: K5 bwd / K6 launches {k56}, epochs {r_res.epochs}")
    if d_lm != 0.0 or r_res.losses != r_full.losses[1:]:
        raise AssertionError(f"LM resumed theta differs by {d_lm:.3e}: {r_res.losses} vs "
                             f"{r_full.losses[1:]}")
    log("resume lm", widths="48x48x48", iterations="1+1", lam_from_meta=f"{lam_meta:.6g}",
        k5_bwd_launches=k56[0], k6_launches=k56[1], max_abs_dtheta=f"{d_lm:.3e}",
        loss=f"{r_res.losses[-1]['loss']:.6e}", seconds=f"{time.perf_counter() - t0:.1f}")
    del lm_res

    # a genuine OOM after the first LM checkpoint: retried with k_chunks doubled
    real_impl = VarNet._refine_lm_impl
    seen = {"k": [], "oom": None}

    def impl(self, steps, *args):
        seen["k"].append(args[8])
        return real_impl(self, steps, *args)

    def save(self, folderpath, step, theta, meta, optimizer=None):
        real_save(self, folderpath, step, theta, meta, optimizer)
        if seen["oom"] is None:
            seen["oom"] = "armed"
            total = torch.cuda.get_device_properties(0).total_memory
            try:
                torch.empty(2 * total, dtype=torch.uint8, device="cuda")
            except torch.cuda.OutOfMemoryError as err:
                seen["oom"] = type(err).__name__
                raise

    VarNet._refine_lm_impl, VarNet._save = impl, save
    try:
        t0 = time.perf_counter()
        r_oom = lm_run(steps=2, folderpath=os.path.join(RESUME_DIR, "lm_oom"), max_retries=1,
                       retry_backoff=0.0)
        oom_s = time.perf_counter() - t0
    finally:
        VarNet._refine_lm_impl, VarNet._save = real_impl, real_save
    del lm_vn
    k0 = LM["k_chunks"]
    band = abs(r_oom.losses[-1]["loss"] - r_full.losses[-1]["loss"]) / r_full.losses[-1]["loss"]
    if seen["k"] != [k0, 2 * k0] or seen["oom"] != "OutOfMemoryError" or r_oom.epochs != [2]:
        raise AssertionError(f"OOM retry: k_chunks {seen['k']}, error {seen['oom']}, "
                             f"epochs {r_oom.epochs}")
    if not band <= 2e-2:
        raise AssertionError(f"OOM-retried LM loss off the uninterrupted run's by {band:.3e}")
    log("resume lm oom", error=seen["oom"], k_chunks=f"{k0}->{2 * k0}",
        loss=f"{r_oom.losses[-1]['loss']:.6e}", rel_diff=f"{band:.3e}",
        call_seconds=f"{oom_s:.3f}")

    # a CLI through --folder, then --resume to a larger total, in a subprocess
    t0 = time.perf_counter()
    folder = os.path.join(RESUME_DIR, "cli")
    base = [sys.executable, "-m", "varnet_tpu_torch.examples.ad2d_transient", "--disc", "16",
            "--tdisc", "8", "--bdisc", "16", "--save-freq", "20", "--folder", folder]
    outs = []
    for extra in (["--epochs", "40"], ["--epochs", "60", "--resume"]):
        proc = subprocess.run(base + extra, cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"CLI {extra} failed: {proc.stdout[-2000:]}"
                                 f"{proc.stderr[-2000:]}")
        outs.append(proc.stdout)
    steps = list_checkpoint_steps(folder)
    if ("resumed from epoch 40" not in outs[1] or steps != [20, 40, 60]
            or not os.path.exists(os.path.join(folder, "config.json"))
            or load_meta(folder, 60) is None):
        raise AssertionError(f"CLI resume: steps {steps}; output {outs[1][-1000:]}")
    log("resume cli", module="ad2d_transient", steps=",".join(map(str, steps)),
        summary=outs[1].strip().splitlines()[-1], seconds=f"{time.perf_counter() - t0:.1f}")
    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    return {"adam_dtheta": d_adam, "lm_dtheta": d_lm}


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
    # K2-FF on seeded nets at HP 128 and at the widest hidden width the kernels take (HP
    # 256, warp groups of four) on the same mesh; K7 and K8 at HP 256 on the LM chunk

    def wide_bwd_plain(wide):
        total = None
        for c, (k0, k1) in zip(chunks, bounds):
            part_g = leaves(fr.dir_residual_bwd_plain(wide, c, "tanh", gr[k0:k1]))
            total = part_g if total is None else [a + b for a, b in zip(total, part_g)]
        return total

    for hp, seed in ((128, 12), (256, 13)):
        wide, wgen = _seeded_net(256, (hp,) * 3, seed)
        checks.update({
            f"ff_res_fwd_w{hp}": (
                (lambda w: lambda: [fr.dir_residual_ff_fwd(w, data, "tanh")])(wide),
                (lambda w: lambda: [torch.cat([fr.dir_residual_fwd_plain(w, c, "tanh")
                                               for c in chunks])])(wide), FF_R_RTOL),
            f"ff_res_bwd_w{hp}": (
                (lambda w: lambda: leaves(fr.dir_residual_ff_bwd(w, data, "tanh", gr)))(wide),
                (lambda w: lambda: wide_bwd_plain(w))(wide), FF_RTOL),
        })
    wtan = [{k: torch.randn(v.shape, generator=wgen).cuda() for k, v in layer.items()}
            for layer in wide]
    checks.update({
        "ff_vj_fwd_w256": (lambda: list(vj.ff_vj_fwd(wide, part.xs, bt, "tanh")),
                           lambda: list(vj.ff_vj_fwd_plain(wide, part.xs, bt, "tanh")), FF_RTOL),
        "ff_vj_bwd_w256": (lambda: leaves(vj.ff_vj_bwd(wide, part.xs, bt, "tanh", g)),
                           lambda: leaves(vj.ff_vj_bwd_plain(wide, part.xs, bt, "tanh", g)),
                           FF_RTOL),
        "ff_vj_jvp_w256": (lambda: list(vj.ff_vj_jvp(wide, part.xs, bt, "tanh", wtan)),
                           lambda: list(vj.ff_vj_jvp_plain(wide, part.xs, bt, "tanh", wtan)),
                           FF_RTOL),
    })
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
    # the launch shape of every ff launch: blocks and warps resident per SM
    p_full = data.k * data.nq
    for name, (kind, panels, p, hp) in {
            "ff_res_fwd": ("fwd", 2, p_full, 96), "ff_res_bwd": ("bwd", 2, p_full, 96),
            "ff_res_fwd_w128": ("fwd", 2, p_full, 128), "ff_res_bwd_w128": ("bwd", 2, p_full, 128),
            "ff_res_fwd_w256": ("fwd", 2, p_full, 256), "ff_res_bwd_w256": ("bwd", 2, p_full, 256),
            "ff_vj_fwd": ("fwd", 4, n, 96), "ff_vj_bwd": ("bwd", 4, n, 96),
            "ff_vj_jvp": ("jvp", 4, n, 96), "ff_vj_fwd_w256": ("fwd", 4, n, 256),
            "ff_vj_bwd_w256": ("bwd", 4, n, 256), "ff_vj_jvp_w256": ("jvp", 4, n, 256)}.items():
        log("kernels-ff launch", kernel=name, **fr.ff_launch_shape(kind, panels, p, 256, 3, hp))
    return out, p_full, data.k, n


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
        start = _lm_loss(vn, theta, LM_FF["k_chunks"])
    t0 = time.perf_counter()
    res = vn.refine_lm(weight=WEIGHT, save_freq=1, verbose=False, **LM_FF)
    torch.cuda.synchronize()
    return vn, res, start, time.perf_counter() - t0


def _lm_loss(vn, theta, k_chunks):
    """sum r^2 of the (penalty-form) LM residual of ``vn`` at theta (plain path)."""
    import torch

    from varnet_tpu_torch.fem.assembly import pad_points, pad_quad
    from varnet_tpu_torch.train.gauss_newton import make_residual_fn

    res_fn = make_residual_fn(vn.static, k_chunks=k_chunks, device="cuda",
                              has_react=vn.has_react, input_scaling=vn.input_scaling,
                              apply_fn=vn._apply_fn(),
                              value_and_jac=vn._value_and_jac(False), nl_vec=vn.nl_vec)
    r = res_fn(theta, vn._to_device(pad_quad(vn.fixed.quad, k_chunks)),
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
# The exact-BC / per-node-table slice (K4)

RESULTS = os.path.join(ROOT, "benchmarks", "results")
HARD_3DT = dict(disc_num=16, b_disc_num=24, t_disc_num=10)   # P = 7,776,000 points
HARD_3DT_SMALL = dict(disc_num=8, b_disc_num=24, t_disc_num=6)
HARD_2D_O2 = dict(disc_num=48, b_disc_num=48, integ_p_num=3, test_order=2)
HARD_ADAM = dict(lr=2e-3, decay_rate=0.1, decay_steps=6000)  # hardbc_tpu.py, 24,000 epochs
HARD_LM = dict(steps=2, cg_iters=10, k_chunks=16)
HARD_WIDE = (96, 96, 96)   # the obstacle case's hard-BC width: K4 on ff_mlp.cu


def _hard_vn(factory, widths, mesh, **kw):
    from varnet_tpu_torch import VarNet
    from varnet_tpu_torch.problems import analytic
    from varnet_tpu_torch.train.optim import OptimizerConfig

    return VarNet(getattr(analytic, factory)()["pde"], layer_width=widths, device="cuda",
                  hard_bc=True, optimizer=OptimizerConfig(**HARD_ADAM), **{**mesh, **kw})


def phase_hard_tables():
    """The 3-D transient hard-BC VarNet at the recipe's mesh and its host f64
    transform tables, built once for the K4 phases; beside the threaded,
    chunked build of ``VarNet._hard_tables``, one single-threaded
    ``HardBC.tables`` call over the same points, which must give the same
    tables bit for bit."""
    from varnet_tpu_torch.fem.assembly import pad_quad

    t0 = time.perf_counter()
    vn = _hard_vn("transient_ad_3d", (64, 64), HARD_3DT)
    secs_build = time.perf_counter() - t0
    hq = vn._hard_tables(pad_quad(vn.fixed.quad, 1))
    real = int(vn.fixed.quad.mask.sum())
    t0 = time.perf_counter()
    single = vn.hard.tables(np.asarray(vn.fixed.quad.coords)[:real])
    secs_single = time.perf_counter() - t0
    for name, a, b in zip(single._fields, single, vn._hard_cache[1]):
        if (a is None) != (b is None) or (a is not None and not np.array_equal(a, b)):
            raise AssertionError(f"hard table {name}: threaded build differs from one call")
    del single
    log("hard-tables", mesh="d16/t10", k=vn.static.n_test, nq=vn.static.n_quad_per_test,
        points=vn.static.n_test * vn.static.n_quad_per_test,
        assembly_seconds=f"{secs_build:.3f}", table_seconds=f"{vn.hard_table_seconds:.3f}",
        threads=min(8, os.cpu_count() or 1), single_call_seconds=f"{secs_single:.3f}")
    return vn, hq


def _residual_compare(params, data, gen, label, timed=True, kernels=None, plains=None,
                      kinds=("fwd", "bwd")):
    """A residual kernel pair's forward / backward against its plain version on
    ``data`` (default: K4 against ``dir_residual_*_plain``)."""
    import torch

    from varnet_tpu_torch.ops import fused_residual as fr

    fwd, bwd = kernels or (fr.dirp_residual_fwd, fr.dirp_residual_bwd)
    fwd_p, bwd_p = plains or (fr.dir_residual_fwd_plain, fr.dir_residual_bwd_plain)
    gr = torch.randn(data.k, generator=gen).cuda()
    checks = {
        "fwd": (lambda: [fwd(params, data, "tanh")], lambda: [fwd_p(params, data, "tanh")],
                R_RTOL),
        "bwd": (lambda: [g[k] for g in bwd(params, data, "tanh", gr) for k in ("w", "b")],
                lambda: [g[k] for g in bwd_p(params, data, "tanh", gr) for k in ("w", "b")],
                G_RTOL),
    }
    out = {}
    for name in kinds:
        kernel, plain, rtol = checks[name]
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        rel = max(_rel_err(a, b) for a, b in zip(got, ref))
        abs_err = max(float((a - b).abs().max()) for a, b in zip(got, ref))
        if not (np.isfinite(rel) and rel <= rtol):
            raise AssertionError(f"{label}: {(fwd, bwd)[name == 'bwd'].__name__} differs "
                                 f"from plain by {rel:.3e} > {rtol}")
        del got, ref
        torch.cuda.empty_cache()
        out[name] = {"rel_err": rel, "abs_err": abs_err}
        if timed:
            out[name]["ms"] = _median_ms(kernel, n=5, warmup=1)
            out[name]["plain_ms"] = _median_ms(plain, n=5, warmup=1)
            torch.cuda.empty_cache()
    log(label, points=data.k * data.nq, k=data.k, nq=data.nq,
        **{f"{k}_{m}": f"{v:.4g}" for k, d in out.items() for m, v in d.items()})
    return out


def phase_kernels_dirp(vn3, hq3):
    """K4 vs plain at the 3-D transient mesh (hard fold, n_in 4, nq 256) and at
    the 2-D order-2 mesh (hard fold, per-node tables, nq 36)."""
    import torch

    from varnet_tpu_torch.fem.assembly import pad_quad
    from varnet_tpu_torch.ops import fused_residual as fr

    torch.backends.cuda.matmul.allow_tf32 = False
    data = fr.prepare_residual_coeffs(pad_quad(vn3.fixed.quad, 1), vn3.scale, vn3.shift,
                                      time_dependent=True, has_react=vn3.has_react, hard=hq3,
                                      device="cuda")
    params, gen = _seeded_net(4, (64, 64), 21)
    full = _residual_compare(params, data, gen, "kernels-dirp 3dt-hard w64x2")
    del data
    torch.cuda.empty_cache()
    vn2 = _hard_vn("steady_ad_2d", (48, 48), HARD_2D_O2)
    data2 = fr.prepare_residual_coeffs(vn2.fixed.quad, vn2.scale, vn2.shift,
                                       time_dependent=False, has_react=vn2.has_react,
                                       hard=vn2._hard_tables(vn2.fixed.quad), device="cuda")
    params2, gen2 = _seeded_net(2, (48, 48), 22)
    _residual_compare(params2, data2, gen2, "kernels-dirp 2d-o2-hard w48x2")
    # K4 for a net wider than 64: ff_mlp.cu's precoeff mode, the route
    # _residual_fns gives a w96x3 net (the obstacle case's hard-BC width)
    params3, gen3 = _seeded_net(2, HARD_WIDE, 25)
    wide_fns = fr._residual_fns(params3, data2)
    if wide_fns != (fr.dirp_residual_ff_fwd, fr.dirp_residual_ff_bwd):
        raise AssertionError(f"a w96x3 precoeff net routes to {wide_fns}, not ff_mlp.cu's K4")
    wide = _residual_compare(params3, data2, gen3, "kernels-dirp 2d-o2-hard w96x3 (ff_mlp.cu)",
                             kernels=wide_fns)
    return full, wide, data2.k * data2.nq, data2.k


NQ1296 = dict(disc_num=3, b_disc_num=3, t_disc_num=3, integ_p_num=3)  # nq 1296, n_in 4


def phase_kernels_nq1296():
    """K1 (table mode, order 1) and K4 (precoeff, exact BC, order 2) forward and
    backward against their plain versions on ``transient_ad_3d`` with integ_p_num 3:
    1296 points per test function, more than the forward took before it tiled points
    without regard to test functions."""
    from varnet_tpu_torch.fem.assembly import build_fixed_data
    from varnet_tpu_torch.models.mlp import make_input_scaling
    from varnet_tpu_torch.ops import fused_residual as fr
    from varnet_tpu_torch.problems.analytic import transient_ad_3d

    fd = build_fixed_data(transient_ad_3d()["pde"], **NQ1296)
    scale, shift = make_input_scaling(fd.static.input_lo, fd.static.input_hi)
    data = fr.prepare_residual_data(fd.quad, scale, shift, time_dependent=True,
                                    has_react=False, device="cuda")
    params, gen = _seeded_net(4, (64, 64), 26)
    _residual_compare(params, data, gen, "kernels-nq1296 K1 order-1 w64x2", timed=False,
                      kernels=(fr.dir_residual_fwd, fr.dir_residual_bwd))
    vn = _hard_vn("transient_ad_3d", (64, 64), dict(NQ1296, test_order=2))
    data = fr.prepare_residual_coeffs(vn.fixed.quad, vn.scale, vn.shift, time_dependent=True,
                                      has_react=vn.has_react,
                                      hard=vn._hard_tables(vn.fixed.quad), device="cuda")
    _residual_compare(params, data, gen, "kernels-nq1296 K4 hard order-2 w64x2", timed=False)


def _losses(res):
    return np.array([r["loss"] for r in res.losses])


def phase_hard_train(vn3):
    """20 Adam epochs at the 3-D transient mesh through K4 (the slice's main
    path); kernel vs plain at a reduced mesh; the order-2 hard case; a
    refinement that moves a penalty net from K1/K2 onto K4."""
    import torch

    from varnet_tpu_torch import VarNet
    from varnet_tpu_torch.fem.assembly import pad_quad
    from varnet_tpu_torch.ops import fused_residual as fr
    from varnet_tpu_torch.problems.analytic import steady_ad_2d

    epochs = 20
    first = vn3.train(epoch_num=1, save_freq=1, verbose=False, error_disc=24)  # seeded net's loss
    fr.dirp_residual_fwd.launches = fr.dirp_residual_bwd.launches = 0
    res = vn3.train(epoch_num=epochs, save_freq=epochs, verbose=False, error_disc=24)
    torch.cuda.synchronize()
    launches = {"fwd": fr.dirp_residual_fwd.launches, "bwd": fr.dirp_residual_bwd.launches}
    if min(launches.values()) < epochs:
        raise AssertionError(f"K4 launches {launches} < 1 per epoch over {epochs} epochs")
    loss0, loss_end = first.losses[0]["loss"], res.losses[-1]["loss"]
    if not (np.isfinite(loss_end) and loss_end < loss0):
        raise AssertionError(f"hard 3dt loss did not fall: {loss0} -> {loss_end}")
    log("hard-train kernel", mesh="d16/t10", epochs=epochs, dirp_fwd=launches["fwd"],
        dirp_bwd=launches["bwd"], loss_start=f"{loss0:.6e}", loss_end=f"{loss_end:.6e}",
        rel_l2=f"{res.errors[-1]:.4e}", steps_per_sec=f"{res.steps_per_sec:.4f}",
        quad_evals_per_sec=f"{res.quad_evals_per_sec:.6e}")

    runs = {}
    for fused in (True, False):
        vk = _hard_vn("transient_ad_3d", (64, 64), HARD_3DT_SMALL, use_fused_residual=fused,
                      use_pallas=fused)
        runs[fused] = _losses(vk.train(epoch_num=epochs, save_freq=1, verbose=False,
                                       error_disc=8, error_times=2))
    worst = float(np.max(np.abs(runs[True] - runs[False]) / np.abs(runs[False])))
    if not worst <= 2e-4:
        raise AssertionError(f"hard kernel vs plain 20-epoch trajectories differ by {worst:.3e}")
    log("hard-train 20-epoch kernel vs plain", mesh="d8/t6", max_rel_diff=f"{worst:.3e}",
        loss_end_kernel=f"{runs[True][-1]:.6e}", loss_end_plain=f"{runs[False][-1]:.6e}")

    vo = _hard_vn("steady_ad_2d", (48, 48), HARD_2D_O2)
    before = fr.dirp_residual_fwd.launches
    ro = vo.train(epoch_num=epochs, save_freq=epochs, verbose=False, error_disc=96)
    if fr.dirp_residual_fwd.launches - before < epochs:
        raise AssertionError("the order-2 hard run did not go through K4 every epoch")
    log("hard-train order-2 2-D", mesh="d48 integ3", k=vo.static.n_test,
        nq=vo.static.n_quad_per_test, loss_end=f"{ro.losses[-1]['loss']:.6e}",
        rel_l2=f"{ro.errors[-1]:.4e}", steps_per_sec=f"{ro.steps_per_sec:.4f}",
        dirp_fwd=fr.dirp_residual_fwd.launches - before)

    va = VarNet(steady_ad_2d()["pde"], layer_width=(48, 48), disc_num=48, b_disc_num=48,
                device="cuda")
    counts = lambda: (fr.dir_residual_fwd.launches, fr.dirp_residual_fwd.launches)  # noqa: E731
    c0 = counts()
    va.train(epoch_num=5, weight=(1.0, 10.0), save_freq=5, verbose=False, error_disc=96)
    c1 = counts()
    info = va.refine_tests(frac=0.1, verbose=False)
    rr = va.train(epoch_num=5, weight=(1.0, 10.0), save_freq=5, verbose=False, error_disc=96)
    c2 = counts()
    if not (c1[0] - c0[0] >= 5 and c1[1] == c0[1] and c2[1] - c1[1] >= 5 and c2[0] == c1[0]):
        raise AssertionError(f"refinement did not move the net from K1/K2 to K4: {c0} {c1} {c2}")
    log("hard-train refine_tests 2-D", added=info["n_added"], n_test=info["n_test"],
        dir_fwd_before=c1[0] - c0[0], dirp_fwd_after=c2[1] - c1[1],
        loss_end=f"{rr.losses[-1]['loss']:.6e}")
    # K4 against its plain version on the refined space's data (penalty form,
    # mixed-scale per-node tables) at the trained net
    data_a = fr.prepare_residual_coeffs(pad_quad(va.fixed.quad, 1), va.scale, va.shift,
                                        time_dependent=False, has_react=va.has_react,
                                        device="cuda")
    _residual_compare(va.theta, data_a, torch.Generator().manual_seed(23),
                      "kernels-dirp 2d-refined w48x2", timed=False)

    # a precoeff net wider than 64 (order-2 2-D hard at w96x3) trains through
    # ff_mlp.cu's precoeff mode every epoch
    vw = _hard_vn("steady_ad_2d", HARD_WIDE, HARD_2D_O2)
    fr.dirp_residual_ff_fwd.launches = fr.dirp_residual_ff_bwd.launches = 0
    rw = vw.train(epoch_num=epochs, save_freq=epochs, verbose=False, error_disc=96)
    torch.cuda.synchronize()
    wide = {"fwd": fr.dirp_residual_ff_fwd.launches, "bwd": fr.dirp_residual_ff_bwd.launches}
    if min(wide.values()) < epochs or not np.isfinite(rw.losses[-1]["loss"]):
        raise AssertionError(f"the w96x3 order-2 hard run: K4-wide launches {wide}, "
                             f"loss {rw.losses[-1]['loss']}")
    log("hard-train order-2 2-D w96x3", mesh="d48 integ3", epochs=epochs,
        dirp_ff_fwd=wide["fwd"], dirp_ff_bwd=wide["bwd"],
        loss_end=f"{rw.losses[-1]['loss']:.6e}", rel_l2=f"{rw.errors[-1]:.4e}",
        steps_per_sec=f"{rw.steps_per_sec:.4f}")
    return launches, wide


def phase_hard_accuracy():
    """The pinned hard-BC thetas re-score under their bounds on the card."""
    from varnet_tpu_torch import load_theta_npz

    out = {}
    for pin, factory, widths, mesh, disc, bound in (
            ("3dt", "transient_ad_3d", (64, 64), dict(disc_num=4, t_disc_num=3), 24, 3e-4),
            ("2d", "steady_ad_2d", (48, 48), dict(disc_num=8), 96, 4.0e-5),
            ("1dt", "transient_ad_1d", (32, 32, 32), dict(disc_num=8, t_disc_num=4), 256,
             5e-6)):
        theta = load_theta_npz(os.path.join(RESULTS, f"theta_hardbc_{pin}.npz"))
        err = _hard_vn(factory, widths, mesh).compute_error(theta, disc=disc, n_times=5)
        if not err < bound:
            raise AssertionError(f"theta_hardbc_{pin} re-scores {err:.4e} >= {bound:g}")
        out[pin] = err
    log("hard-accuracy", **{f"{k}_rel_l2": f"{v:.6e}" for k, v in out.items()})


def _hard_lm_loss(vn, theta):
    """sum r^2 of the exact-BC LM residual at theta (plain path)."""
    import torch

    from varnet_tpu_torch.fem.assembly import pad_points, pad_quad
    from varnet_tpu_torch.fem.hardbc import tables_to
    from varnet_tpu_torch.train.gauss_newton import make_residual_fn

    quad_h = pad_quad(vn.fixed.quad, HARD_LM["k_chunks"])
    res_fn = make_residual_fn(vn.static, k_chunks=HARD_LM["k_chunks"], device="cuda",
                              hard_mode=True)
    with torch.no_grad():
        r = res_fn(theta, vn._to_device(quad_h), vn._to_device(pad_points(vn.fixed.bc, 1)),
                   vn._to_device(pad_points(vn.fixed.ic, 1)), (1.0, 1.0, 1.0, 0.0),
                   hard=tables_to(vn._hard_tables(quad_h), "cuda"))
    return float(torch.dot(r, r))


def phase_hard_lm(vn3):
    """K5 / K6 vs plain on one LM chunk of the recipe's mesh; ``refine_lm``
    from the pinned 3-D transient hard theta there on K5 / K6; kernel vs plain
    LM losses at the reduced mesh."""
    import torch

    from varnet_tpu_torch import load_theta_npz, params_from_jax
    from varnet_tpu_torch.fem.assembly import pad_quad
    from varnet_tpu_torch.ops import value_and_jac as vj

    theta = params_from_jax(load_theta_npz(os.path.join(RESULTS, "theta_hardbc_3dt.npz")),
                            device="cuda")
    # K5 / K6 against their plain versions at the pinned theta on one LM chunk
    # of the 3dt mesh: the shape (n_in 4, w64x2, K / k_chunks test functions)
    # that refine_lm gives them below
    quad_h = pad_quad(vn3.fixed.quad, HARD_LM["k_chunks"])
    kc = quad_h.coords.shape[0] // HARD_LM["k_chunks"]
    coords = torch.from_numpy(np.array(quad_h.coords[:kc], dtype=np.float32)).cuda()
    xs_t = ((coords.reshape(-1, coords.shape[-1]) - vn3.shift) * vn3.scale).T.contiguous()
    _vj_compare(theta, xs_t, 24, "kernels-vj hard3dt-chunk w64x2", timed=True)
    del coords, xs_t
    torch.cuda.empty_cache()
    start = _hard_lm_loss(vn3, theta)
    vn3.theta = [{k: v.clone() for k, v in layer.items()} for layer in theta]
    vj.vj_fwd.launches = vj.vj_bwd.launches = vj.vj_jvp.launches = 0
    t0 = time.perf_counter()
    rk = vn3.refine_lm(save_freq=1, verbose=False, error_disc=24, error_times=5, **HARD_LM)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {"vj_fwd": vj.vj_fwd.launches, "vj_bwd": vj.vj_bwd.launches,
                "vj_jvp": vj.vj_jvp.launches}
    need = HARD_LM["steps"] * HARD_LM["cg_iters"]
    if min(launches.values()) < need:
        raise AssertionError(f"hard LM kernel launches {launches} < steps x cg_iters = {need}")
    lk = _losses(rk)
    if not (np.all(np.isfinite(lk)) and lk[0] <= start * (1 + 1e-5) and np.all(np.diff(lk) <= 0)):
        raise AssertionError(f"hard LM loss rose: start {start} -> {lk.tolist()}")
    if not rk.errors[-1] < 3e-4:
        raise AssertionError(f"hard LM rel-L2 {rk.errors[-1]:.4e} >= 3e-4")
    per_it = (rk.wall_times[-1] - rk.wall_times[0]) / (HARD_LM["steps"] - 1)
    log("hard-lm kernel", mesh="d16/t10", **HARD_LM, loss_start=f"{start:.6e}",
        losses=",".join(f"{v:.6e}" for v in lk), rel_l2=f"{rk.errors[-1]:.6e}",
        s_per_iter=f"{per_it:.4f}", call_seconds=f"{secs:.3f}", **launches)
    small = {}
    for use_pallas in (True, False):
        v = _hard_vn("transient_ad_3d", (64, 64), HARD_3DT_SMALL, use_pallas=use_pallas)
        v.theta = [{k: t.clone() for k, t in layer.items()} for layer in theta]
        small[use_pallas] = _losses(v.refine_lm(save_freq=1, verbose=False, error_disc=8,
                                                error_times=2, **HARD_LM))
    worst = float(np.max(np.abs(small[True] - small[False]) / np.abs(small[False])))
    if not worst <= 2e-2:
        raise AssertionError(f"hard LM kernel vs plain losses differ by {worst:.3e}")
    log("hard-lm kernel vs plain", mesh="d8/t6",
        losses_kernel=",".join(f"{v:.6e}" for v in small[True]),
        losses_plain=",".join(f"{v:.6e}" for v in small[False]), max_rel_diff=f"{worst:.3e}")
    return launches


# ---------------------------------------------------------------------------
# The viscous-Burgers slice (K3, the jacobian-panel residual)

BURG_2D = dict(disc_num=32, b_disc_num=32, t_disc_num=20)   # P = 1,168,576 points
BURG_1D = dict(disc_num=48, b_disc_num=48, t_disc_num=32)   # the 1-D recipe's mesh
BURG_NET = (32, 32, 32)
BURG_THETA = os.path.join(RESULTS, "theta_burgers_front_2d.npz")
BURG_ADAM = dict(lr=2e-3, decay_rate=0.1, decay_steps=3000)  # burgers_accuracy.py, 12,000 epochs
BURG_EPOCHS = 100
BURG_LM = dict(steps=2, cg_iters=20, k_chunks=16)
# K3's r at the pinned theta, relative to max |r| of an f64 evaluation: there r is a
# ~1e-3 cancellation of its terms, and any f32 evaluation of it (the plain version's
# too) carries ~2e-4 of max |r| of rounding; the 1e-5 gate is held on a seeded net
PIN_R_RTOL = 1e-3
# pin stem -> (problem factory, its keyword arguments, evaluation disc, rel-L2 bound):
# tests/test_accuracy_pin.py::BURGERS_PINS
BURG_PINS = {
    "traveling_front": ("burgers_1d_transient", dict(nu=0.05, a=0.4, c=0.6), 256, 1e-4),
    "steady_shock": ("burgers_1d_steady", dict(nu=0.07, a=1.0), 256, 8e-4),
    "front_2d": ("burgers_2d_front", dict(nu=0.1), 96, 2e-4),
    "traveling_front_hard": ("burgers_1d_transient", dict(nu=0.05, a=0.4, c=0.6), 256, 2e-6),
    "steady_shock_hard": ("burgers_1d_steady", dict(nu=0.07, a=1.0), 256, 7e-4),
}


def _burgers_vn(factory="burgers_2d_front", kw=None, mesh=None, **vn_kw):
    from varnet_tpu_torch import VarNet
    from varnet_tpu_torch.problems import analytic
    from varnet_tpu_torch.train.optim import OptimizerConfig

    pde = getattr(analytic, factory)(**({"nu": 0.1} if kw is None else kw))["pde"]
    return VarNet(pde, layer_width=BURG_NET, device="cuda",
                  optimizer=OptimizerConfig(**BURG_ADAM), **{**(mesh or BURG_2D), **vn_kw})


def _pinned_burgers():
    from varnet_tpu_torch import load_theta_npz, params_from_jax

    return params_from_jax(load_theta_npz(BURG_THETA), device="cuda")


def phase_burgers_kernels():
    """K3 against its plain version at the front_2d recipe's mesh (seeded net:
    r 1e-5, grads 1e-4; the pinned theta: grads 1e-4, r against an f64
    evaluation) and with the nonlinear term off at the flagship bench shape
    (``fused_directional=False``); kernel and plain timed at each shape."""
    import torch

    from varnet_tpu_torch.ops import fused_residual as fr

    torch.backends.cuda.matmul.allow_tf32 = False
    jac = (fr.jac_residual_fwd, fr.jac_residual_bwd)
    plain = (fr.jac_residual_fwd_plain, fr.jac_residual_bwd_plain)
    vn = _burgers_vn()
    if vn._fused_kind != "jac":
        raise AssertionError(f"penalty Burgers routes to {vn._fused_kind}, not K3")
    data = fr.prepare_residual_data(vn._to_device(vn.fixed.quad), vn.scale, vn.shift,
                                    time_dependent=True, has_react=vn.has_react,
                                    device="cuda", nl_vec=vn.nl_vec, jacobian=True)
    if fr._residual_fns(vn.theta, data) != jac:
        raise AssertionError("the front_2d data does not route to K3")
    seeded, gen = _seeded_net(3, BURG_NET, 31)
    out = _residual_compare(seeded, data, gen, "burgers-kernels front2d w32x3 seeded",
                            kernels=jac, plains=plain)

    pinned = _pinned_burgers()
    r_k = fr.jac_residual_fwd(pinned, data, "tanh")
    r_p = fr.jac_residual_fwd_plain(pinned, data, "tanh")
    d64 = data._replace(xs=data.xs.double(), flds=data.flds.double(), tab=data.tab.double(),
                        scale=data.scale.double(), nl=data.nl.double())
    r64 = fr.jac_residual_fwd_plain([{k: v.double() for k, v in layer.items()}
                                     for layer in pinned], d64, "tanh")
    torch.cuda.synchronize()
    err_k, err_p = _rel_err(r_k.double(), r64), _rel_err(r_p.double(), r64)
    if not (np.isfinite(err_k) and err_k <= PIN_R_RTOL):
        raise AssertionError(f"K3 r at the pinned theta is {err_k:.3e} of max |r| from f64 "
                             f"(plain f32: {err_p:.3e})")
    del d64, r64
    torch.cuda.empty_cache()
    pin = _residual_compare(pinned, data, gen, "burgers-kernels front2d w32x3 pinned bwd",
                            timed=False, kernels=jac, plains=plain, kinds=("bwd",))
    log("burgers-kernels front2d pinned fwd", max_abs_r=f"{float(r_k.abs().max()):.4e}",
        kernel_vs_f64=f"{err_k:.4e}", plain_vs_f64=f"{err_p:.4e}",
        kernel_vs_plain=f"{_rel_err(r_k, r_p):.4e}")

    params_b, gen_b = _seeded_net(3, (20, 20), 32)
    _residual_compare(params_b, _bench_data(jacobian=True), gen_b,
                      "burgers-kernels bench-jac w20x2 (nl off)",
                      kernels=jac, plains=plain)
    return out, pin, data.k * data.nq, data.k


def phase_burgers_train():
    """The main path of the slice: Adam at the front_2d recipe's mesh and width
    through K3 (launches rise every epoch, no other residual kernel runs, the
    loss falls); 20 epochs kernel vs plain from the seeded net; 20 epochs of the
    1-D traveling front with exact BC on the general path (K5)."""
    import torch

    from varnet_tpu_torch.ops import fused_residual as fr
    from varnet_tpu_torch.ops import value_and_jac as vj

    others = (fr.dir_residual_fwd, fr.dir_residual_ff_fwd, fr.dirp_residual_fwd,
              fr.dirp_residual_ff_fwd, vj.vj_fwd, vj.ff_vj_fwd)
    vn = _burgers_vn()
    first = vn.train(epoch_num=1, weight=WEIGHT, save_freq=1, verbose=False, error_disc=96)
    fr.jac_residual_fwd.launches = fr.jac_residual_bwd.launches = 0
    before = [f.launches for f in others]
    res = vn.train(epoch_num=BURG_EPOCHS, weight=WEIGHT, save_freq=BURG_EPOCHS, verbose=False,
                   error_disc=96)
    torch.cuda.synchronize()
    launches = {"fwd": fr.jac_residual_fwd.launches, "bwd": fr.jac_residual_bwd.launches}
    if min(launches.values()) < BURG_EPOCHS:
        raise AssertionError(f"K3 launches {launches} < 1 per epoch over {BURG_EPOCHS} epochs")
    if [f.launches for f in others] != before:
        raise AssertionError("another residual or value+jac kernel ran in the K3 Adam steps")
    loss0, loss_end = first.losses[0]["loss"], res.losses[-1]["loss"]
    if not (np.isfinite(loss_end) and loss_end < loss0):
        raise AssertionError(f"Burgers front_2d loss did not fall: {loss0} -> {loss_end}")
    log("burgers-train kernel", mesh="d32/t20/b32", epochs=BURG_EPOCHS,
        points=vn.static.n_test * vn.static.n_quad_per_test, jac_fwd=launches["fwd"],
        jac_bwd=launches["bwd"], loss_start=f"{loss0:.6e}", loss_end=f"{loss_end:.6e}",
        rel_l2=f"{res.errors[-1]:.4e}", steps_per_sec=f"{res.steps_per_sec:.4f}",
        quad_evals_per_sec=f"{res.quad_evals_per_sec:.6e}")

    runs = {}
    for fused in (True, False):
        v = _burgers_vn(use_fused_residual=fused, use_pallas=fused)
        runs[fused] = _losses(v.train(epoch_num=20, weight=WEIGHT, save_freq=1, verbose=False,
                                      error_disc=32, error_times=2))
    worst = float(np.max(np.abs(runs[True] - runs[False]) / np.abs(runs[False])))
    if not worst <= 2e-4:
        raise AssertionError(f"Burgers kernel vs plain 20-epoch trajectories differ by "
                             f"{worst:.3e}")
    log("burgers-train 20-epoch kernel vs plain", mesh="d32/t20/b32",
        max_rel_diff=f"{worst:.3e}", loss_end_kernel=f"{runs[True][-1]:.6e}",
        loss_end_plain=f"{runs[False][-1]:.6e}")

    vh = _burgers_vn("burgers_1d_transient", dict(nu=0.05, a=0.4, c=0.6), BURG_1D,
                     hard_bc=True)
    if vh._fused_kind is not None:
        raise AssertionError(f"hard BC + nl routes to {vh._fused_kind}, not the general path")
    first = vh.train(epoch_num=1, save_freq=1, verbose=False, error_disc=256)
    counts = lambda: (fr.jac_residual_fwd.launches, vj.vj_fwd.launches, vj.vj_bwd.launches)  # noqa: E731
    c0 = counts()
    rh = vh.train(epoch_num=20, save_freq=20, verbose=False, error_disc=256)
    c1 = counts()
    if not (c1[0] == c0[0] and min(c1[1] - c0[1], c1[2] - c0[2]) >= 20):
        raise AssertionError(f"hard Burgers did not take the general path through K5: "
                             f"{c0} -> {c1}")
    if not rh.losses[-1]["loss"] < first.losses[0]["loss"]:
        raise AssertionError(f"hard Burgers loss did not fall: {first.losses[0]['loss']} -> "
                             f"{rh.losses[-1]['loss']}")
    # K5 / K6 against their plain versions at the shape and inputs this run gave
    # K5: the trained net, the scaled 1-D points (n_in 2) and, for the backward,
    # the cotangent the hard loss (the nl term on the transformed u) hands it
    xs_t, g = _hard_vj_inputs(vh)
    hard_vj = _vj_compare(vh.theta, xs_t, 41, "kernels-vj burgers-hard1d w32x3", timed=True,
                          g=g)
    log("burgers-train hard 1-D general path", mesh="d48/t32", epochs=20,
        vj_fwd=c1[1] - c0[1], vj_bwd=c1[2] - c0[2], loss_start=f"{first.losses[0]['loss']:.6e}",
        loss_end=f"{rh.losses[-1]['loss']:.6e}", rel_l2=f"{rh.errors[-1]:.4e}",
        steps_per_sec=f"{rh.steps_per_sec:.4f}", points=xs_t.shape[1],
        **{f"k5k6_{k}_rel_err": f"{v['rel_err']:.4g}" for k, v in hard_vj.items()})
    return launches


def _hard_vj_inputs(vh):
    """(xs_t [n_in, P], g [1 + n_in, P]): the scaled points K5 sees in
    ``vh``'s hard-BC Adam step on the general path, and the cotangent of its
    output rows that the loss at ``vh.theta`` hands K5's backward."""
    from varnet_tpu_torch.fem.assembly import pad_points, pad_quad
    from varnet_tpu_torch.fem.hardbc import tables_to
    from varnet_tpu_torch.ops import value_and_jac as vj
    from varnet_tpu_torch.train.loss import make_loss_fn

    seen = {}

    def value_and_jac(theta, x, activation, scale, shift):
        # vj.value_and_jac's arithmetic, with K5's output as a leaf
        xs_t = ((x - shift) * scale).T.contiguous()
        out = vj.vj_fwd(theta, xs_t, activation).requires_grad_(True)
        seen.update(xs_t=xs_t, out=out)
        return out[0], (out[1:] * scale[:, None]).T

    loss_fn = make_loss_fn(vh.static, activation=vh.activation, has_react=vh.has_react,
                           device="cuda", value_and_jac=value_and_jac,
                           apply_fn=vh._apply_fn(), hard_mode=True, nl_vec=vh.nl_vec)
    quad_h = pad_quad(vh.fixed.quad, 1)
    ic = None if vh.fixed.ic is None else vh._to_device(pad_points(vh.fixed.ic, 1))
    total, _ = loss_fn(vh.theta, vh._to_device(quad_h), vh._to_device(pad_points(vh.fixed.bc, 1)),
                       ic, (1.0, 1.0, 1.0), hard=tables_to(vh._hard_tables(quad_h), "cuda"))
    total.backward()
    return seen["xs_t"], seen["out"].grad


def phase_burgers_accuracy():
    """The five pinned Burgers thetas re-score under their bounds on the card."""
    from varnet_tpu_torch import load_theta_npz

    out = {}
    for pin, (factory, kw, disc, bound) in BURG_PINS.items():
        hard = pin.endswith("_hard")
        mesh = dict(disc_num=8, t_disc_num=None if factory == "burgers_1d_steady" else 4)
        theta = load_theta_npz(os.path.join(RESULTS, f"theta_burgers_{pin}.npz"))
        err = _burgers_vn(factory, kw, mesh, hard_bc=hard).compute_error(theta, disc=disc,
                                                                         n_times=5)
        if not err < bound:
            raise AssertionError(f"theta_burgers_{pin} re-scores {err:.4e} >= {bound:g}")
        out[pin] = err
    log("burgers-accuracy", **{f"{k}_rel_l2": f"{v:.6e}" for k, v in out.items()})


def phase_burgers_lm():
    """K5 / K6 vs plain on one LM chunk of the front_2d mesh; 2 LM iterations
    from the pinned front_2d theta at the recipe's mesh on K5 / K6 with the
    nonlinear term, and the same on the plain path."""
    import torch

    from varnet_tpu_torch.fem.assembly import pad_quad
    from varnet_tpu_torch.ops import value_and_jac as vj

    theta = _pinned_burgers()
    # K5 / K6 against their plain versions at the pinned theta on one LM chunk of
    # the front_2d mesh: the shape (n_in 3, w32x3, K / k_chunks test functions)
    # that refine_lm gives them below
    vn = _burgers_vn()
    quad_c = pad_quad(vn.fixed.quad, BURG_LM["k_chunks"])
    kc = quad_c.coords.shape[0] // BURG_LM["k_chunks"]
    coords = torch.from_numpy(np.array(quad_c.coords[:kc], dtype=np.float32)).cuda()
    xs_t = ((coords.reshape(-1, coords.shape[-1]) - vn.shift) * vn.scale).T.contiguous()
    chunk = _vj_compare(theta, xs_t, 42, "kernels-vj burgers-front2d-chunk w32x3", timed=True)
    chunk_points = xs_t.shape[1]
    del coords, xs_t, vn
    torch.cuda.empty_cache()
    runs = {}
    for use_pallas in (True, False):
        vn = _burgers_vn(use_pallas=use_pallas)
        vn.theta = [{k: v.clone() for k, v in layer.items()} for layer in theta]
        if use_pallas:
            with torch.no_grad():
                start = _lm_loss(vn, theta, BURG_LM["k_chunks"])
            vj.vj_fwd.launches = vj.vj_bwd.launches = vj.vj_jvp.launches = 0
        t0 = time.perf_counter()
        res = vn.refine_lm(weight=WEIGHT, save_freq=1, verbose=False, error_disc=96,
                           error_times=5, **BURG_LM)
        torch.cuda.synchronize()
        runs[use_pallas] = (res, time.perf_counter() - t0)
        if use_pallas:
            launches = {"vj_fwd": vj.vj_fwd.launches, "vj_bwd": vj.vj_bwd.launches,
                        "vj_jvp": vj.vj_jvp.launches}
    rk, secs = runs[True]
    need = BURG_LM["steps"] * BURG_LM["cg_iters"]
    if min(launches.values()) < need:
        raise AssertionError(f"Burgers LM kernel launches {launches} < steps x cg_iters = {need}")
    lk, lp = _losses(rk), _losses(runs[False][0])
    if not (np.all(np.isfinite(lk)) and lk[0] <= start * (1 + 1e-5) and np.all(np.diff(lk) <= 0)):
        raise AssertionError(f"Burgers LM loss rose: start {start} -> {lk.tolist()}")
    if not rk.errors[-1] < 2e-4:
        raise AssertionError(f"Burgers LM rel-L2 {rk.errors[-1]:.4e} >= 2e-4")
    worst = float(np.max(np.abs(lk - lp) / np.abs(lp)))
    if not worst <= 2e-2:
        raise AssertionError(f"Burgers LM kernel vs plain losses differ by {worst:.3e}")
    per_it = (rk.wall_times[-1] - rk.wall_times[0]) / (BURG_LM["steps"] - 1)
    log("burgers-lm kernel", mesh="d32/t20/b32", **BURG_LM, loss_start=f"{start:.6e}",
        losses=",".join(f"{v:.6e}" for v in lk), rel_l2=f"{rk.errors[-1]:.6e}",
        s_per_iter=f"{per_it:.4f}", call_seconds=f"{secs:.3f}", **launches,
        chunk_points=chunk_points,
        **{f"chunk_{k}_{m}": f"{d[m]:.4g}" for k, d in chunk.items()
           for m in ("rel_err", "ms", "plain_ms")})
    log("burgers-lm plain", losses=",".join(f"{v:.6e}" for v in lp),
        rel_l2=f"{runs[False][0].errors[-1]:.6e}", call_seconds=f"{runs[False][1]:.3f}",
        max_rel_diff=f"{worst:.3e}")
    return launches


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for a kernel's work

PEAK_F32 = 67e12   # FLOP/s, f32 outside the tensor cores (H100 SXM data sheet)
HBM = 3.35e12      # bytes/s


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32, nbytes / HBM
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _flops(kind, widths, k0, panels, points, first_panels=None):
    """FLOPs of the layer products (2 per multiply-add) over ``points`` for a
    net with layer-0 input width k0 and hidden widths ``widths``, pushing
    ``panels`` panels: the forward; the backward = recompute + weight gradients
    + the cotangents of the hidden layers; the JVP = W s, W ds and dW s at the
    hidden and output layers, W s and dW s at layer 0 (its input has no
    tangent: the points and B are fixed).  ``first_panels``: the panels that
    need layer 0's product (K3: the value panel only; a unit tangent's
    layer-0 pre-activation is a column of W0).  The activations and the
    embedding's sin / cos are not counted."""
    hidden = sum(a * b for a, b in zip(widths[:-1], widths[1:]))
    first = 2 * (panels if first_panels is None else first_panels) * k0 * widths[0]
    rest = 2 * panels * (hidden + widths[-1])
    fwd = first + rest
    return points * {"fwd": fwd, "bwd": 2 * fwd + 2 * panels * hidden,
                     "jvp": 2 * first + 3 * rest}[kind]


def _n_params(widths, k0):
    sizes = [k0] + list(widths) + [1]
    return sum(a * b + b for a, b in zip(sizes[:-1], sizes[1:]))


def _bounds(kind, widths, k0, panels, points, n_in, n_k=None, n_fields=4, first_panels=None):
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
    return _bound(_flops(kind, widths, k0, panels, points, first_panels), nbytes)


def _entry(name, source, replaces, launches, nums, bound):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": nums["abs_err"], "ms": nums["ms"],
            "plain_ms": nums["plain_ms"], **bound, "library_ms": None}


def main():
    import torch

    t0 = time.perf_counter()
    phase_device()
    phase_build()
    k20 = phase_kernels((20, 20))
    phase_kernels((48, 48))
    phase_kernels((48, 48, 48))
    phase_kernels_nq1296()
    launches = phase_train()
    phase_accuracy()
    xs_t, nq = _bench_points()
    phase_kernels_vj((20, 20), xs_t)
    phase_kernels_vj((48, 48), xs_t)
    v48 = phase_kernels_vj((48, 48, 48), xs_t)
    lm_launches, lm_vn, lm_res = phase_lm(xs_t, nq)
    del xs_t
    torch.cuda.empty_cache()
    t_resume = time.perf_counter()
    phase_resume(lm_vn.theta, lm_res)
    del lm_vn
    resume_s = time.perf_counter() - t_resume
    torch.cuda.empty_cache()
    ff, p_ff, k_ff, p_chunk = phase_kernels_ff()
    ff_launches = phase_causal()
    phase_contaminant_accuracy()
    lm_ff_launches = phase_lm_ff()
    torch.cuda.empty_cache()
    vn3, hq3 = phase_hard_tables()
    dirp, dirp_wide, p_o2, k_o2 = phase_kernels_dirp(vn3, hq3)
    del hq3
    dirp_launches, wide_launches = phase_hard_train(vn3)
    phase_hard_accuracy()
    phase_hard_lm(vn3)
    p3, k3 = vn3.static.n_test * vn3.static.n_quad_per_test, vn3.static.n_test
    del vn3
    torch.cuda.empty_cache()
    t_burgers = time.perf_counter()
    jac, _, p_b, k_b = phase_burgers_kernels()
    jac_launches = phase_burgers_train()
    phase_burgers_accuracy()
    phase_burgers_lm()
    log("done", seconds=f"{time.perf_counter() - t0:.1f}",
        burgers_seconds=f"{time.perf_counter() - t_burgers:.1f}",
        resume_seconds=f"{resume_s:.1f}")

    p_bench, k_bench = k20["points"], k20["k"]
    src = "varnet_tpu_torch/csrc/"
    res_py, mlp_py = "varnet_tpu/ops/pallas_residual.py", "varnet_tpu/ops/pallas_mlp.py"
    ff_net = dict(widths=(96, 96, 96), k0=256, n_in=3)
    kernels = [
        _entry("dir_residual_fwd", src + "dir_residual.cu", res_py + ":1015", launches["fwd"],
               {"abs_err": k20["r_abs_err"], "ms": k20["fwd_ms"], "plain_ms": k20["fwd_plain_ms"]},
               _bounds("fwd", (20, 20), 3, 2, p_bench, 3, n_k=k_bench)),
        _entry("dir_residual_bwd", src + "dir_residual.cu", res_py + ":1015", launches["bwd"],
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
    ] + [
        # K4 reads xs, cdir (n_in rows each), csrc and cu: n_fields = n_in + 2
        _entry(f"dirp_residual_{kind}", src + "dir_residual.cu", res_py + ":1340",
               dirp_launches[kind], dirp[kind],
               _bounds(kind, (64, 64), 4, 2, p3, 4, n_k=k3, n_fields=6))
        for kind in ("fwd", "bwd")
    ] + [
        # K4 on ff_mlp.cu at the 2-D order-2 mesh: n_in 2, n_fields = n_in + 2
        _entry(f"dirp_residual_ff_{kind}", src + "ff_mlp.cu", res_py + ":1340",
               wide_launches[kind], dirp_wide[kind],
               _bounds(kind, HARD_WIDE, 2, 2, p_o2, 2, n_k=k_o2, n_fields=4))
        for kind in ("fwd", "bwd")
    ] + [
        # K3 pushes 1 + n_in panels and reads 2 + d field rows (kappa, vel, src)
        _entry(f"jac_residual_{kind}", src + "ff_mlp.cu", res_py + ":611",
               jac_launches[kind], jac[kind],
               _bounds(kind, BURG_NET, 3, 4, p_b, 3, n_k=k_b, n_fields=4, first_panels=1))
        for kind in ("fwd", "bwd")
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
