#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``varnet_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments:  ``python3 chip_smoke.py``.

Phases (each prints one line of numbers; any failure raises, so the exit code
is non-zero and no result line is printed):

1. device   -- requires CUDA (no CPU fallback); prints the card's name and power limit.
2. build    -- builds the fused-residual kernel from ``varnet_tpu_torch/csrc``.
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
BENCH = dict(disc_num=48, b_disc_num=48, t_disc_num=32)
WEIGHT = (1.0, 10.0, 10.0)
R_RTOL, G_RTOL = 1e-5, 1e-4      # r: f32 q-sums; grads: sums over ~4.4M points


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
    from varnet_tpu_torch.ops import fused_residual as fr

    t0 = time.perf_counter()
    lib = fr.load_library()
    secs = time.perf_counter() - t0
    build_log = (fr.BUILD_DIR / fr._source_hash() / "build.log").read_text()
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)
    log("build", seconds=f"{secs:.3f}", library=lib._name)


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
        "r_rel_err": r_err, "g_rel_err": g_err, "r_abs_err": r_abs, "g_abs_err": g_abs,
        "fwd_ms": _median_ms(lambda: fr.dir_residual_fwd(params, data, "tanh")),
        "fwd_plain_ms": _median_ms(lambda: fr.dir_residual_fwd_plain(params, data, "tanh")),
        "bwd_ms": _median_ms(lambda: fr.dir_residual_bwd(params, data, "tanh", gr)),
        "bwd_plain_ms": _median_ms(
            lambda: fr.dir_residual_bwd_plain(params, data, "tanh", gr)),
    }
    log(f"kernels w{'x'.join(map(str, widths))}", points=data.k * data.nq,
        **{k: f"{v:.4g}" for k, v in out.items()})
    return out


def _train(widths, theta, epochs, save_freq, fused):
    import torch

    from varnet_tpu_torch import VarNet
    from varnet_tpu_torch.problems.analytic import transient_ad_2d

    vn = VarNet(transient_ad_2d()["pde"], layer_width=widths, device="cuda",
                use_fused_residual=fused, **BENCH)
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


def main():
    import torch

    phase_device()
    phase_build()
    k20 = phase_kernels((20, 20))
    phase_kernels((48, 48, 48))
    launches = phase_train()
    phase_accuracy()
    source = "varnet_tpu_torch/csrc/dir_residual.cu"
    print(json.dumps({"kernels": [
        {"name": "dir_residual_fwd", "route": "cuda", "source": source,
         "replaces": "varnet_tpu/ops/pallas_residual.py:788", "launches": launches["fwd"],
         "max_abs_err": k20["r_abs_err"], "ms": k20["fwd_ms"], "plain_ms": k20["fwd_plain_ms"]},
        {"name": "dir_residual_bwd", "route": "cuda", "source": source,
         "replaces": "varnet_tpu/ops/pallas_residual.py:820", "launches": launches["bwd"],
         "max_abs_err": k20["g_abs_err"], "ms": k20["bwd_ms"], "plain_ms": k20["bwd_plain_ms"]},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
