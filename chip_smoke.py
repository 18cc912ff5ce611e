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
    source = "varnet_tpu_torch/csrc/dir_residual.cu"
    vj_source = "varnet_tpu_torch/csrc/value_and_jac.cu"
    vj_replaces = {"fwd": "varnet_tpu/ops/pallas_mlp.py:266",
                   "bwd": "varnet_tpu/ops/pallas_mlp.py:825",
                   "jvp": "varnet_tpu/ops/pallas_mlp.py:508"}
    print(json.dumps({"kernels": [
        {"name": "dir_residual_fwd", "route": "cuda", "source": source,
         "replaces": "varnet_tpu/ops/pallas_residual.py:788", "launches": launches["fwd"],
         "max_abs_err": k20["r_abs_err"], "ms": k20["fwd_ms"], "plain_ms": k20["fwd_plain_ms"]},
        {"name": "dir_residual_bwd", "route": "cuda", "source": source,
         "replaces": "varnet_tpu/ops/pallas_residual.py:820", "launches": launches["bwd"],
         "max_abs_err": k20["g_abs_err"], "ms": k20["bwd_ms"], "plain_ms": k20["bwd_plain_ms"]},
    ] + [
        {"name": f"vj_{k}", "route": "cuda", "source": vj_source, "replaces": vj_replaces[k],
         "launches": lm_launches[f"vj_{k}"], "max_abs_err": v48[k]["abs_err"],
         "ms": v48[k]["ms"], "plain_ms": v48[k]["plain_ms"]} for k in ("fwd", "bwd", "jvp")
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
