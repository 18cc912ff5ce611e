"""Adam traffic: ``VarNet.train`` on the full batch, as a recipe's Adam stage runs it.

Set-up drives the program from the seed's weights through ``checked_steps``
steps of the window's own call (reporting every step, so each step's loss is
read), catching the gradient the optimizer gets at the first step; then timed
calls of doubling length size the window to about ``--seconds``.  The window is
one call of E epochs, reporting at the recipe's period.  The reference follows
the checked steps from the same weights.
"""

from __future__ import annotations

import contextlib
import time

import torch
import torch.optim.optimizer as torch_optimizer

from portbench import compare
from portbench.harness import reference_setup, theta_pairs
from portbench.reference import optim as ref_optim
from portbench.reference.model import TF32

PROBE_SECONDS = 1.0
FAULTS = ("unchanged_state", "half_batch", "altered_answer")


def varnet_kwargs(cell):
    from varnet_tpu_torch.train.optim import OptimizerConfig

    return {"optimizer": OptimizerConfig(lr=float(cell.workload["params"]["lr"]))}


def _call(cell, vn, epochs, save_freq):
    cfg, p = cell.config, cell.workload["params"]
    return vn.train(epoch_num=int(epochs), weight=tuple(cfg["weight"]),
                    batch_num=int(p["batch_num"]), save_freq=int(save_freq), verbose=False,
                    error_disc=cfg["error_disc"], error_times=cfg["error_times"])


def _pairs(leaves):
    """(W, b) per layer from a flat list of leaves in any order of weights and
    biases within a layer: weights and biases each keep their layer order."""
    ws = [t for t in leaves if t.dim() == 2]
    bs = [t for t in leaves if t.dim() == 1]
    return list(zip(ws, bs))


def checked(cell, vn):
    """The first steps of the window's call: their losses, the first gradient
    as the optimizer gets it, and the parameters before and after."""
    grads = []

    def first_grad(opt, args, kwargs):
        if not grads:
            grads.append([p.grad.detach().clone() for g in opt.param_groups for p in g["params"]])

    before = theta_pairs(vn.theta)
    n = int(cell.workload["params"]["checked_steps"])
    handle = torch_optimizer.register_optimizer_step_post_hook(first_grad)
    try:
        res = _call(cell, vn, n, 1)
    finally:
        handle.remove()
    return {"losses": [float(l["loss"]) for l in res.losses],
            "grad": _pairs(grads[0]) if grads else None,
            "before": before, "after": theta_pairs(vn.theta)}


def size(cell, vn, seconds, first):
    """Epochs in the window: calls of doubling length until two have run and
    the last lasted ``PROBE_SECONDS``; the last two give the time of an epoch and
    of the call around it (data preparation, reports), and the window is the
    epochs that fill ``seconds`` beside the call's own time."""
    probes, n = [], 2
    while True:
        t = time.perf_counter()
        _call(cell, vn, n, n)
        if vn.device.type == "cuda":
            torch.cuda.synchronize(vn.device)
        probes.append((n, time.perf_counter() - t))
        if (len(probes) >= 2 and probes[-1][1] >= PROBE_SECONDS) or n >= 1 << 16:
            break
        n *= 2
    (n0, t0), (n1, t1) = probes[-2], probes[-1]
    per_epoch = (t1 - t0) / (n1 - n0)
    if per_epoch <= 0:
        per_epoch, t0 = t1 / n1, 0.0
    call = max(t1 - n1 * per_epoch, 0.0)
    return max(2, round((float(seconds) - call) / per_epoch))


def window(cell, vn, epochs):
    frac = float(cell.workload["params"]["report_every"])
    return _call(cell, vn, epochs, max(int(epochs * frac), 1))


def window_finite(res):
    return bool(res.losses) and all(torch.isfinite(torch.tensor(l["loss"])) for l in res.losses)


def work_units(cell, epochs):
    return int(epochs) * int(cell.workload["params"]["batch_num"])


def rates(cell, epochs, elapsed):
    return {"adam_steps_per_s": work_units(cell, epochs) / elapsed}


def reference(cell, params0, device, control=False, setup=None):
    """The reference's checked steps from the same weights; ``control`` runs
    them with TF32 matrix products."""
    s = setup or reference_setup(cell, device)
    p = cell.workload["params"]
    with TF32() if control else contextlib.nullcontext():
        losses, grad, after = ref_optim.adam(params0, s, int(p["checked_steps"]), float(p["lr"]))
    return {"losses": losses, "grad": grad, "before": params0, "after": after}


def compare_numbers(cell, prog, ref, setup):
    keep = compare.moving(ref["grad"])
    grad = (compare.leaf_gap(compare.norms(prog["grad"]), compare.norms(ref["grad"]))
            if prog["grad"] is not None else float("inf"))
    return {"loss_gap": compare.loss_gap(prog["losses"], ref["losses"]),
            "grad_gap": grad,
            "change_gap": compare.leaf_gap(compare.change(prog["after"], prog["before"]),
                                           compare.change(ref["after"], ref["before"]), keep)}

