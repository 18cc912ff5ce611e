"""Levenberg-Marquardt traffic: ``VarNet.refine_lm`` with a recipe's CG settings.

Set-up drives the program from the seed's weights through ``checked_steps``
iterations of the window's own call (reporting every iteration, so each
iteration's loss and damping are read), catching at the call's first
linearisation the two products that the CG solve starts from, as the program
computes them: J^T r (the value + jacobian kernels' backward) and J^T (J b)
with b = -J^T r (the forward-mode J v, then the backward again).  Their time
sizes the window to about ``--seconds`` of whole iterations.  The window is
one call of S iterations, reporting at the recipe's period.  The reference
follows the checked iterations from the same weights.  An LM iteration's work
is fixed: CG runs exactly ``cg_iters`` iterations, so the rate counts
S x cg_iters.
"""

from __future__ import annotations

import contextlib
import math
import time

import torch

from portbench import compare, faults
from portbench.harness import reference_setup, theta_pairs
from portbench.reference import loss as ref_loss
from portbench.reference import optim as ref_optim
from portbench.reference.model import TF32


FAULTS = ("unchanged_state", "half_batch", "altered_answer", "altered_jvp", "altered_vjp")


def varnet_kwargs(cell):
    return {}


def _call(cell, vn, steps, save_freq):
    cfg, p = cell.config, cell.workload["params"]
    return vn.refine_lm(steps=int(steps), weight=tuple(cfg["weight"]),
                        cg_iters=int(p["cg_iters"]), cg_segment=int(p["cg_segment"]),
                        k_chunks=int(p["k_chunks"]), lam0=float(p["lam0"]),
                        save_freq=int(save_freq), verbose=False,
                        error_disc=cfg["error_disc"], error_times=cfg["error_times"])


@contextlib.contextmanager
def _first_products(caught):
    """Record the first two J^T w products of the call's first linearisation
    (J^T r, then J^T (J b) in CG's first iteration), leaving them unchanged."""
    from varnet_tpu_torch.train import gauss_newton

    linearize, linearized = gauss_newton.linearize, []

    def recording(closure, flat):
        r, pullback = linearize(closure, flat)
        if linearized:
            return r, pullback
        linearized.append(True)

        def pullback_recorded(w):
            out = pullback(w)
            if len(caught) < 2:
                caught.append(out.detach().clone())
            return out

        return r, pullback_recorded

    with faults.patched((gauss_newton, "linearize", recording)):
        yield


def _as_pairs(vn, flat):
    """The program's raveled vector as (W, b) per layer, by its own ravel."""
    from varnet_tpu_torch.models.mlp import ravel_params

    return theta_pairs(ravel_params(vn.theta)[1](flat))


def checked(cell, vn):
    """The first iterations of the window's call: the loss and damping after
    each, J^T r and J^T (J b) at the start, the parameters before and after,
    and the time of an iteration."""
    before = theta_pairs(vn.theta)
    n = int(cell.workload["params"]["checked_steps"])
    caught = []
    t = time.perf_counter()
    with _first_products(caught):
        res = _call(cell, vn, n, 1)
    if vn.device.type == "cuda":
        torch.cuda.synchronize(vn.device)
    products = [_as_pairs(vn, v) for v in caught] + [None, None]
    # the call's report times after its first iteration leave out the call's
    # first-use costs, which the window does not pay again
    times = res.wall_times
    per_step = ((times[-1] - times[0]) / (len(times) - 1) if len(times) > 1
                else (time.perf_counter() - t) / n)
    return {"losses": [float(l["loss"]) for l in res.losses],
            "lams": [float(l["lam"]) for l in res.losses],
            "jtr": products[0], "jtjb": products[1],
            "before": before, "after": theta_pairs(vn.theta), "seconds_per_step": per_step}


def size(cell, vn, seconds, first):
    """Whole iterations in about ``seconds``."""
    return max(1, round(float(seconds) / first["seconds_per_step"]))


def window(cell, vn, steps):
    return _call(cell, vn, steps, int(cell.workload["params"]["save_freq"]))


def window_finite(res):
    return bool(res.losses) and all(math.isfinite(l["loss"]) for l in res.losses)


def work_units(cell, steps):
    return int(steps) * int(cell.workload["params"]["cg_iters"])


def rates(cell, steps, elapsed):
    return {"lm_cg_iters_per_s": work_units(cell, steps) / elapsed}


def reference(cell, params0, device, control=False, setup=None):
    """The reference's checked iterations from the same weights; ``control``
    runs them with TF32 matrix products."""
    s = setup or reference_setup(cell, device)
    p = cell.workload["params"]
    with TF32() if control else contextlib.nullcontext():
        out = ref_optim.lm(params0, s, int(p["checked_steps"]), int(p["cg_iters"]),
                           float(p["lam0"]))
    # "jtr": the reference's J^T r where it stands in the program's place
    return {**out, "jtr": out["grad"], "before": params0}


def _products_gap(prog, ref):
    if prog is None:
        return math.inf
    return compare.leaf_gap(compare.norms(prog), compare.norms(ref))


def compare_numbers(cell, prog, ref, setup):
    """J^T r and J^T (J b) at the start parameters against the reference's, by
    the worst leaf (the products CG starts from, before it amplifies any
    rounding); the loss the program reports after its last checked iteration
    against the reference's loss at the program's parameters there; the damping
    after each iteration (exact); the parameters' change against the
    reference's, by the median leaf.  Two numbers of the Adam traffic read the
    CG solve's amplified rounding here, so they are not compared (PERF.md, "How
    correct is decided"): the reported loss along the two trajectories (a small
    remainder of a large loss after the solve) and the worst leaf's change (the
    output bias, whose change is a fortieth of the median leaf's)."""
    keep = compare.moving(ref["grad"])
    at_prog = float(ref_loss.loss(prog["after"], setup))
    return {"jtr_gap": _products_gap(prog["jtr"], ref["grad"]),
            "jtjb_gap": _products_gap(prog["jtjb"], ref["jtjb"]),
            "loss_eval_gap": compare.loss_gap(prog["losses"][-1:], [at_prog]),
            "lam_mismatch": 0.0 if prog["lams"] == ref["lams"] else 1.0,
            "median_change_gap": compare.median_leaf_gap(
                compare.change(prog["after"], prog["before"]),
                compare.change(ref["after"], ref["before"]), keep)}
