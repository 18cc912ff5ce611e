"""Variational (weak-form) total loss: the penalty form of
``varnet_tpu/train/loss.py`` and its exact-BC/IC form (``hard_mode``).

    L(theta) = w_int * mean_k |r_k / vol_k|^2
             + w_bc  * mean_bc |u - g|^2
             + w_ic  * mean_ic |u - u0|^2

The interior residual comes either from the fused residual (kernel on CUDA
tensors, its plain version on CPU ones) or from the general path (value +
input jacobian, then the weak-form contraction).  In hard mode the trial
function is u = A + B n (``fem/hardbc.py``): BC and IC hold exactly, their
rows drop out (reported as 0.0), and the interior residual is that of the
transformed u, folded into K4's coefficients on the fused path and applied
by ``hard_transform`` on the general path.  Nonlinear advection (``nl_vec``,
the viscous-Burgers term u (b . grad u)) rides the jacobian-panel residual K3 on
the fused path (``prepare_residual_data(nl_vec=)``) and ``weak_residual`` on the
general path, where in hard mode it takes the transformed u.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..fem.assembly import ProblemStatic
from ..fem.hardbc import hard_transform
from ..models.mlp import make_input_scaling, mlp_apply, mlp_value_and_jac
from ..ops.fused_residual import CoeffData, fused_residual
from ..ops.residual import masked_mse, masked_sum_sq, support_volume, weak_residual

# make_loss_fn options of the JAX package that the port does not carry yet
# argument -> the feature it needs, not ported yet
UNPORTED = {
    "source_fn": "the trainable source of the inverse source problem",
    "diff_fn": "the trainable diffusivity of the inverse coefficient problem",
    "vel_fn": "the trainable velocity of the inverse coefficient problem",
    "has_obs": "observation rows",
}


def make_loss_fn(
    static: ProblemStatic,
    activation: str = "tanh",
    has_react: bool = False,
    fused: bool = False,
    device=None,
    input_scaling: bool = True,
    value_and_jac: Callable = mlp_value_and_jac,
    apply_fn: Callable = mlp_apply,
    hard_mode: bool = False,
    nl_vec=None,
    **unported,
):
    """Build ``loss_fn(theta, quad, bc, ic=None, weights=(1, 1, 1),
    prepared=None, hard=None) -> (total, aux)`` for an assembled problem
    whose arrays (QuadData / PointData of tensors) live on ``device``.

    ``fused``: the interior residual goes through ``fused_residual`` on
    ``prepared``, the data from ``prepare_residual_data`` or, for per-node
    test tables and exact BC, ``prepare_residual_coeffs`` (the trainer builds
    it once per ``train`` call); otherwise through the general path on
    ``quad`` with ``value_and_jac`` (``mlp_value_and_jac``, or the kernel
    path of ``ops/value_and_jac.py``).  ``apply_fn`` evaluates the net at the
    BC/IC points (``ff_apply`` for a Fourier-feature net).
    ``input_scaling``: inputs scaled onto [-1, 1] as in the JAX package;
    False feeds raw coordinates.
    ``hard_mode``: exact BC/IC.  ``hard`` is then the HardQuad of tensors at
    the quad coords (general path); the fused path needs ``prepared`` built
    with those tables folded in (``prepare_residual_coeffs(hard=)``).
    ``nl_vec``: the constant [d] Burgers direction b of the nonlinear
    advection term (None: a linear problem); the fused path needs
    ``prepared`` built with it (``prepare_residual_data(nl_vec=)``, K3).
    Observation and flux rows are not ported (``UNPORTED``).
    """
    unknown = sorted(set(unported) - set(UNPORTED))
    if unknown:
        raise TypeError(f"make_loss_fn got unexpected arguments {unknown}")
    asked = sorted(k for k, v in unported.items() if v not in (None, False))
    if asked:
        raise NotImplementedError("not ported to varnet_tpu_torch yet: " + "; ".join(
            f"{UNPORTED[k]} ({k})" for k in asked))
    d = static.n_space
    td = static.time_dependent
    n_in = static.n_inputs
    n_bc = float(max(static.n_bc, 1))
    n_ic = float(max(static.n_ic, 1))
    scale = shift = None
    if input_scaling:
        scale, shift = make_input_scaling(static.input_lo, static.input_hi, device=device)
    nl = (None if nl_vec is None
          else torch.as_tensor(np.asarray(nl_vec), dtype=torch.float32, device=device))
    need_u = has_react or nl is not None

    def loss_fn(theta, quad, bc, ic=None, weights=(1.0, 1.0, 1.0), prepared=None,
                hard=None):
        k, nq = quad.coords.shape[0], quad.coords.shape[1]
        if fused:
            if hard_mode and not isinstance(prepared, CoeffData):
                raise ValueError("hard_mode on the fused path needs the precoeff data "
                                 "with the exact-BC tables folded in (prepare_residual_coeffs)")
            if nl is not None and getattr(prepared, "nl", None) is None:
                raise ValueError("nl_vec on the fused path needs the jacobian-panel data "
                                 "with the Burgers direction (prepare_residual_data(nl_vec=))")
            r = fused_residual(theta, prepared, activation)
        else:
            flat = quad.coords.reshape(k * nq, n_in)
            u, du = value_and_jac(theta, flat, activation, scale, shift)
            grad_u = du[:, :d].reshape(k, nq, d)
            u_t = du[:, d].reshape(k, nq) if td else None
            u = u.reshape(k, nq)
            if hard_mode:
                u, grad_u, u_t = hard_transform(u, grad_u, u_t, hard)
            r = weak_residual(
                grad_u, quad.N, quad.dN, quad.w, quad.kappa, quad.vel, quad.src, u_t,
                u=u if need_u else None,
                react=quad.react if has_react else None,
                nl_vec=nl,
            )
        # r_k scales with the test-function support volume (per node for
        # per-node tables); the mean over the real test-function count makes
        # the loss mesh-size independent
        r = r / support_volume(quad.w)
        loss_int = masked_sum_sq(r, quad.mask) / float(max(static.n_test, 1))

        if hard_mode:  # exact by construction; the aux keys stay for logging
            loss_bc = torch.zeros_like(loss_int)
        else:
            u_bc = apply_fn(theta, bc.coords, activation, scale, shift)
            loss_bc = masked_mse(u_bc, bc.values, bc.mask, n_bc)
        total = weights[0] * loss_int + weights[1] * loss_bc
        aux = {"loss_int": loss_int, "loss_bc": loss_bc}
        if ic is not None:
            if hard_mode:
                loss_ic = torch.zeros_like(loss_int)
            else:
                u_ic = apply_fn(theta, ic.coords, activation, scale, shift)
                loss_ic = masked_mse(u_ic, ic.values, ic.mask, n_ic)
                total = total + weights[2] * loss_ic
            aux["loss_ic"] = loss_ic
        aux["loss"] = total
        return total, aux

    return loss_fn
