"""Variational (weak-form) total loss: the penalty form of
``varnet_tpu/train/loss.py``.

    L(theta) = w_int * mean_k |r_k / vol|^2
             + w_bc  * mean_bc |u - g|^2
             + w_ic  * mean_ic |u - u0|^2

The interior residual comes either from the fused residual (kernel on CUDA
tensors, its plain version on CPU ones) or from the general path (value +
input jacobian, then the weak-form contraction).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..fem.assembly import ProblemStatic
from ..models.mlp import make_input_scaling, mlp_apply, mlp_value_and_jac
from ..ops.fused_residual import fused_residual
from ..ops.residual import masked_mse, masked_sum_sq, weak_residual

# make_loss_fn options of the JAX package that the port does not carry yet
UNPORTED = ("source_fn", "diff_fn", "vel_fn", "has_obs", "nl_vec", "hard_mode")


def make_loss_fn(
    static: ProblemStatic,
    activation: str = "tanh",
    has_react: bool = False,
    fused: bool = False,
    device=None,
    input_scaling: bool = True,
    value_and_jac: Callable = mlp_value_and_jac,
    apply_fn: Callable = mlp_apply,
    **unported,
):
    """Build ``loss_fn(theta, quad, bc, ic=None, weights=(1, 1, 1),
    prepared=None) -> (total, aux)`` for an assembled problem whose arrays
    (QuadData / PointData of tensors) live on ``device``.

    ``fused``: the interior residual goes through ``fused_residual`` on
    ``prepared``, the data from ``prepare_residual_data`` (the trainer builds
    it once per ``train`` call); otherwise through the general path on
    ``quad`` with ``value_and_jac`` (``mlp_value_and_jac``, or the kernel
    path of ``ops/value_and_jac.py``).  ``apply_fn`` evaluates the net at the
    BC/IC points (``ff_apply`` for a Fourier-feature net).
    ``input_scaling``: inputs scaled onto [-1, 1] as in the JAX package;
    False feeds raw coordinates.
    """
    unknown = sorted(set(unported) - set(UNPORTED))
    if unknown:
        raise TypeError(f"make_loss_fn got unexpected arguments {unknown}")
    asked = sorted(k for k, v in unported.items() if v not in (None, False))
    if asked:
        raise NotImplementedError(f"not ported to varnet_tpu_torch yet: {asked}")
    d = static.n_space
    td = static.time_dependent
    n_in = static.n_inputs
    n_bc = float(max(static.n_bc, 1))
    n_ic = float(max(static.n_ic, 1))
    scale = shift = None
    if input_scaling:
        scale, shift = make_input_scaling(static.input_lo, static.input_hi, device=device)

    def loss_fn(theta, quad, bc, ic=None, weights=(1.0, 1.0, 1.0), prepared=None):
        k, nq = quad.coords.shape[0], quad.coords.shape[1]
        if fused:
            r = fused_residual(theta, prepared, activation)
        else:
            flat = quad.coords.reshape(k * nq, n_in)
            u, du = value_and_jac(theta, flat, activation, scale, shift)
            grad_u = du[:, :d].reshape(k, nq, d)
            u_t = du[:, d].reshape(k, nq) if td else None
            r = weak_residual(
                grad_u, quad.N, quad.dN, quad.w, quad.kappa, quad.vel, quad.src, u_t,
                u=u.reshape(k, nq) if has_react else None,
                react=quad.react if has_react else None,
            )
        # r_k scales with the test-function support volume; the mean over the
        # real test-function count makes the loss mesh-size independent
        r = r / torch.sum(quad.w)
        loss_int = masked_sum_sq(r, quad.mask) / float(max(static.n_test, 1))

        u_bc = apply_fn(theta, bc.coords, activation, scale, shift)
        loss_bc = masked_mse(u_bc, bc.values, bc.mask, n_bc)
        total = weights[0] * loss_int + weights[1] * loss_bc
        aux = {"loss_int": loss_int, "loss_bc": loss_bc}
        if ic is not None:
            u_ic = apply_fn(theta, ic.coords, activation, scale, shift)
            loss_ic = masked_mse(u_ic, ic.values, ic.mask, n_ic)
            total = total + weights[2] * loss_ic
            aux["loss_ic"] = loss_ic
        aux["loss"] = total
        return total, aux

    return loss_fn
