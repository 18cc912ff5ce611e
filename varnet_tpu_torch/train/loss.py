"""Variational (weak-form) total loss: the penalty form of
``varnet_tpu/train/loss.py`` and its exact-BC/IC form (``hard_mode``).

    L(theta) = w_int * mean_k |r_k / vol_k|^2       (or sum_k r_k^2 unnormalized)
             + w_bc  * mean_bc |u - g|^2
             + w_ic  * mean_ic |u - u0|^2
             + w_bc  * mean_neu |alpha u + dirs . grad u - g_n|^2   (Neumann/Robin)
             + w_obs * mean_obs |u - u_obs|^2                       (inverse problems)

The interior residual comes either from the fused residual (kernel on CUDA
tensors, its plain version on CPU ones) or from the general path (value +
input jacobian, then the weak-form contraction).  In hard mode the trial
function is u = A + B n (``fem/hardbc.py``): BC and IC hold exactly, their
rows drop out (reported as 0.0), and the interior residual is that of the
transformed u, folded into K4's coefficients on the fused path and applied
by ``hard_transform`` on the general path; flux and observation rows then
compare the transformed u too.  Nonlinear advection (``nl_vec``, the
viscous-Burgers term u (b . grad u)) rides the jacobian-panel residual K3 on
the fused path (``prepare_residual_data(nl_vec=)``) and ``weak_residual`` on the
general path, where in hard mode it takes the transformed u.

Inverse problems train more than the net: theta is then ``{'net': [...],
'src': phi, 'kap': psi, 'vel': phi}`` with a hook per trainable field
(``source_fn`` / ``diff_fn`` / ``vel_fn``, each ``f(leaf, x, t)``).  The
source enters the weak form linearly, so on the fused path the kernel
integrates with ``quad.src`` zeroed (the caller prepares it so) and the loss
subtracts sum_q w N s_phi outside it; a trainable kappa or velocity multiplies
terms the kernels bake into their data, so those ride the general path only.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..fem.assembly import ProblemStatic
from ..fem.hardbc import hard_transform
from ..models.mlp import make_input_scaling, mlp_apply, mlp_value_and_jac, net_of
from ..ops.fused_residual import CoeffData, fused_residual
from ..ops.residual import (
    hook_fields,
    masked_mse,
    masked_sum_sq,
    support_volume,
    weak_residual,
)


def flux_error(net, neu, d: int, activation, scale, shift, value_and_jac=mlp_value_and_jac,
               hard_neu=None):
    """alpha u + dirs . grad u - g at the flux points of ``neu`` (a FluxData of
    tensors; alpha 0 for Neumann), unmasked; ``hard_neu`` (a HardQuad at the
    flux coords) puts the transformed u in.  The batch is BC-sized, so it takes
    ``value_and_jac``'s plain matmul chain even when the interior runs on a
    kernel, as the JAX package's does."""
    u, du = value_and_jac(net, neu.coords, activation, scale, shift)
    grad = du[:, :d]
    if hard_neu is not None:
        grad = hard_neu.dA + hard_neu.dB * u[:, None] + hard_neu.B[:, None] * grad
        u = hard_neu.A + hard_neu.B * u
    return torch.sum(grad * neu.dirs, dim=-1) + neu.alpha * u - neu.values


def obs_values(net, obs, apply_fn, activation, scale, shift, hard_obs=None):
    """u at the observation points (the transformed u with ``hard_obs``, the
    HardPts at their coords)."""
    u = apply_fn(net, obs.coords, activation, scale, shift)
    return u if hard_obs is None else hard_obs.A + hard_obs.B * u


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
    source_fn: Optional[Callable] = None,
    diff_fn: Optional[Callable] = None,
    vel_fn: Optional[Callable] = None,
    has_obs: bool = False,
    n_obs_real: int = 1,
    flux_value_and_jac: Optional[Callable] = None,
    normalize_residual: bool = True,
    dtype=torch.float32,
):
    """Build ``loss_fn(theta, quad, bc, ic=None, weights=(1, 1, 1), prepared=None,
    hard=None, obs=None, neu=None, hard_obs=None, hard_neu=None) -> (total, aux)``
    for an assembled problem whose arrays (QuadData / PointData / FluxData of
    tensors) live on ``device``.

    ``fused``: the interior residual goes through ``fused_residual`` on
    ``prepared``, the data from ``prepare_residual_data`` or, for per-node
    test tables and exact BC, ``prepare_residual_coeffs`` (the trainer builds
    it once per ``train`` call); otherwise through the general path on
    ``quad`` with ``value_and_jac`` (``mlp_value_and_jac``, or the kernel
    path of ``ops/value_and_jac.py``).  ``apply_fn`` evaluates the net at the
    BC/IC/observation points (``ff_apply`` for a Fourier-feature net).
    ``input_scaling``: inputs scaled onto [-1, 1] as in the JAX package;
    False feeds raw coordinates.
    ``hard_mode``: exact BC/IC.  ``hard`` is then the HardQuad of tensors at
    the quad coords (general path); the fused path needs ``prepared`` built
    with those tables folded in (``prepare_residual_coeffs(hard=)``);
    ``hard_obs`` / ``hard_neu`` are the tables at the observation (HardPts)
    and flux (HardQuad) coords.
    ``nl_vec``: the constant [d] Burgers direction b of the nonlinear
    advection term (None: a linear problem); the fused path needs
    ``prepared`` built with it (``prepare_residual_data(nl_vec=)``, K3).
    ``neu`` (a FluxData): the Neumann/Robin flux penalty, sharing the weight
    w_bc, through ``flux_value_and_jac`` (the plain matmul chain by default).
    ``source_fn`` / ``diff_fn`` / ``vel_fn``: trainable source, diffusivity
    and velocity hooks (module docstring); a fused path takes the source only,
    with ``prepared`` built from a zeroed ``quad.src``.
    ``has_obs``: observation rows against ``obs``, over ``n_obs_real`` real
    points, weighted by ``weights[3]`` (weights is then the 4-slot vector).
    ``normalize_residual``: r_k divided by its test function's support volume
    and the sum of squares by the real test-function count (the default);
    False gives the reference's raw masked sum of r_k^2.  Either way outside
    the kernels.
    ``dtype``: that of the input scaling and the Burgers direction (the data's).
    """
    if fused and (diff_fn is not None or vel_fn is not None):
        # the fused kernels integrate the FIXED kappa / velocity: accepting a
        # trainable one would give its leaf exactly zero gradient, silently
        raise ValueError("the fused residual is incompatible with trainable diff_fn/vel_fn")
    d = static.n_space
    td = static.time_dependent
    n_in = static.n_inputs
    n_bc = float(max(static.n_bc, 1))
    n_ic = float(max(static.n_ic, 1))
    n_obs = float(max(int(n_obs_real), 1))
    n_neu = float(max(static.n_neu, 1))
    scale = shift = None
    if input_scaling:
        scale, shift = make_input_scaling(static.input_lo, static.input_hi, dtype=dtype,
                                          device=device)
    nl = (None if nl_vec is None
          else torch.as_tensor(np.asarray(nl_vec), dtype=dtype, device=device))
    need_u = has_react or nl is not None
    flux_vj = flux_value_and_jac or mlp_value_and_jac

    def loss_fn(theta, quad, bc, ic=None, weights=(1.0, 1.0, 1.0), prepared=None,
                hard=None, obs=None, neu=None, hard_obs=None, hard_neu=None):
        if has_obs and len(weights) < 4:
            # a 3-vector has no observation slot: refuse rather than reuse w_ic
            raise ValueError("has_obs requires a 4th (observation) loss weight")
        if has_obs and obs is None:
            raise ValueError("has_obs=True but the obs batch is None")
        net = net_of(theta)
        k, nq = quad.coords.shape[0], quad.coords.shape[1]
        if fused:
            if hard_mode and not isinstance(prepared, CoeffData):
                raise ValueError("hard_mode on the fused path needs the precoeff data "
                                 "with the exact-BC tables folded in (prepare_residual_coeffs)")
            if nl is not None and getattr(prepared, "nl", None) is None:
                raise ValueError("nl_vec on the fused path needs the jacobian-panel data "
                                 "with the Burgers direction (prepare_residual_data(nl_vec=))")
            r = fused_residual(net, prepared, activation)
            if source_fn is not None:
                # the kernel integrated a zeroed quad.src: the trainable source's
                # -sum_q w N s term, outside the kernel
                _, _, src = hook_fields(theta, quad.coords.reshape(k * nq, n_in), d, td,
                                        None, None, quad.src, source_fn=source_fn)
                n2 = quad.N if quad.N.ndim == 2 else quad.N[None, :]
                w2 = quad.w if quad.w.ndim == 2 else quad.w[None, :]
                r = r - torch.sum(w2 * n2 * src, dim=-1)
        else:
            flat = quad.coords.reshape(k * nq, n_in)
            u, du = value_and_jac(net, flat, activation, scale, shift)
            grad_u = du[:, :d].reshape(k, nq, d)
            u_t = du[:, d].reshape(k, nq) if td else None
            u = u.reshape(k, nq)
            if hard_mode:
                u, grad_u, u_t = hard_transform(u, grad_u, u_t, hard)
            kappa, vel, src = hook_fields(theta, flat, d, td, quad.kappa, quad.vel, quad.src,
                                          source_fn, diff_fn, vel_fn)
            r = weak_residual(
                grad_u, quad.N, quad.dN, quad.w, kappa, vel, src, u_t,
                u=u if need_u else None,
                react=quad.react if has_react else None,
                nl_vec=nl,
            )
        if normalize_residual:
            # r_k scales with the test-function support volume (per node for
            # per-node tables); the mean over the real test-function count
            # makes the loss mesh-size independent
            r = r / support_volume(quad.w)
            loss_int = masked_sum_sq(r, quad.mask) / float(max(static.n_test, 1))
        else:
            loss_int = masked_sum_sq(r, quad.mask)

        if hard_mode:  # exact by construction; the aux keys stay for logging
            loss_bc = torch.zeros_like(loss_int)
        else:
            u_bc = apply_fn(net, bc.coords, activation, scale, shift)
            loss_bc = masked_mse(u_bc, bc.values, bc.mask, n_bc)
        total = weights[0] * loss_int + weights[1] * loss_bc
        aux = {"loss_int": loss_int, "loss_bc": loss_bc}
        if neu is not None:
            err = flux_error(net, neu, d, activation, scale, shift, flux_vj, hard_neu)
            loss_neu = masked_mse(err, 0.0, neu.mask, n_neu)
            total = total + weights[1] * loss_neu
            aux["loss_neu"] = loss_neu
        if ic is not None:
            if hard_mode:
                loss_ic = torch.zeros_like(loss_int)
            else:
                u_ic = apply_fn(net, ic.coords, activation, scale, shift)
                loss_ic = masked_mse(u_ic, ic.values, ic.mask, n_ic)
                total = total + weights[2] * loss_ic
            aux["loss_ic"] = loss_ic
        if has_obs:
            u_obs = obs_values(net, obs, apply_fn, activation, scale, shift, hard_obs)
            loss_obs = masked_mse(u_obs, obs.values, obs.mask, n_obs)
            total = total + weights[3] * loss_obs
            aux["loss_obs"] = loss_obs
        aux["loss"] = total
        return total, aux

    return loss_fn


def obs_weight_slots(weight, time_dependent: bool) -> list:
    """The loss's 4-slot weight vector (w_int, w_bc, w_ic, w_obs) from a user's
    (w_int, w_bc[, w_ic][, w_obs]): missing slots are 0, and a steady problem's
    third weight is the observation weight ([w0, w1, 0, w2]), as in the JAX
    package."""
    w = [float(v) for v in weight] + [0.0] * (4 - len(weight))
    return w if time_dependent else [w[0], w[1], 0.0, w[2]]

