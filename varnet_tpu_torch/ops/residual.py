"""Weak-form residual contraction (PyTorch counterpart of
``varnet_tpu/ops/residual.py``):

    r_k = sum_q w_q * [ u_t N_q + (v . grad u) N_q + c u N_q + u (b . grad u) N_q
                        + kappa grad u . dN_q - s N_q ]

(the u (b . grad u) term: nonlinear advection, the viscous-Burgers family)

Test tables come shared by every node ([nQ], order-1 hats on a uniform grid)
or per node ([K, nQ]: the order-2 test space and adaptively refined hats),
told apart by rank as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch


def weak_residual(
    grad_u: torch.Tensor,          # [K, nQ, d]  spatial gradient of the net
    n: torch.Tensor,               # [nQ] or [K, nQ]        test-function values
    dn: torch.Tensor,              # [nQ, d] or [K, nQ, d]  spatial test grads
    w: torch.Tensor,               # [nQ] or [K, nQ]        Gauss weight x detJ
    kappa: torch.Tensor,           # [K, nQ]
    vel: torch.Tensor,             # [K, nQ, d]
    src: torch.Tensor,             # [K, nQ]
    u_t: Optional[torch.Tensor] = None,    # [K, nQ] (time-dependent only)
    u: Optional[torch.Tensor] = None,      # [K, nQ] net values (reaction)
    react: Optional[torch.Tensor] = None,  # [K, nQ] reaction coefficient
    nl_vec: Optional[torch.Tensor] = None,  # [d] constant Burgers direction b
) -> torch.Tensor:
    """Per-test-function weak residual r_k -> [K].  Integration by parts is
    applied to the diffusion term only, so only first derivatives of the
    network appear.  Reaction and the nonlinear advection term ``nl_vec``
    both need ``u``."""
    n2 = n if n.ndim == 2 else n[None, :]
    adv = torch.einsum("kqd,kqd->kq", vel, grad_u)
    integrand = (adv - src) * n2
    if u_t is not None:
        integrand = integrand + u_t * n2
    if react is not None and u is not None:
        integrand = integrand + react * u * n2
    if nl_vec is not None and u is not None:
        integrand = integrand + u * torch.einsum("kqd,d->kq", grad_u, nl_vec) * n2
    if dn.ndim == 3:
        diff = kappa * torch.einsum("kqd,kqd->kq", grad_u, dn)
    else:
        diff = kappa * torch.einsum("kqd,qd->kq", grad_u, dn)
    integrand = integrand + diff
    if w.ndim == 2:
        return torch.einsum("kq,kq->k", integrand, w)
    return torch.einsum("kq,q->k", integrand, w)


def support_volume(w: torch.Tensor) -> torch.Tensor:
    """Sum of the quadrature weights: the test-function support volume the
    normalized residual divides by, per node for per-node tables [K, nQ]
    (the JAX loss's ``vol``)."""
    return torch.sum(w, dim=-1) if w.ndim == 2 else torch.sum(w)


def masked_sum_sq(r: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum_k mask_k * r_k^2 (padding-safe interior loss term)."""
    return torch.sum(mask * r * r)


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
               denom: float) -> torch.Tensor:
    """Padding-safe mean squared error for BC/IC penalties; ``denom`` is the
    real (unpadded) point count."""
    err = (pred - target) * mask
    return torch.sum(err * err) / denom


def hook_fields(theta, flat, d: int, td: bool, kappa, vel, src, source_fn=None, diff_fn=None,
                vel_fn=None):
    """(kappa, vel, src) at the quadrature points ``flat`` [K nQ, n_in], each
    trainable hook's field in place of the fixed one: ``source_fn(theta['src'],
    x, t)``, ``diff_fn(theta['kap'], x, t)`` and ``vel_fn(theta['vel'], x, t)``
    (x the spatial coordinates, t the time column or None), reshaped onto the
    fixed fields' [K, nQ(, d)] shapes."""
    x, t = flat[:, :d], (flat[:, d] if td else None)
    if source_fn is not None:
        src = source_fn(theta["src"], x, t).reshape(src.shape)
    if diff_fn is not None:
        kappa = diff_fn(theta["kap"], x, t).reshape(kappa.shape)
    if vel_fn is not None:
        vel = vel_fn(theta["vel"], x, t).reshape(vel.shape)
    return kappa, vel, src
