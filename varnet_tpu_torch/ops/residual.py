"""Weak-form residual contraction (PyTorch counterpart of
``varnet_tpu/ops/residual.py``, shared [nQ] test tables only):

    r_k = sum_q w_q * [ u_t N_q + (v . grad u) N_q + c u N_q
                        + kappa grad u . dN_q - s N_q ]
"""

from __future__ import annotations

from typing import Optional

import torch


def weak_residual(
    grad_u: torch.Tensor,          # [K, nQ, d]  spatial gradient of the net
    n: torch.Tensor,               # [nQ]        test-function values
    dn: torch.Tensor,              # [nQ, d]     spatial test grads
    w: torch.Tensor,               # [nQ]        Gauss weight x detJ
    kappa: torch.Tensor,           # [K, nQ]
    vel: torch.Tensor,             # [K, nQ, d]
    src: torch.Tensor,             # [K, nQ]
    u_t: Optional[torch.Tensor] = None,    # [K, nQ] (time-dependent only)
    u: Optional[torch.Tensor] = None,      # [K, nQ] net values (reaction)
    react: Optional[torch.Tensor] = None,  # [K, nQ] reaction coefficient
) -> torch.Tensor:
    """Per-test-function weak residual r_k -> [K].  Integration by parts is
    applied to the diffusion term only, so only first derivatives of the
    network appear."""
    if n.ndim != 1:
        raise ValueError("per-node test tables (test_order=2) are not ported yet")
    n2 = n[None, :]
    adv = torch.einsum("kqd,kqd->kq", vel, grad_u)
    integrand = (adv - src) * n2
    if u_t is not None:
        integrand = integrand + u_t * n2
    if react is not None and u is not None:
        integrand = integrand + react * u * n2
    integrand = integrand + kappa * torch.einsum("kqd,qd->kq", grad_u, dn)
    return torch.einsum("kq,q->k", integrand, w)


def masked_sum_sq(r: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum_k mask_k * r_k^2 (padding-safe interior loss term)."""
    return torch.sum(mask * r * r)


def masked_mse(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
               denom: float) -> torch.Tensor:
    """Padding-safe mean squared error for BC/IC penalties; ``denom`` is the
    real (unpadded) point count."""
    err = (pred - target) * mask
    return torch.sum(err * err) / denom
