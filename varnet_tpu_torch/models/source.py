"""Trainable source fields for inverse source identification: the PyTorch port of
``varnet_tpu/models/source.py``.

The source enters the weak-form residual as a trainable callable
``source_fn(phi, x, t) -> [P]`` of torch tensors (x [P, d], t [P] or None);
gradients reach phi through the same variational loss, jointly with the trial
network (``train/loss.py``'s ``source_fn`` hook, ``VarNet(source_fn=,
source_init=)``).  Initial parameters are drawn from an explicit
``torch.Generator``, so they differ from ``jax.random``'s draw: carry a JAX
``phi0`` across with ``params_from_jax`` where the two must match.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .mlp import init_mlp, make_input_scaling, mlp_apply


def _scaled_mlp(phi, x, activation, scale, shift):
    if scale is None:
        return mlp_apply(phi, x, activation)
    return mlp_apply(phi, x, activation, scale.to(x.device), shift.to(x.device))


def make_mlp_source(
    generator: torch.Generator,
    n_space: int,
    hidden: Sequence[int] = (16, 16),
    lo=None,
    hi=None,
    activation: str = "tanh",
):
    """(source_fn, phi0): a small MLP source field s_phi(x), its inputs scaled
    onto [-1, 1] from the bounds ``lo`` / ``hi`` when given.  Time-independent
    by construction (t is ignored); :func:`make_mlp_source_xt` gives s(x, t)."""
    scale = shift = None
    if lo is not None and hi is not None:
        scale, shift = make_input_scaling(lo, hi)
    phi0 = init_mlp(generator, n_space, hidden, n_out=1)

    def source_fn(phi, x: torch.Tensor, t=None) -> torch.Tensor:
        return _scaled_mlp(phi, x, activation, scale, shift)

    return source_fn, phi0


def make_mlp_source_xt(
    generator: torch.Generator,
    n_space: int,
    hidden: Sequence[int] = (16, 16),
    lo=None,
    hi=None,
    activation: str = "tanh",
):
    """(source_fn, phi0): an MLP source field s_phi(x, t) (``lo`` / ``hi``
    bound the n_space + 1 inputs (x, t))."""
    scale = shift = None
    if lo is not None and hi is not None:
        scale, shift = make_input_scaling(lo, hi)
    phi0 = init_mlp(generator, n_space + 1, hidden, n_out=1)

    def source_fn(phi, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return _scaled_mlp(phi, torch.cat([x, t[:, None]], dim=-1), activation, scale, shift)

    return source_fn, phi0


def make_gaussian_source(n_space: int):
    """(source_fn, phi0): a parametric Gaussian source
    s_phi(x) = amp exp(-|x - c|^2 / (2 sigma^2)), phi = (amp, center, log_sigma),
    the classic few-parameter source-localization form (time-independent)."""
    phi0 = {
        "amp": torch.tensor(1.0),
        "center": torch.zeros(n_space),
        "log_sigma": torch.tensor(-1.0),
    }

    def source_fn(phi, x: torch.Tensor, t=None) -> torch.Tensor:
        sigma2 = torch.exp(2.0 * phi["log_sigma"])
        d2 = torch.sum((x - phi["center"][None, :]) ** 2, dim=-1)
        return phi["amp"] * torch.exp(-d2 / (2.0 * sigma2))

    return source_fn, phi0
