"""Trial-function network: MLP with a forward-mode value + input-jacobian.

PyTorch counterpart of ``varnet_tpu/models/mlp.py``.  Parameters keep the
JAX package's layout so the two compare like for like: a plain list of
``{'w': [fan_in, fan_out], 'b': [fan_out]}`` tensors.  Inputs may be
affinely scaled to [-1, 1]; jacobians are chain-ruled back to the ORIGINAL
coordinates, so the PDE machinery never sees the scaling.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

Params = List[dict]


def _activation_pair(name: str) -> Tuple[Callable, Callable]:
    """(act, act_prime(z, a)): tanh/sigmoid reuse the output a, sin uses z."""
    if name == "tanh":
        return torch.tanh, lambda z, a: 1.0 - a * a
    if name == "sigmoid":
        return torch.sigmoid, lambda z, a: a * (1.0 - a)
    if name == "sin":
        return torch.sin, lambda z, a: torch.cos(z)
    raise ValueError(f"unknown activation '{name}' (expected tanh|sigmoid|sin)")


def init_mlp(
    generator: torch.Generator,
    n_in: int,
    hidden: Sequence[int],
    n_out: int = 1,
    dtype=torch.float32,
    device=None,
) -> Params:
    """Glorot-normal initialized MLP parameters, drawn from ``generator``
    (a CPU ``torch.Generator``, so the draw does not depend on the device)."""
    sizes = [int(n_in)] + [int(h) for h in hidden] + [int(n_out)]
    params: Params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        std = math.sqrt(2.0 / (fan_in + fan_out))
        w = std * torch.randn((fan_in, fan_out), generator=generator, dtype=dtype)
        params.append({"w": w.to(device), "b": torch.zeros(fan_out, dtype=dtype, device=device)})
    return params


def params_from_jax(params, device=None, dtype=torch.float32) -> Params:
    """A JAX-layout parameter list (``[{'w': [in, out], 'b': [out]}, ...]`` of
    NumPy or JAX arrays, e.g. from ``load_theta_npz``) as torch tensors."""
    return [
        {k: torch.as_tensor(np.array(layer[k]), dtype=dtype, device=device) for k in ("w", "b")}
        for layer in params
    ]


def params_to_numpy(params) -> list:
    """Inverse of :func:`params_from_jax`: host NumPy arrays, same layout."""
    return [{k: layer[k].detach().cpu().numpy() for k in ("w", "b")} for layer in params]


def make_input_scaling(lo, hi, dtype=torch.float32, device=None):
    """Affine map of inputs onto [-1, 1]: x_n = (x - shift) * scale."""
    lo = torch.as_tensor(np.asarray(lo), dtype=dtype, device=device)
    hi = torch.as_tensor(np.asarray(hi), dtype=dtype, device=device)
    scale = 2.0 / torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    shift = (lo + hi) / 2.0
    return scale, shift


def mlp_apply(
    params: Params,
    x: torch.Tensor,
    activation: str = "tanh",
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """u_theta(x) for x: [P, n_in] -> [P]."""
    act, _ = _activation_pair(activation)
    a = x if scale is None else (x - shift) * scale
    a = a.to(params[0]["w"].dtype)
    for layer in params[:-1]:
        a = act(a @ layer["w"] + layer["b"])
    out = a @ params[-1]["w"] + params[-1]["b"]
    return out[..., 0]


def mlp_value_and_jac(
    params: Params,
    x: torch.Tensor,
    activation: str = "tanh",
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, du/dx) at x: [P, n_in] -> ([P], [P, n_in]).

    Forward-mode jacobian propagation: the per-point state is a
    [(1 + n_in), H] block (activation row + jacobian rows), so each layer is
    ONE matmul of shape [P*(1+n_in), H_in] @ [H_in, H_out].  The jacobian is
    with respect to the ORIGINAL (unscaled) inputs.
    """
    act, act_prime = _activation_pair(activation)
    p, n_in = x.shape
    dtype = params[0]["w"].dtype
    a = (x if scale is None else (x - shift) * scale).to(dtype)
    eye = torch.eye(n_in, dtype=dtype, device=x.device)
    if scale is not None:
        eye = eye * scale[None, :].to(dtype)
    jac = eye.expand(p, n_in, n_in)
    for layer in params[:-1]:
        w, b = layer["w"], layer["b"]
        state = torch.cat([a[:, None, :], jac], dim=1)
        state = (state.reshape(p * (1 + n_in), -1) @ w).reshape(p, 1 + n_in, -1)
        z = state[:, 0, :] + b
        a = act(z)
        jac = state[:, 1:, :] * act_prime(z, a)[:, None, :]
    w, b = params[-1]["w"], params[-1]["b"]
    state = torch.cat([a[:, None, :], jac], dim=1)
    state = (state.reshape(p * (1 + n_in), -1) @ w).reshape(p, 1 + n_in, -1)
    u = state[:, 0, 0] + b[0]
    du = state[:, 1:, 0]
    return u, du
