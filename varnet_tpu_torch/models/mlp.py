"""Trial-function network: MLP (optionally behind a fixed random-Fourier-feature
embedding) with a forward-mode value + input-jacobian.

PyTorch counterpart of ``varnet_tpu/models/mlp.py``.  Parameters keep the
JAX package's layout so the two compare like for like: a plain list of
``{'w': [fan_in, fan_out], 'b': [fan_out]}`` tensors, or for an inverse
problem a dict ``{'net': [...], 'src': ..., 'kap': ..., 'vel': ...}`` of such
trees, flattened in JAX's ``ravel_pytree`` order.  Inputs may be
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


def init_siren(
    generator: torch.Generator,
    n_in: int,
    hidden: Sequence[int],
    n_out: int = 1,
    omega0: float = 6.0,
    dtype=torch.float32,
    device=None,
) -> Params:
    """SIREN initialization (Sitzmann et al. 2020) for sin-activation nets, the
    bounds of the JAX package's ``init_siren``: layer 0 ~ U(-omega0/n_in,
    omega0/n_in) (the frequency multiplier folded into the weights; inputs are
    expected scaled to [-1, 1]), deeper layers ~ U(-sqrt(6/fan_in),
    sqrt(6/fan_in)), biases zero.  Drawn from ``generator`` (a CPU
    ``torch.Generator``), as :func:`init_mlp`."""
    sizes = [int(n_in)] + [int(h) for h in hidden] + [int(n_out)]
    params: Params = []
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        bound = float(omega0) / fan_in if i == 0 else math.sqrt(6.0 / fan_in)
        w = (2.0 * torch.rand((fan_in, fan_out), generator=generator, dtype=dtype) - 1.0) * bound
        params.append({"w": w.to(device), "b": torch.zeros(fan_out, dtype=dtype, device=device)})
    return params


def tree_leaves(tree) -> list:
    """The leaves of a nest of dicts, lists and tuples in the order of JAX's
    ``tree_leaves``: dict keys sorted, sequences in order, None no leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn, tree):
    """``fn`` applied to every leaf of a nest of dicts, lists and tuples, in
    :func:`tree_leaves` order (so a stateful ``fn`` can rebuild a tree from a
    leaf sequence); the structure is kept, None stays None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def params_from_jax(params, device=None, dtype=torch.float32):
    """A JAX-layout parameter tree (``[{'w': [in, out], 'b': [out]}, ...]``,
    or an inverse problem's ``{'net': [...], 'src': ..., ...}``, of NumPy or
    JAX arrays, e.g. from ``load_theta_npz``) as torch tensors."""
    return tree_map(lambda a: torch.as_tensor(np.array(a), dtype=dtype, device=device), params)


def params_to_numpy(params):
    """Inverse of :func:`params_from_jax`: host NumPy arrays, same tree."""
    return tree_map(lambda t: t.detach().cpu().numpy(), params)


def ravel_params(params):
    """(flat, unravel): the parameter tree (a layer list, or a dict of such
    trees) as one flat vector in the order of JAX's ``ravel_pytree`` -- dict
    keys sorted (per layer ``b`` before ``w``; ``kap < net < src < vel``), each
    leaf row-major -- and the inverse, which returns views of the vector it is
    given (so gradients and forward-mode tangents of the vector reach every
    leaf)."""
    leaves = tree_leaves(params)
    shapes = [tuple(leaf.shape) for leaf in leaves]
    flat = torch.cat([leaf.reshape(-1) for leaf in leaves])

    def unravel(vec: torch.Tensor):
        spans = iter(zip(shapes, np.cumsum([0] + [math.prod(sh) for sh in shapes]).tolist()))

        def take(_leaf):
            shape, lo = next(spans)
            return vec[lo:lo + math.prod(shape)].view(shape)

        return tree_map(take, params)

    return flat, unravel


def leaf_segments(params) -> np.ndarray:
    """Leaf id of every entry of the ``ravel_params`` vector."""
    sizes = [leaf.numel() for leaf in tree_leaves(params)]
    return np.repeat(np.arange(len(sizes)), sizes)


def net_of(theta):
    """The trial net of a parameter tree: ``theta['net']`` for an inverse
    problem's dict, else theta itself (a layer list)."""
    return theta["net"] if isinstance(theta, dict) and "net" in theta else theta


def param_count(params: Params) -> int:
    """The number of scalars in a net's weights and biases."""
    return int(sum(np.prod(p["w"].shape) + np.prod(p["b"].shape) for p in params))


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
    primal=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, du/dx) at x: [P, n_in] -> ([P], [P, n_in]).

    Forward-mode jacobian propagation: the per-point state is a
    [(1 + n_in), H] block (activation row + jacobian rows), so each layer is
    ONE matmul of shape [P*(1+n_in), H_in] @ [H_in, H_out].  The jacobian is
    with respect to the ORIGINAL (unscaled) inputs.  ``primal`` is ignored:
    the plain chain has no differentiation rules of its own, so it recomputes
    where the kernels' Functions (``ops/value_and_jac.py``) read a stored one.
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


def make_fourier_features(generator: torch.Generator, n_in: int, n_feat: int,
                          scale=1.0, dtype=torch.float32) -> torch.Tensor:
    """Random Fourier feature matrix B [n_in, n_feat], drawn from ``generator``.

    The embedding gamma(x) = [sin(2 pi x B), cos(2 pi x B)] (2 n_feat wide)
    counters the spectral bias of plain MLPs; B is fixed, not trained.
    ``scale`` is a float, a sequence of floats or their string form ("0.5" or
    "0.5,2.0"): with several scales ``n_feat`` is split evenly across them
    (remainder to the first block) and the per-scale blocks are concatenated,
    as in the JAX package.  The numbers differ from ``jax.random``'s, so a B
    drawn by the JAX package is carried over as an explicit array instead
    (``VarNet(fourier_b=...)``)."""
    if isinstance(scale, str):
        scale = [float(s) for s in scale.split(",")]
        if len(scale) == 1:
            scale = scale[0]
    if isinstance(scale, (int, float)):
        return float(scale) * torch.randn((int(n_in), int(n_feat)), generator=generator,
                                          dtype=dtype)
    scales = [float(s) for s in scale]
    n_feat = int(n_feat)
    counts = [n_feat // len(scales)] * len(scales)
    counts[0] += n_feat - sum(counts)
    return torch.cat([s * torch.randn((int(n_in), n), generator=generator, dtype=dtype)
                      for s, n in zip(scales, counts)], dim=1)


def _embed(b_mat, xs):
    """[sin | cos](2 pi xs B) of scaled points xs [P, n_in] -> [P, 2F]."""
    ang = 2.0 * math.pi * (xs @ b_mat.to(xs.dtype))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1), ang


def ff_apply(b_mat, params: Params, x: torch.Tensor, activation: str = "tanh",
             scale: Optional[torch.Tensor] = None,
             shift: Optional[torch.Tensor] = None) -> torch.Tensor:
    """u_theta(x) through the Fourier-feature embedding: [P, n_in] -> [P]."""
    act, _ = _activation_pair(activation)
    xs = (x if scale is None else (x - shift) * scale).to(params[0]["w"].dtype)
    a, _ = _embed(b_mat, xs)
    for layer in params[:-1]:
        a = act(a @ layer["w"] + layer["b"])
    return (a @ params[-1]["w"] + params[-1]["b"])[..., 0]


def ff_value_and_jac(b_mat, params: Params, x: torch.Tensor, activation: str = "tanh",
                     scale: Optional[torch.Tensor] = None,
                     shift: Optional[torch.Tensor] = None,
                     primal=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(u, du/dx) through the Fourier-feature embedding + MLP (the math of
    ``varnet_tpu.models.mlp.ff_value_and_jac``): the embedding jacobian seeds
    the n_in tangent rows; du is with respect to the ORIGINAL coordinates.
    ``primal`` is ignored, as :func:`mlp_value_and_jac`'s."""
    act, act_prime = _activation_pair(activation)
    p, n_in = x.shape
    dtype = params[0]["w"].dtype
    xs = (x if scale is None else (x - shift) * scale).to(dtype)
    bm = b_mat.to(dtype)
    a, ang = _embed(bm, xs)
    dxs = torch.eye(n_in, dtype=dtype, device=x.device)
    if scale is not None:
        dxs = dxs * scale[None, :].to(dtype)
    dang = 2.0 * math.pi * (dxs @ bm)                            # [n_in, F]
    cos_a, sin_a = torch.cos(ang), torch.sin(ang)
    jac = torch.cat([cos_a[:, None, :] * dang[None], -sin_a[:, None, :] * dang[None]], dim=-1)
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
    return state[:, 0, 0] + b[0], state[:, 1:, 0]
