"""The trial function of the reference: an MLP u(x, y, t) with tanh hidden
layers, optionally behind a fixed Fourier-feature embedding
[sin | cos](2 pi xs B), evaluated with its gradient in the inputs by pushing
one value panel and one tangent panel per input through the layers stacked
along the rows (plain matrix products, float32).

Parameters are a list of (W [fan_in, fan_out], b [fan_out]) pairs, drawn by
:func:`draw_params`, which the benchmark also hands to the program.

:class:`TF32` is the lower-precision control: a dispatch mode that rounds both
operands of every matrix product to TF32 (10 mantissa bits, round to nearest,
ties away from zero) and keeps the float32 accumulation, as the tensor cores do
when ``torch.backends.cuda.matmul.allow_tf32`` is on; it acts below autograd, so
forward-mode tangents and backward products are rounded too.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

Params = List[Tuple[torch.Tensor, torch.Tensor]]


def draw_params(seed: int, sizes: Sequence[int], device) -> Params:
    """Glorot-normal weights (std sqrt(2 / (fan_in + fan_out))) and zero biases,
    drawn in one call on ``device`` from a generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    shapes = list(zip(sizes[:-1], sizes[1:]))
    flat = torch.randn(sum(a * b for a, b in shapes), generator=gen, device=device)
    params, at = [], 0
    for fan_in, fan_out in shapes:
        w = flat[at:at + fan_in * fan_out].view(fan_in, fan_out) * math.sqrt(2.0 / (fan_in + fan_out))
        params.append((w.contiguous(), torch.zeros(fan_out, device=device)))
        at += fan_in * fan_out
    return params


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    if x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class TF32(TorchDispatchMode):
    """Matrix products with TF32 operands (see the module docstring)."""

    _OPS = {torch.ops.aten.mm.default: (0, 1), torch.ops.aten.addmm.default: (1, 2),
            torch.ops.aten.bmm.default: (0, 1), torch.ops.aten.baddbmm.default: (1, 2)}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        which = self._OPS.get(func)
        if which is not None:
            args = tuple(_round_tf32(a) if i in which else a for i, a in enumerate(args))
        return func(*args, **kwargs)


def value_and_grad(params: Params, x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                   bt2pi: Optional[torch.Tensor] = None, tangents: bool = True):
    """u [n] and, with ``tangents``, du/d(x, y, t) [n, 3] at points x [n, 3]."""
    n, d = x.shape
    xs = (x - shift) * scale
    if bt2pi is None:
        a = xs
        da = torch.diag(scale).repeat_interleave(n, dim=0) if tangents else None
    else:
        z = xs @ bt2pi
        sz, cz = torch.sin(z), torch.cos(z)
        a = torch.cat([sz, cz], dim=1)
        if tangents:
            c = bt2pi * scale[:, None]                         # [3, F]
            da = torch.cat([(cz[None] * c[:, None]).reshape(d * n, -1),
                            (-sz[None] * c[:, None]).reshape(d * n, -1)], dim=1)
    panels = torch.cat([a, da]) if tangents else a
    for w, b in params[:-1]:
        z = panels @ w
        h = torch.tanh(z[:n] + b)
        if tangents:
            g = 1.0 - h * h
            panels = torch.cat([h, (z[n:].view(d, n, -1) * g).reshape(d * n, -1)])
        else:
            panels = h
    w, b = params[-1]
    out = (panels @ w)[:, 0]
    u = out[:n] + b[0]
    return (u, out[n:].view(d, n).T) if tangents else u
