"""The 3-D transient problem of the exact-BC recipe, written again from its
definition: advection-diffusion on the unit cube [0, 1]^3 with constant
velocity v and the manufactured solution

    u(x, y, z, t) = sin(pi x) sin(pi y) sin(pi z) exp(-t),

so the source is s = u_t + v . grad u - kappa lap u
= (3 kappa pi^2 - 1) u + v . grad u.  Zero Dirichlet data on all six faces
(lo then hi of x, of y, of z); the initial condition is u at t = 0.  Fields
take float64 tensors x [n, 3] and t [n] and return float64 tensors; lo / hi
are the cube's corners.
"""

from __future__ import annotations

import math

import torch

from . import Problem


def build(kappa: float = 0.1, vel=(1.0, 0.5, 0.25), t_final: float = 0.5) -> Problem:
    v = [float(c) for c in vel]

    def u0(x):
        return torch.sin(math.pi * x[:, 0]) * torch.sin(math.pi * x[:, 1]) * torch.sin(math.pi * x[:, 2])

    def grad_u0(x):
        s, c = torch.sin(math.pi * x), torch.cos(math.pi * x)
        return math.pi * torch.stack([c[:, 0] * s[:, 1] * s[:, 2], s[:, 0] * c[:, 1] * s[:, 2],
                                      s[:, 0] * s[:, 1] * c[:, 2]], dim=-1)

    def velocity(x, t):
        return torch.tensor(v, dtype=x.dtype, device=x.device).expand(x.shape[0], 3)

    def source(x, t):
        decay = torch.exp(-t)
        adv = grad_u0(x) @ torch.tensor(v, dtype=x.dtype, device=x.device)
        return decay * ((3.0 * kappa * math.pi ** 2 - 1.0) * u0(x) + adv)

    def zero(x, t=None):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    return Problem(lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0), t_interval=(0.0, float(t_final)),
                   kappa=float(kappa), velocity=velocity, source=source, bcs=[zero] * 6, ic=u0)
