"""The flagship problem, written again from its definition: 2-D transient
advection-diffusion on the unit square with the translating, decaying exact
solution

    u(x, y, t) = exp(-2 kappa pi^2 t) sin(pi (x - vx t)) sin(pi (y - vy t)),

which solves u_t + v . grad u - kappa lap u = 0 with constant v and no source.
Every boundary segment and the initial condition take the exact solution.
Fields take float64 tensors x [n, 2] and t [n] and return float64 tensors.
"""

from __future__ import annotations

import math

import torch

from . import Problem


def build(kappa: float = 0.05, vel=(0.5, 0.25), t_final: float = 0.5) -> Problem:
    vx, vy = float(vel[0]), float(vel[1])

    def exact(x, t):
        amp = torch.exp(-2.0 * kappa * math.pi ** 2 * t)
        return amp * torch.sin(math.pi * (x[:, 0] - vx * t)) * torch.sin(math.pi * (x[:, 1] - vy * t))

    def velocity(x, t):
        return torch.tensor([vx, vy], dtype=x.dtype, device=x.device).expand(x.shape[0], 2)

    def source(x, t):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    return Problem(lo=(0.0, 0.0), hi=(1.0, 1.0), t_interval=(0.0, float(t_final)),
                   kappa=float(kappa), velocity=velocity, source=source,
                   bcs=[exact] * 4, ic=lambda x: exact(x, torch.zeros_like(x[:, 0])))
