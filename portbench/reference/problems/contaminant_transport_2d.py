"""The contaminant problem, written again from its definition: transport in the
channel [0, 2] x [0, 1] under the Poiseuille shear flow v = (4 u_max y (1 - y), 0),
with diffusivity kappa and a Gaussian source near the inlet switched off
smoothly at t = src_t_off,

    s(x, y, t) = exp(-|x - c|^2 / (2 sigma^2)) * (1 - tanh((t - t_off) / 0.02)) / 2.

Zero initial condition; zero Dirichlet data on the bottom, top and inlet
(left) segments; the outflow (right) segment carries no condition.
"""

from __future__ import annotations

import torch

from . import Problem


def build(kappa: float = 0.01, u_max: float = 1.0, t_final: float = 1.0, src_center=(0.3, 0.5),
          src_sigma: float = 0.06, src_t_off: float = 0.3) -> Problem:
    cx, cy = float(src_center[0]), float(src_center[1])

    def velocity(x, t):
        vx = 4.0 * u_max * x[:, 1] * (1.0 - x[:, 1])
        return torch.stack([vx, torch.zeros_like(vx)], dim=-1)

    def source(x, t):
        g = torch.exp(-((x[:, 0] - cx) ** 2 + (x[:, 1] - cy) ** 2) / (2.0 * src_sigma ** 2))
        return g * 0.5 * (1.0 - torch.tanh((t - src_t_off) / 0.02))

    def zero(x, t=None):
        return torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)

    # segments in the order bottom, right (outflow: free), top, left (inlet)
    return Problem(lo=(0.0, 0.0), hi=(2.0, 1.0), t_interval=(0.0, float(t_final)),
                   kappa=float(kappa), velocity=velocity, source=source,
                   bcs=[zero, None, zero, zero], ic=zero)
