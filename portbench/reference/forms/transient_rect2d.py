"""The penalty-form weak residual of transient advection-diffusion on a 2-D
rectangle, inputs (x, y, t):

    r_k   = sum_q w_q [ (u_t + v . grad u - s) N_q + kappa grad u . dN_q ]   (per test function)
    L     = w_int mean_k (r_k / vol)^2 + w_bc mean_bc (u - g)^2 + w_ic mean_ic (u - u0)^2
    r_vec = [ sqrt(w_int / K) r_k / vol,  sqrt(w_bc / N_bc) (u - g),  sqrt(w_ic / N_ic) (u - u0) ]

so that sum(r_vec^2) = L.  The mesh and tables are ``mesh.py``'s.  The
interior is evaluated in blocks of ``reference_block`` test functions so that
a block's panels fit the card; the blocks are the same for every call.
"""

from __future__ import annotations

import math
import sys

import torch

from .. import mesh as mesh_mod
from .. import problems
from ..loss import Setup
from ..model import value_and_grad


def setup(config: dict, device, bt2pi) -> Setup:
    prob = problems.build(config["problem"], **config["problem_kwargs"])
    data = mesh_mod.build(prob, config["disc_num"], config["b_disc_num"], config["t_disc_num"],
                          config.get("integ_p_num", 2), config["input_scaling"], device=device)
    return Setup(prob, data, tuple(config["weight"]), bt2pi, int(config["reference_block"]),
                 sys.modules[__name__])


def blocks(setup: Setup):
    k = setup.data.centers.shape[0]
    return [(a, min(a + setup.block, k)) for a in range(0, k, setup.block)]


def interior_block(params, setup: Setup, k0: int, k1: int) -> torch.Tensor:
    """r_k / vol of test functions k0 .. k1-1 [k1 - k0]."""
    d = setup.data
    x, kappa, vel, src = mesh_mod.fields(setup.problem, d, k0, k1)
    k, nq = x.shape[0], x.shape[1]
    _, du = value_and_grad(params, x.reshape(-1, 3), d.scale, d.shift, setup.bt2pi)
    du = du.reshape(k, nq, 3)
    grad_u = du[..., :2]
    integrand = ((du[..., 2] + (vel * grad_u).sum(-1) - src) * d.n
                 + kappa * (grad_u * d.dn).sum(-1))
    return (integrand @ d.w[:, None])[:, 0] / d.vol


def penalty_rows(params, setup: Setup) -> torch.Tensor:
    """The weighted BC and IC rows of r_vec."""
    d, (_, w_bc, w_ic) = setup.data, setup.weights
    u_bc = value_and_grad(params, d.bc_x, d.scale, d.shift, setup.bt2pi, tangents=False)
    u_ic = value_and_grad(params, d.ic_x, d.scale, d.shift, setup.bt2pi, tangents=False)
    return torch.cat([math.sqrt(w_bc / d.bc_x.shape[0]) * (u_bc - d.bc_g),
                      math.sqrt(w_ic / d.ic_x.shape[0]) * (u_ic - d.ic_g)])


def interior_weight(setup: Setup) -> float:
    """sqrt(w_int / K): the interior rows' factor in r_vec."""
    return math.sqrt(setup.weights[0] / setup.data.centers.shape[0])


def rows(params, setup: Setup, blk) -> torch.Tensor:
    if blk is None:
        return penalty_rows(params, setup)
    return interior_weight(setup) * interior_block(params, setup, *blk)


def shapes(config: dict) -> dict:
    """Test functions K, points P = K nQ, boundary and initial points, the
    net's layer-0 width k0 and hidden widths; ``panels``: one value and one
    directional-tangent panel per point, the least the weak form needs
    (u_t + v . grad u and kappa grad u . grad N are both directional)."""
    disc = config["disc_num"]
    nx, ny = (disc, disc) if isinstance(disc, int) else disc
    nt = config["t_disc_num"]
    k = (nx - 1) * (ny - 1) * (nt - 1)
    nq = (2 * config.get("integ_p_num", 2)) ** 3
    free = sum(1 for active in config["bc_segments"] if not active)
    n_bc = (4 - free) * config["b_disc_num"] * (nt + 1)
    n_ic = (nx - 1) * (ny - 1)
    ff = config.get("fourier_features") or 0
    return {"tests": k, "points": k * nq, "bc_points": n_bc, "ic_points": n_ic,
            "n_in": 3, "k0": 2 * ff if ff else 3, "widths": tuple(config["layer_width"]),
            "panels": 2}
