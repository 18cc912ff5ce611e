"""The exact-BC weak residual of transient advection-diffusion on a 3-D box,
inputs (x, y, z, t), written again from its definitions: the space-time weak
form of the VarNet paper (arXiv:1912.07443) in three space dimensions, and
the trial function of exact imposition (Sukumar and Srivastava, CMAME 389,
2022, arXiv:2104.08426),

    u(x, t) = G(x, t) + tau(t) D(x) N(x, t),

with N the net, tau = (t - t0) / (T - t0), G(x, t) = g(x, t) - g(x, t0) + u0(x)
for the Dirichlet data g (zero here, so G = u0), and D the approximate
distance: the left fold of Rvachev's R0 conjunction d <- d + p - sqrt(d^2 + p^2)
over the faces' inward distances divided by the box's diagonal, faces in the
order x lo, x hi, y lo, y hi, z lo, z hi (R0 is not associative, so the order
is part of D).  With A = G, B = tau D:

    u     = A + B N
    grad u = dA + dB N + B grad N,    u_t = At + Bt N + B N_t
    r_k   = sum_q w_q [ (u_t + v . grad u - s) N_q + kappa grad u . dN_q ]
    L     = w_int mean_k (r_k / vol)^2,    r_vec = sqrt(w_int / K) r_k / vol

The BC and IC hold by construction, so there are no penalty rows.  The
derivatives of D and G are taken by autograd in float64 at each point (the
program takes f64 central differences with a step of 1e-6 of the diagonal,
whose error, about 1e-10, is far below every limit).

Mesh: order-1 hats in x, y, z and t on a uniform grid, one test function per
interior node, integrated with Gauss-Legendre points on each orthant of its
support (``mesh.py``'s per-axis tables, taken to four axes).  Built on the
device in float64, cast to float32 where the trained function meets it; the
interior is evaluated in blocks of ``reference_block`` test functions.
"""

from __future__ import annotations

import math
import sys
from typing import NamedTuple

import numpy as np
import torch

from .. import problems
from ..loss import Setup
from ..mesh import _axis_tables
from ..model import value_and_grad

N_SPACE = 3


class BoxData(NamedTuple):
    centers: torch.Tensor   # [K, 4] f64 test-function centres (x, y, z, t)
    offsets: torch.Tensor   # [nQ, 4] f64 quadrature points about a centre
    n: torch.Tensor         # [nQ] f32 test-function values
    dn: torch.Tensor        # [nQ, 3] f32 spatial test-function gradients
    w: torch.Tensor         # [nQ] f32 quadrature weights
    vol: float              # support volume (the sum of the weights)
    scale: torch.Tensor     # [4] f32 input scaling onto [-1, 1] (ones without it)
    shift: torch.Tensor     # [4] f32


def build(problem, disc_num: int, t_disc_num: int, integ_p_num: int = 2,
          input_scaling: bool = True, device="cpu") -> BoxData:
    f64 = dict(dtype=torch.float64, device=device)
    nt = int(t_disc_num)
    lo, hi = np.asarray(problem.lo, float), np.asarray(problem.hi, float)
    t0, t1 = (float(v) for v in problem.t_interval)
    grids = [np.linspace(lo[j], hi[j], int(disc_num) + 1) for j in range(N_SPACE)]
    grids.append(np.linspace(t0, t1, nt + 1))
    h = [(hi[j] - lo[j]) / int(disc_num) for j in range(N_SPACE)] + [(t1 - t0) / nt]

    nodes = np.meshgrid(*[g[1:-1] for g in grids], indexing="ij")
    centers = torch.tensor(np.stack([c.ravel() for c in nodes], -1), **f64)

    tabs = [_axis_tables(hj, integ_p_num) for hj in h]
    off, hat, dhat, wt = ([g.ravel() for g in np.meshgrid(*[t[k] for t in tabs], indexing="ij")]
                          for k in range(4))
    n_q = np.prod(hat, axis=0)
    dn_q = np.stack([dhat[j] * np.prod([hat[i] for i in range(4) if i != j], axis=0)
                     for j in range(N_SPACE)], -1)
    w_q = np.prod(wt, axis=0)

    f32 = dict(dtype=torch.float32, device=device)
    if input_scaling:
        span = np.append(hi - lo, t1 - t0)
        scale = torch.tensor(2.0 / span, **f32)
        shift = torch.tensor(np.append((lo + hi) / 2, (t0 + t1) / 2), **f32)
    else:
        scale, shift = torch.ones(4, **f32), torch.zeros(4, **f32)
    return BoxData(centers=centers, offsets=torch.tensor(np.stack(off, -1), **f64),
                   n=torch.tensor(n_q, **f32), dn=torch.tensor(dn_q, **f32),
                   w=torch.tensor(w_q, **f32), vol=float(np.sum(w_q)), scale=scale, shift=shift)


def distance(problem, x: torch.Tensor) -> torch.Tensor:
    """D(x) [n] at points x [n, 3] (f64): the R0 fold of the normalised inward
    face distances, faces in the order of the module docstring."""
    lo = torch.tensor(problem.lo, dtype=x.dtype, device=x.device)
    hi = torch.tensor(problem.hi, dtype=x.dtype, device=x.device)
    diag = torch.linalg.vector_norm(hi - lo)
    d = None
    for j in range(N_SPACE):
        for p in ((x[:, j] - lo[j]) / diag, (hi[j] - x[:, j]) / diag):
            d = p if d is None else d + p - torch.sqrt(d * d + p * p)
    return d


def ansatz_tables(problem, x: torch.Tensor):
    """(A, dA, At, B, dB, Bt) at space-time points x [n, 4] (f64): the trial
    function's fixed parts, gradients by autograd in f64."""
    t0, t1 = (float(v) for v in problem.t_interval)
    xs = x[:, :N_SPACE].detach().clone().requires_grad_(True)
    with torch.enable_grad():
        d = distance(problem, xs)
        g = problem.ic(xs)
        dd, dg = (torch.autograd.grad(f.sum(), xs)[0] for f in (d, g))
    d, g = d.detach(), g.detach()
    tau = (x[:, N_SPACE] - t0) / (t1 - t0)
    return g, dg, torch.zeros_like(g), tau * d, tau[:, None] * dd, d / (t1 - t0)


def _zero_data(problem, device) -> bool:
    """Every face's Dirichlet data is zero (the case G = u0 covers)."""
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(64, N_SPACE, generator=gen, dtype=torch.float64).to(device)
    t = torch.rand(64, generator=gen, dtype=torch.float64).to(device)
    return all(g is not None and bool(torch.all(g(x, t) == 0)) for g in problem.bcs)


def setup(config: dict, device, bt2pi) -> Setup:
    if bt2pi is not None:
        raise ValueError("transient_box3d_hard: the exact-BC form takes a plain net")
    prob = problems.build(config["problem"], **config["problem_kwargs"])
    if len(prob.bcs) != 2 * N_SPACE or not _zero_data(prob, device):
        raise ValueError("transient_box3d_hard: zero Dirichlet data on all six faces only")
    data = build(prob, config["disc_num"], config["t_disc_num"], config.get("integ_p_num", 2),
                 config["input_scaling"], device=device)
    return Setup(prob, data, tuple(config["weight"]), None, int(config["reference_block"]),
                 sys.modules[__name__])


def blocks(setup: Setup):
    k = setup.data.centers.shape[0]
    return [(a, min(a + setup.block, k)) for a in range(0, k, setup.block)]


def interior_block(params, setup: Setup, k0: int, k1: int) -> torch.Tensor:
    """r_k / vol of test functions k0 .. k1-1 [k1 - k0]."""
    d, prob = setup.data, setup.problem
    pts = (d.centers[k0:k1, None, :] + d.offsets[None]).reshape(-1, N_SPACE + 1)
    xs, t = pts[:, :N_SPACE], pts[:, N_SPACE]
    k, nq = k1 - k0, d.offsets.shape[0]
    f32 = lambda a: a.to(torch.float32)  # noqa: E731
    a, da, at, b, db, bt = map(f32, ansatz_tables(prob, pts))
    vel, src = f32(prob.velocity(xs, t)), f32(prob.source(xs, t))
    net, dnet = value_and_grad(params, f32(pts), d.scale, d.shift)
    grad_u = da + db * net[:, None] + b[:, None] * dnet[:, :N_SPACE]
    u_t = at + bt * net + b * dnet[:, N_SPACE]
    integrand = ((u_t + (vel * grad_u).sum(-1) - src).view(k, nq) * d.n
                 + prob.kappa * (grad_u.view(k, nq, N_SPACE) * d.dn).sum(-1))
    return (integrand @ d.w[:, None])[:, 0] / d.vol


def interior_weight(setup: Setup) -> float:
    """sqrt(w_int / K): the interior rows' factor in r_vec."""
    return math.sqrt(setup.weights[0] / setup.data.centers.shape[0])


def rows(params, setup: Setup, blk) -> torch.Tensor:
    if blk is None:
        # no penalty rows: an empty slice of the net, so sums and products stay on its graph
        return params[-1][1][:0]
    return interior_weight(setup) * interior_block(params, setup, *blk)


def shapes(config: dict) -> dict:
    """Test functions K, points P = K nQ (nQ = (2 p)^4), no boundary or
    initial points, four inputs, the hidden widths; ``panels``: one value and
    one directional-tangent panel per point, as K4 pushes them."""
    k = (config["disc_num"] - 1) ** N_SPACE * (config["t_disc_num"] - 1)
    nq = (2 * config.get("integ_p_num", 2)) ** (N_SPACE + 1)
    return {"tests": k, "points": k * nq, "bc_points": 0, "ic_points": 0, "n_in": N_SPACE + 1,
            "k0": N_SPACE + 1, "widths": tuple(config["layer_width"]), "panels": 2}
