"""The fixed data of the weak form, built again for the reference from the
definition of the method (the VarNet paper, arXiv:1912.07443): space-time hat
test functions on a uniform grid of a rectangle, integrated with a
tensor-product Gauss-Legendre rule on each orthant of their support, and
penalty points on the boundary and at the initial time.

    test functions  one per interior grid node (x_i, y_j, t_n): 1 <= i < nx,
                    1 <= j < ny, 1 <= n < nt; support = node +/- h in each axis
    quadrature      per axis: the points s * h (1 + eta) / 2 of each orthant
                    s = -1, +1 (eta the Gauss-Legendre points), the hat factor
                    (1 - eta) / 2, its derivative -s / h, the weight wg h / 2;
                    the space-time tables are their tensor products
    boundary        per segment (bottom, right, top, left) b points, the
                    segment's start vertex included and its end vertex left out,
                    at every time node t_0 .. t_nt; a free segment has none
    initial         the interior grid nodes at t_0

Everything is built on the device in float64, then cast to float32 where the
trained function meets it.  Test functions need no order: the loss sums over
them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .problems import Problem


class WeakData(NamedTuple):
    centers: torch.Tensor   # [K, 3] f64 test-function centres (x, y, t)
    offsets: torch.Tensor   # [nQ, 3] f64 quadrature points about a centre
    n: torch.Tensor         # [nQ] f32 test-function values
    dn: torch.Tensor        # [nQ, 2] f32 spatial test-function gradients
    w: torch.Tensor         # [nQ] f32 quadrature weights
    vol: float              # support volume (the sum of the weights)
    bc_x: torch.Tensor      # [Nb, 3] f32 boundary points
    bc_g: torch.Tensor      # [Nb] f32 boundary values
    ic_x: torch.Tensor      # [Ni, 3] f32 initial points
    ic_g: torch.Tensor      # [Ni] f32 initial values
    scale: torch.Tensor     # [3] f32 input scaling onto [-1, 1] (ones without it)
    shift: torch.Tensor     # [3] f32


def _axis_tables(h: float, p: int):
    """Offsets, hat factors, their derivatives and weights along one axis."""
    eta, wg = np.polynomial.legendre.leggauss(int(p))
    off, hat, dhat, wt = [], [], [], []
    for s in (-1.0, 1.0):
        off.append(s * h * (1.0 + eta) / 2.0)
        hat.append((1.0 - eta) / 2.0)
        dhat.append(np.full_like(eta, -s / h))
        wt.append(wg * h / 2.0)
    return [np.concatenate(a) for a in (off, hat, dhat, wt)]


def build(problem: Problem, disc_num, b_disc_num: int, t_disc_num: int, integ_p_num: int = 2,
          input_scaling: bool = True, device="cpu") -> WeakData:
    f64 = dict(dtype=torch.float64, device=device)
    nx, ny = (int(disc_num),) * 2 if np.isscalar(disc_num) else (int(d) for d in disc_num)
    nt = int(t_disc_num)
    lo, hi = np.asarray(problem.lo, float), np.asarray(problem.hi, float)
    t0, t1 = (float(v) for v in problem.t_interval)
    xs, ys = np.linspace(lo[0], hi[0], nx + 1), np.linspace(lo[1], hi[1], ny + 1)
    ts = np.linspace(t0, t1, nt + 1)
    h = [(hi[0] - lo[0]) / nx, (hi[1] - lo[1]) / ny, (t1 - t0) / nt]

    cx, cy, ct = np.meshgrid(xs[1:-1], ys[1:-1], ts[1:-1], indexing="ij")
    centers = torch.tensor(np.stack([cx.ravel(), cy.ravel(), ct.ravel()], -1), **f64)

    tabs = [_axis_tables(hj, integ_p_num) for hj in h]
    grids = [np.meshgrid(*[t[k] for t in tabs], indexing="ij") for k in range(4)]
    off, hat, dhat, wt = ([g.ravel() for g in grid] for grid in grids)
    n_q = np.prod(hat, axis=0)
    dn_q = np.stack([dhat[j] * np.prod([hat[i] for i in range(3) if i != j], axis=0)
                     for j in range(2)], -1)
    w_q = np.prod(wt, axis=0)

    seg_ends = [((lo[0], lo[1]), (hi[0], lo[1])), ((hi[0], lo[1]), (hi[0], hi[1])),
                ((hi[0], hi[1]), (lo[0], hi[1])), ((lo[0], hi[1]), (lo[0], lo[1]))]
    s = np.linspace(0.0, 1.0, int(b_disc_num) + 1)[:-1, None]
    t_all = torch.tensor(ts, **f64)
    bc_x, bc_g = [], []
    for g, (a, b) in zip(problem.bcs, seg_ends):
        if g is None:
            continue
        pts = torch.tensor(np.asarray(a)[None] * (1 - s) + np.asarray(b)[None] * s, **f64)
        xt = torch.cat([pts.repeat(len(ts), 1),
                        t_all.repeat_interleave(pts.shape[0])[:, None]], dim=1)
        bc_x.append(xt)
        bc_g.append(g(xt[:, :2], xt[:, 2]))
    bc_x, bc_g = torch.cat(bc_x), torch.cat(bc_g)

    ix, iy = np.meshgrid(xs[1:-1], ys[1:-1], indexing="ij")
    ic_xy = torch.tensor(np.stack([ix.ravel(), iy.ravel()], -1), **f64)
    ic_x = torch.cat([ic_xy, torch.full_like(ic_xy[:, :1], t0)], dim=1)
    ic_g = problem.ic(ic_xy)

    f32 = dict(dtype=torch.float32, device=device)
    if input_scaling:
        span = np.array([hi[0] - lo[0], hi[1] - lo[1], t1 - t0])
        scale = torch.tensor(2.0 / span, **f32)
        shift = torch.tensor([(lo[0] + hi[0]) / 2, (lo[1] + hi[1]) / 2, (t0 + t1) / 2], **f32)
    else:
        scale, shift = torch.ones(3, **f32), torch.zeros(3, **f32)
    return WeakData(centers=centers, offsets=torch.tensor(np.stack(off, -1), **f64),
                    n=torch.tensor(n_q, **f32), dn=torch.tensor(dn_q, **f32),
                    w=torch.tensor(w_q, **f32), vol=float(np.sum(w_q)),
                    bc_x=bc_x.to(torch.float32), bc_g=bc_g.to(torch.float32),
                    ic_x=ic_x.to(torch.float32), ic_g=ic_g.to(torch.float32),
                    scale=scale, shift=shift)


def fields(problem: Problem, data: WeakData, k0: int, k1: int):
    """Quadrature points and coefficient fields of test functions k0 .. k1-1:
    (x [k, nQ, 3] f32, kappa, vel [k, nQ, 2], src [k, nQ]) in float32."""
    pts = data.centers[k0:k1, None, :] + data.offsets[None]
    flat = pts.reshape(-1, 3)
    vel = problem.velocity(flat[:, :2], flat[:, 2])
    src = problem.source(flat[:, :2], flat[:, 2])
    k, nq = pts.shape[0], pts.shape[1]
    return (pts.to(torch.float32), torch.tensor(problem.kappa, dtype=torch.float32),
            vel.to(torch.float32).reshape(k, nq, 2), src.to(torch.float32).reshape(k, nq))
