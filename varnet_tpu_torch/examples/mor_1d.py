"""Parametric (MOR) training: one network amortizes a PDE family (the port of
``varnet_tpu/examples/mor_1d.py``).  The 1-D steady boundary layer with the
velocity (so the Peclet number) as the parameter mu: the trial net takes mu as an
extra input and trains over the pairing of the training points with the samples;
afterwards the same net is scored per sampled velocity, and at the midpoints
between them (held out), against the analytic solution.

    python -m varnet_tpu_torch.examples.mor_1d --vels 0.5,1.0,1.5,2.0
"""

import numpy as np

from ..geometry.domain import Domain1D
from ..problems.adpde import ADPDE, MORVar
from ..utils.helpers import rel_l2_error
from .common import make_parser, report, run_case


def main(argv=None):
    p = make_parser("1D steady AD amortized over Peclet number", epochs=30000, disc=40)
    p.add_argument("--kappa", type=float, default=0.1)
    p.add_argument("--vels", type=str, default="0.5,1.0,1.5,2.0")
    args = p.parse_args(argv)
    kappa = args.kappa
    vels = [float(v) for v in args.vels.split(",")]

    mor = MORVar(samples=np.array([[v] for v in vels]))

    def vel(x, t, mu):
        n = np.atleast_2d(x).shape[0]
        v = mu[:, 0] if mu is not None else np.full(n, vels[0])
        return v[:, None]

    def c_ex(x, t, mu):
        x1 = np.atleast_2d(x)[:, 0]
        pe = (mu[:, 0] if mu is not None else vels[0]) / kappa
        return np.expm1(pe * x1) / np.expm1(pe)

    pde = ADPDE(Domain1D(0.0, 1.0), diff=kappa, vel=vel, source=0.0, bcs=[0.0, 1.0],
                c_ex=c_ex, mor=mor)
    vn = run_case(pde, args, weight=(1.0, 10.0))

    x = np.linspace(0, 1, 201)[:, None]

    def score(vals):
        out = {}
        for v in vals:
            mu = np.array([v])
            u = vn.evaluate(x, mu=mu)
            ex = c_ex(x, None, np.broadcast_to(mu[None, :], (x.shape[0], 1)))
            out[str(v)] = rel_l2_error(u, ex)
        return out

    holdout = [0.5 * (a + b) for a, b in zip(vels[:-1], vels[1:])]
    report({"per_sample_rel_l2": score(vels), "holdout_rel_l2": score(holdout)})
    return vn


if __name__ == "__main__":
    main()
