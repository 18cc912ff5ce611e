"""Inverse source identification (the port of
``varnet_tpu/examples/inverse_source.py``): jointly train the trial network
u_theta and a source network s_phi so that the weak-form residual with source
s_phi vanishes and u_theta matches observations of the manufactured
u* = sin(pi x) sin(pi y).  Scored against u* and the true source
s* = v . grad(u*) - kappa lap(u*).  On the card the interior runs through K1/K2
with the fixed source zeroed; the source net's term is added outside the kernel:

    python -m varnet_tpu_torch.examples.inverse_source --epochs 40000 --disc 30
"""

import numpy as np
import torch

from ..fem.assembly import PointData
from ..models.source import make_mlp_source
from ..problems.analytic import inverse_source_2d
from ..utils.helpers import rel_l2_error
from .common import make_parser, report, run_case


def main(argv=None):
    p = make_parser("2D inverse source identification", epochs=40000, disc=30,
                    save_freq=5000)
    p.add_argument("--kappa", type=float, default=0.1)
    p.add_argument("--n-obs", type=int, default=400)
    p.add_argument("--noise", type=float, default=0.0)
    args = p.parse_args(argv)
    case = inverse_source_2d(kappa=args.kappa, n_obs=args.n_obs, noise=args.noise,
                             seed=args.seed)
    pde = case["pde"]
    lo, hi = pde.domain.bounds
    source_fn, phi0 = make_mlp_source(torch.Generator().manual_seed(args.seed + 1), pde.dim,
                                      hidden=(16, 16), lo=lo, hi=hi)
    obs = PointData(coords=case["obs_x"], values=case["obs_u"],
                    mask=np.ones(case["obs_x"].shape[0]))
    vn = run_case(
        pde, args,
        weight=(1.0, 10.0, 100.0),  # (w_int, w_bc, w_obs): steady + obs
        source_fn=source_fn,
        source_init=phi0,
        obs_data=obs,
    )
    # score the recovered source on a grid
    pts, mask = pde.domain.grid_in_domain((65, 65))
    pts = pts[mask]
    s_err = rel_l2_error(vn.evaluate_field("source", pts), case["s_true"](pts))
    report({"source_rel_l2": s_err})
    return vn


if __name__ == "__main__":
    main()
