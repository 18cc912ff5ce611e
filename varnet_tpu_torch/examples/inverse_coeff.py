"""Inverse coefficient identification (the port of
``varnet_tpu/examples/inverse_coeff.py``): jointly train the trial net and a
trainable diffusivity (``--recover kappa``) or advection speed (``--recover
vel``) from sparse observations of the 1-D boundary-layer solution.  The true
coefficients are kappa = 0.08, v = 1.0; the chosen one starts wrong and is
recovered through Adam + LM (the layer shape pins Pe = v / kappa, so one of the
two is trainable at a time).  A trainable coefficient takes the general value +
jacobian path (K5 on the card; K5/K6 in LM):

    python -m varnet_tpu_torch.examples.inverse_coeff --recover kappa
"""

import numpy as np
import torch

from ..fem.assembly import PointData
from ..problems.analytic import steady_ad_1d
from .common import make_parser, report, run_case

KAPPA_TRUE = 0.08


def softplus_kappa(psi, x, t):
    """A constant field softplus(psi[0]) > 0 over the P points of x."""
    return torch.logaddexp(psi[0], torch.zeros_like(psi[0])).expand(x.shape[0])


def constant_vel(phi, x, t):
    """A constant [P, 1] velocity phi[0] (any sign)."""
    return phi[0].expand(x.shape[0], 1)


def main(argv=None):
    p = make_parser("1D inverse coefficient identification", epochs=6000, disc=24,
                    width=16)
    p.add_argument("--recover", choices=("kappa", "vel"), default="kappa")
    p.add_argument("--n-obs", type=int, default=25)
    p.add_argument("--init-frac", type=float, default=0.4,
                   help="wrong initial coefficient = frac * true value")
    p.set_defaults(lm_steps=5)  # --lm-steps comes from make_parser
    args = p.parse_args(argv)

    case = steady_ad_1d(kappa=KAPPA_TRUE)
    xs = np.linspace(0.05, 0.95, args.n_obs)[:, None]
    obs = PointData(coords=xs.astype(np.float32),
                    values=case["c_ex"](xs).astype(np.float32),
                    mask=np.ones(len(xs), np.float32))

    if args.recover == "kappa":
        true = KAPPA_TRUE
        kw = dict(diff_fn=softplus_kappa,
                  diff_init=np.array([np.log(np.expm1(args.init_frac * true))]))
    else:
        true = 1.0
        kw = dict(vel_fn=constant_vel, vel_init=np.array([args.init_frac * true]))

    # run_case runs Adam and (lm_steps > 0) the LM polish
    vn = run_case(case["pde"], args, weight=(1.0, 10.0, 10.0), obs_data=obs, **kw)
    c = float(np.ravel(vn.evaluate_field(args.recover, np.zeros((1, 1))))[0])
    report({
        "recover": args.recover, "true": true,
        "init": float(args.init_frac * true),
        "recovered": c, "rel_err": abs(c - true) / true,
    })
    return vn


if __name__ == "__main__":
    main()
