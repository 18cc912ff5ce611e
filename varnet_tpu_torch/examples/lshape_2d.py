"""Steady advection-diffusion on a non-convex L-shaped polygon (the port of
``varnet_tpu/examples/lshape_2d.py``).  By default the manufactured-solution
configuration (non-trivial Dirichlet data on the inner re-entrant edges, scored by
rel-L2); ``--gaussian-source`` selects the unscored demo (uniform flow around the
inner corner, a Gaussian source, zero Dirichlet walls).

    python -m varnet_tpu_torch.examples.lshape_2d --folder out/
"""

import numpy as np

from ..geometry.domain import PolygonDomain2D
from ..problems.adpde import ADPDE
from .common import make_parser, run_case


def main(argv=None):
    p = make_parser("steady AD on an L-shaped domain", epochs=20000, disc=40)
    p.add_argument("--kappa", type=float, default=0.05)
    p.add_argument("--gaussian-source", action="store_true",
                   help="the unscored demo configuration (Gaussian source, no exact "
                        "solution) instead of the manufactured-solution one")
    args = p.parse_args(argv)

    if not args.gaussian_source:
        from ..problems.analytic import lshape_manufactured_2d

        case = lshape_manufactured_2d(kappa=args.kappa)
        return run_case(case["pde"], args, weight=(1.0, 10.0))

    # the unit square with its top-right quadrant removed
    domain = PolygonDomain2D(np.array([
        [0.0, 0.0], [1.0, 0.0], [1.0, 0.5], [0.5, 0.5], [0.5, 1.0], [0.0, 1.0],
    ]))

    def source(x):
        x = np.atleast_2d(x)
        return np.exp(-((x[:, 0] - 0.25) ** 2 + (x[:, 1] - 0.25) ** 2) / (2 * 0.05**2))

    pde = ADPDE(domain, diff=args.kappa, vel=np.array([1.0, 0.5]), source=source, bcs=0.0)
    return run_case(pde, args, weight=(1.0, 10.0))


if __name__ == "__main__":
    main()
