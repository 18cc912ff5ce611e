"""Steady advection-diffusion in an L-shaped duct, a non-convex extruded-polygon 3-D
domain (``PrismDomain3D``; the port of ``varnet_tpu/examples/ad3d_prism.py``).

Manufactured solution u = sin(pi x) sin(pi y) sin(pi z): zero on the four outer walls
and both caps, non-trivial Dirichlet data on the two re-entrant inner walls.
``--hard-bc`` imposes the data exactly through extruded trimmed segment ADFs.

    python -m varnet_tpu_torch.examples.ad3d_prism --hard-bc --folder out/
"""

from ..problems.analytic import steady_ad_prism
from .common import make_parser, run_case


def main(argv=None):
    p = make_parser("3D steady AD on an L-shaped prism (manufactured)", epochs=20000,
                    disc=12)
    p.add_argument("--kappa", type=float, default=0.05)
    args = p.parse_args(argv)
    case = steady_ad_prism(kappa=args.kappa)
    return run_case(case["pde"], args, weight=(1.0, 10.0))


if __name__ == "__main__":
    main()
