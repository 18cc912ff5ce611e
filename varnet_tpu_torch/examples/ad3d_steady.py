"""3-D steady advection-diffusion on the unit cube, manufactured solution
u = sin(pi x) sin(pi y) sin(pi z) (the port of ``varnet_tpu/examples/ad3d_steady.py``).

    python -m varnet_tpu_torch.examples.ad3d_steady --folder out/
"""

from ..problems.analytic import steady_ad_3d
from .common import make_parser, run_case


def main(argv=None):
    p = make_parser("3D steady AD (manufactured)", epochs=20000, disc=12)
    p.add_argument("--kappa", type=float, default=0.1)
    args = p.parse_args(argv)
    case = steady_ad_3d(kappa=args.kappa)
    return run_case(case["pde"], args, weight=(1.0, 10.0))


if __name__ == "__main__":
    main()
