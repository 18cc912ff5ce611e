"""1-D steady advection-diffusion with an analytic solution (the port of
``varnet_tpu/examples/ad1d_steady.py``): the boundary layer v u_x - kappa u_xx = 0,
u(0) = 0, u(1) = 1, advection-dominated for small kappa.

    python -m varnet_tpu_torch.examples.ad1d_steady --folder out/
"""

from ..problems.analytic import steady_ad_1d
from .common import make_parser, run_case


def main(argv=None):
    p = make_parser("1D steady AD (analytic)", epochs=30000, disc=40)
    p.add_argument("--kappa", type=float, default=0.05)
    p.add_argument("--vel", type=float, default=1.0)
    args = p.parse_args(argv)
    case = steady_ad_1d(kappa=args.kappa, vel=args.vel)
    return run_case(case["pde"], args, weight=(1.0, 10.0))


if __name__ == "__main__":
    main()
