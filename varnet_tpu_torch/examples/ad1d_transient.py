"""1-D transient advection-diffusion with a moving front (the port of
``varnet_tpu/examples/ad1d_transient.py``): space-time test functions and the IC
penalty; the exact solution is the erfc similarity front.

    python -m varnet_tpu_torch.examples.ad1d_transient --folder out/
"""

from ..problems.analytic import transient_ad_1d
from .common import make_parser, run_case


def main(argv=None):
    p = make_parser("1D transient AD (moving front)", epochs=30000, disc=40, tdisc=30)
    p.add_argument("--kappa", type=float, default=0.02)
    p.add_argument("--vel", type=float, default=1.0)
    args = p.parse_args(argv)
    case = transient_ad_1d(kappa=args.kappa, vel=args.vel)
    return run_case(case["pde"], args, weight=(1.0, 10.0, 10.0), t_disc_num=args.tdisc)


if __name__ == "__main__":
    main()
