"""The flagship: 2-D transient advection-diffusion with an analytic solution (the
port of ``varnet_tpu/examples/ad2d_transient.py``), the translating, decaying sine
whose Adam steps run K1/K2 on the card and whose LM polish K5/K6:

    python -m varnet_tpu_torch.examples.ad2d_transient --folder out/
    python -m varnet_tpu_torch.examples.ad2d_transient --folder out/ --epochs 60000 --resume
"""

from ..problems.analytic import transient_ad_2d
from .common import make_parser, run_case


def main(argv=None):
    p = make_parser("2D transient AD (analytic, flagship)", epochs=50000, disc=30, tdisc=20,
                    save_freq=5000)
    p.add_argument("--kappa", type=float, default=0.05)
    args = p.parse_args(argv)
    case = transient_ad_2d(kappa=args.kappa)
    return run_case(case["pde"], args, weight=(1.0, 10.0, 10.0), t_disc_num=args.tdisc)


if __name__ == "__main__":
    main()
