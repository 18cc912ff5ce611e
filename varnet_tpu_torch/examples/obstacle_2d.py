"""Steady AD around a square obstacle (manufactured solution): polygon HOLES
geometry (the port of ``varnet_tpu/examples/obstacle_2d.py``).

The obstacle boundary (segments 4-7) carries the non-trivial Dirichlet data that
drives the solution; ``--hard-bc`` imposes it exactly through trimmed segment
ADFs (``fem/hardbc.py``), and the Adam steps then run the precoeff residual (K4)
on the card:

    python -m varnet_tpu_torch.examples.obstacle_2d --hard-bc --width 48 \\
        --disc 48 --bdisc 48 --epochs 8000 --lm-steps 30 --lm-cg 200
"""

from ..problems.analytic import obstacle_manufactured_2d
from .common import make_parser, run_case


def main(argv=None):
    p = make_parser("2D steady AD around a square obstacle (manufactured)",
                    epochs=20000, disc=24)
    p.add_argument("--kappa", type=float, default=0.05)
    args = p.parse_args(argv)
    case = obstacle_manufactured_2d(kappa=args.kappa)
    return run_case(case["pde"], args, weight=(1.0, 10.0))


if __name__ == "__main__":
    main()
