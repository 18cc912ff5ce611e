"""Viscous Burgers (nonlinear advection via ``ADPDE(nl_adv=...)``): the 1-D tanh
traveling front by default, or the steady standing shock with ``--steady`` (the
port of ``varnet_tpu/examples/burgers_1d.py``).  The term u u_x rides the same
weak-form machinery as the linear PDE; on the card the Adam steps run the
jacobian-panel residual (K3), LM the value + jacobian kernels (K5/K6), and
``--hard-bc`` the general path through K5:

    python -m varnet_tpu_torch.examples.burgers_1d --width 32 --layers 3 --disc 48 \\
        --tdisc 32 --bdisc 48 --epochs 12000 --lm-steps 40 --lm-cg 200
"""

from ..problems.analytic import burgers_1d_steady, burgers_1d_transient
from .common import make_parser, run_case


def main(argv=None):
    p = make_parser("1D viscous Burgers (analytic)", epochs=20000, disc=48, tdisc=32)
    p.add_argument("--nu", type=float, default=0.05, help="viscosity (front width ~ nu/a)")
    p.add_argument("--amp", type=float, default=0.4, help="front height parameter a")
    p.add_argument("--speed", type=float, default=0.6, help="front speed c (transient only)")
    p.add_argument("--steady", action="store_true",
                   help="steady standing shock instead of the traveling front")
    args = p.parse_args(argv)
    if args.steady:
        case = burgers_1d_steady(nu=args.nu, a=args.amp)
        return run_case(case["pde"], args, weight=(1.0, 10.0))
    case = burgers_1d_transient(nu=args.nu, a=args.amp, c=args.speed)
    return run_case(case["pde"], args, weight=(1.0, 10.0, 10.0), t_disc_num=args.tdisc)


if __name__ == "__main__":
    main()
