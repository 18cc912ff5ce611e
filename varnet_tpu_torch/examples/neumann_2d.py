"""2-D steady AD with mixed boundary conditions: Dirichlet on three edges,
Neumann flux data on the right edge (the port of
``varnet_tpu/examples/neumann_2d.py``).  Manufactured solution
u = sin(pi x) sin(pi y), with kappa du/dn = kappa pi cos(pi) sin(pi y) on x = 1.
The flux rows add w_bc * mean |kappa du/dn - g|^2 to the loss and to the LM
residual; on the card the interior runs through K1/K2 (K4 with ``--hard-bc``):

    python -m varnet_tpu_torch.examples.neumann_2d --epochs 30000 --disc 30
"""

from ..problems.analytic import steady_ad_2d_neumann
from .common import make_parser, run_case


def main(argv=None):
    p = make_parser("2D steady AD, mixed Dirichlet/Neumann BCs", epochs=30000, disc=30)
    p.add_argument("--kappa", type=float, default=0.1)
    args = p.parse_args(argv)
    case = steady_ad_2d_neumann(kappa=args.kappa)
    return run_case(case["pde"], args, weight=(1.0, 10.0))


if __name__ == "__main__":
    main()
