"""2-D contaminant transport in a Poiseuille shear flow (the port of
``varnet_tpu/examples/contaminant_2d.py``).

DEFAULT variant: a time-gated Dirichlet inlet profile.  ``--volumetric-source``
selects the gated-Gaussian volumetric source, whose homogeneous BC/IC put
full-window training in the u = 0 attractor; pair it with ``--causal N``
(growing time windows, ``train/causal.py``) and ``--ff`` / ``--ff-scale`` (a
multi-scale Fourier basis), the recipe of ``benchmarks/contaminant_causal.py``:

    python -m varnet_tpu_torch.examples.contaminant_2d --volumetric-source \\
        --causal 4 --ff 128 --ff-scale 0.5,2.0 --width 96 --layers 3 \\
        --disc 64 --tdisc 40 --bdisc 64 --lr 2e-3 --epochs 8000 --lm-steps 12
"""

from ..problems.analytic import contaminant_inlet_2d, contaminant_transport_2d
from .common import make_parser, optimizer_of, plot, refine, report, run_case, setup_devices


def main(argv=None):
    p = make_parser("2D contaminant transport (shear flow)", epochs=50000,
                    disc=40, tdisc=25, save_freq=5000)
    p.add_argument("--kappa", type=float, default=None)
    p.add_argument("--umax", type=float, default=1.0)
    p.add_argument("--volumetric-source", action="store_true",
                   help="the source-driven variant (see module docstring)")
    p.add_argument("--causal", type=int, default=0, metavar="N",
                   help="train through N growing time windows (volumetric-"
                        "source variant; escapes the u=0 attractor)")
    p.add_argument("--ff", type=int, default=0,
                   help="random Fourier features (0 = plain MLP)")
    p.add_argument("--ff-scale", type=str, default="0.5,2.0",
                   help="FF scale, or comma-list for a multi-scale basis")
    args = p.parse_args(argv)
    if args.causal and not args.volumetric_source:
        p.error("--causal applies to the --volumetric-source variant "
                "(the inlet variant trains full-window without it)")
    extra = {}
    if args.ff:
        extra = dict(fourier_features=args.ff, fourier_scale=args.ff_scale)
    if args.volumetric_source:
        kap = 0.01 if args.kappa is None else args.kappa
        if args.causal:
            return _run_causal(args, kap, extra)
        case = contaminant_transport_2d(kappa=kap, u_max=args.umax)
    else:
        kap = 0.03 if args.kappa is None else args.kappa
        case = contaminant_inlet_2d(kappa=kap, u_max=args.umax)
    return run_case(case["pde"], args, weight=(1.0, 10.0, 10.0), t_disc_num=args.tdisc,
                    **extra)


def _run_causal(args, kap, extra):
    from ..train.causal import train_causal

    setup_devices(args)
    w = (1.0, 10.0, 10.0)
    vn, stages = train_causal(
        lambda t_end: contaminant_transport_2d(
            kappa=kap, u_max=args.umax, t_final=t_end)["pde"],
        windows=[(i + 1) / args.causal for i in range(args.causal)],
        epoch_num=args.epochs, weight=w, t_disc_full=args.tdisc,
        varnet_kwargs=dict(
            layer_width=(args.width,) * args.layers, disc_num=args.disc,
            b_disc_num=args.bdisc, seed=args.seed, device=args.device,
            n_devices=args.devices, optimizer=optimizer_of(args), **extra),
        train_kwargs=dict(batch_num=args.batch_num, save_freq=args.save_freq),
        folderpath=args.folder,
        resume=args.resume,
    )
    summary = {"stage_losses": [s.get("final_loss") for s in stages]}
    r_lm = refine(vn, args, w, folderpath=args.folder)
    if r_lm is not None and r_lm.losses:
        summary["lm_final_loss"] = r_lm.losses[-1]["loss"]
    report(summary)
    plot(vn, args)
    return vn


if __name__ == "__main__":
    main()
