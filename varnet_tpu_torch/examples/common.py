"""Shared CLI runner for the example cases (the port of
``varnet_tpu/examples/common.py``):

    python -m varnet_tpu_torch.examples.contaminant_2d --epochs 20000 --folder out/

Runs on the CUDA card unless ``--device cpu`` is given.  ``--folder`` holds the
checkpoints (``ckpt_<epoch>/``, meta sidecars, ``config.json``), the training log
and the result; ``--resume`` continues from its newest checkpoint toward the
TOTAL ``--epochs`` (a no-op once they are done).  Flags whose machinery is not
ported yet are accepted by the parser (the JAX package's command lines stay
valid) and refused with the name of the missing feature.
"""

from __future__ import annotations

import argparse
import json

from ..api import VarNet
from ..train.optim import OptimizerConfig

# flag -> (value that asks for it, the feature it needs)
UNPORTED = {
    "ensemble": (lambda v: v >= 2, "ensemble training (train_ensemble)"),
    "plot": (True, "solution plots (sim_res)"),
    "devices": (lambda v: v is not None and v != 1, "multi-device training"),
}


def make_parser(desc: str, **defaults) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--epochs", type=int, default=defaults.get("epochs", 20000))
    p.add_argument("--disc", type=int, default=defaults.get("disc", 30))
    p.add_argument("--tdisc", type=int, default=defaults.get("tdisc", 20))
    p.add_argument("--bdisc", type=int, default=defaults.get("bdisc", 20))
    p.add_argument("--width", type=int, default=defaults.get("width", 20))
    p.add_argument("--layers", type=int, default=defaults.get("layers", 2))
    p.add_argument("--lr", type=float, default=defaults.get("lr", 1e-3))
    p.add_argument("--decay", type=float, default=defaults.get("decay", 0.4),
                   help="exponential lr decay factor (0 disables)")
    p.add_argument("--decay-every", type=int, default=None,
                   help="decay period in epochs (default: epochs // 6)")
    p.add_argument("--precision", type=str, default=defaults.get("precision", None),
                   help="matmul precision of LM ('highest' = exact f32, the default)")
    p.add_argument("--lm-steps", type=int, default=0,
                   help="Levenberg-Marquardt polish iterations after Adam")
    p.add_argument("--lm-cg", type=int, default=50)
    p.add_argument("--lm-precond", type=int, default=0,
                   help="Jacobi-PCG probes inside LM (0 = plain CG)")
    p.add_argument("--ensemble", type=int, default=0, help="not ported yet")
    p.add_argument("--batch-num", type=int, default=1)
    p.add_argument("--save-freq", type=int, default=defaults.get("save_freq", 2000))
    p.add_argument("--folder", type=str, default=None,
                   help="case folder for checkpoints and logs")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest checkpoint in --folder")
    p.add_argument("--target", type=float, default=None,
                   help="early-stop rel-L2 error target")
    p.add_argument("--plot", action="store_true", help="not ported yet")
    p.add_argument("--test-order", type=int, default=1, choices=(1, 2),
                   help="test-function order: 1 = hats (reference), 2 = quadratic Lagrange")
    p.add_argument("--hard-bc", action="store_true",
                   help="exact Dirichlet-BC/IC imposition (u = G + tau D net; the BC/IC "
                        "penalty rows drop out)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--devices", type=int, default=None, help="one device only for now")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device ('cuda' needs an NVIDIA GPU; 'cpu' for small runs)")
    return p


def refuse_unported(args) -> None:
    """Exit with a message naming the missing feature of each unported flag asked for."""
    for name, (asks, feature) in UNPORTED.items():
        value = getattr(args, name, None)
        if (asks(value) if callable(asks) else value == asks):
            raise SystemExit(f"--{name.replace('_', '-')} is not ported to varnet_tpu_torch "
                             f"yet: it needs {feature}")


def optimizer_of(args) -> OptimizerConfig:
    return OptimizerConfig(lr=args.lr, decay_rate=getattr(args, "decay", 0.0) or None,
                           decay_steps=getattr(args, "decay_every", None)
                           or max(args.epochs // 6, 1))


def refine(vn: VarNet, args, weight, folderpath=None):
    """The LM polish of ``--lm-steps`` (or None without it); with
    ``folderpath`` it checkpoints into its ``lm/``."""
    if not getattr(args, "lm_steps", 0):
        return None
    return vn.refine_lm(
        steps=args.lm_steps, weight=weight, cg_iters=args.lm_cg,
        save_freq=max(args.lm_steps // 10, 1), target_error=args.target,
        matmul_precision=getattr(args, "precision", None) or "highest",
        precond=getattr(args, "lm_precond", 0), folderpath=folderpath,
    )


def run_case(pde, args, weight, t_disc_num=None, **varnet_kwargs) -> VarNet:
    refuse_unported(args)
    vn = VarNet(
        pde,
        layer_width=(args.width,) * args.layers,
        disc_num=args.disc,
        b_disc_num=args.bdisc,
        t_disc_num=t_disc_num,
        test_order=args.test_order,
        seed=args.seed,
        device=args.device,
        optimizer=optimizer_of(args),
        hard_bc=getattr(args, "hard_bc", False),
        **varnet_kwargs,
    )
    res = vn.train(
        epoch_num=args.epochs,
        weight=weight,
        batch_num=args.batch_num,
        save_freq=args.save_freq,
        folderpath=args.folder,
        resume=args.resume,
        target_error=args.target,
    )
    summary = {
        "best_rel_l2": res.best_error(),
        "final_loss": res.losses[-1]["loss"] if res.losses else None,
        "quad_evals_per_sec": res.quad_evals_per_sec,
        "steps_per_sec": res.steps_per_sec,
    }
    r_lm = refine(vn, args, weight)
    if r_lm is not None:
        summary["lm_best_rel_l2"] = r_lm.best_error()
    print(json.dumps(summary))
    return vn
