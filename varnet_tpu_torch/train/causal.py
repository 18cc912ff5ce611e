"""Causal (growing-time-window) training for source-driven transient problems:
the PyTorch port of ``varnet_tpu/train/causal.py``.

Source-driven configurations with homogeneous BC/IC can train to the u = 0
attractor under full-window training: u = 0 satisfies every data term and sits
in a quasi-minimum of the interior loss.  Growing the window makes the source's
share of the residual large at first: train t in [0, w_1 T], then extend with
warm starts, so each stage starts from a state that already carries the plume
(the contaminant recipe of ``benchmarks/contaminant_causal.py``).

The trial net must mean the same thing across stages, so every stage's
``VarNet`` is built with ``input_scaling=False`` unless the caller overrides it:
input scaling would remap t per window and invalidate the warm start.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

from .checkpoint import list_checkpoint_steps

__all__ = ["train_causal"]


def train_causal(
    make_pde: Callable[[float], Any],
    windows: Sequence[float] = (0.25, 0.5, 0.75, 1.0),
    epoch_num: int = 8000,
    weight: Optional[Sequence[float]] = None,
    t_disc_full: int = 32,
    varnet_kwargs: Optional[Dict[str, Any]] = None,
    train_kwargs: Optional[Dict[str, Any]] = None,
    folderpath: Optional[str] = None,
    stage_hook: Optional[Callable] = None,
    stage_transfer: Optional[Callable] = None,
    verbose: bool = True,
    resume: bool = False,
):
    """Train through a growing sequence of time windows with warm starts.

    make_pde:      ``make_pde(t_end) -> ADPDE`` posed on t in [0, t_end]; the
                   last window must be 1.0 (the full problem)
    windows:       strictly increasing positive window fractions
    epoch_num:     Adam epochs per window
    weight:        loss weights, as ``VarNet.train``
    t_disc_full:   time elements at the FULL window; stage w uses
                   ``max(4, round(t_disc_full * w))`` so dt stays fixed
    varnet_kwargs: forwarded to every stage's ``VarNet`` (``input_scaling``
                   defaults to False here, see the module docstring)
    train_kwargs:  forwarded to every stage's ``.train`` call
    folderpath:    stage w checkpoints (and logs) under ``{folderpath}_w{w:g}``: a
                   fault mid-stage must not lose the warm-start chain
    stage_hook:    ``stage_hook(vn, window, result) -> dict`` run after each
                   stage; its return value is merged into the stage's record
    stage_transfer: ``stage_transfer(theta, w_prev, w_next) -> theta`` applied
                   to the warm-start iterate when the window grows
    resume:        continue a dead run from its per-stage checkpoints (needs
                   ``folderpath``): a stage whose folder holds ``epoch_num``
                   epochs is restored and skipped (its record is ``{"t_end",
                   "resumed", "epochs_done"}`` and ``stage_hook`` is not re-run),
                   a partly trained stage trains only its remaining epochs,
                   later stages run as usual; ``train_kwargs`` must not carry
                   ``resume`` (the curriculum sets it per stage)

    Returns ``(vn, stages)``: the final-window ``VarNet`` and a list of
    per-stage dicts ``{"t_end", "final_loss", "result", ...}``.
    """
    from ..api import VarNet

    windows = [float(w) for w in windows]
    if not windows or abs(windows[-1] - 1.0) > 1e-12:
        raise ValueError("the final window must be 1.0 (the full interval)")
    if any(b <= a for a, b in zip(windows, windows[1:])):
        raise ValueError("windows must be strictly increasing")
    if windows[0] <= 0.0:
        raise ValueError("windows must be positive fractions of the "
                         "interval (got a window <= 0)")
    if resume and folderpath is None:
        raise ValueError("resume=True requires folderpath (nothing to resume from)")
    vkw = dict(varnet_kwargs or {})
    vkw.setdefault("input_scaling", False)
    tkw = dict(train_kwargs or {})
    tkw.setdefault("verbose", verbose)
    if "resume" in tkw:
        raise ValueError("pass resume to train_causal itself, not via train_kwargs "
                         "(the curriculum manages per-stage resume)")
    for key in ("epoch_num", "weight", "folderpath"):
        if key in tkw:
            raise ValueError(f"pass {key} to train_causal itself, not via train_kwargs")
    tkw.setdefault("save_freq", max(epoch_num // 2, 1))

    theta = None
    stages: List[Dict[str, Any]] = []
    vn = None
    w_prev = None
    for w in windows:
        vn = VarNet(make_pde(w), t_disc_num=max(4, int(round(t_disc_full * w))), **vkw)
        if theta is not None:
            if stage_transfer is not None:
                theta = stage_transfer(theta, w_prev, w)
            vn.theta = theta
        w_prev = w
        folder = None if folderpath is None else f"{folderpath}_w{w:g}"
        steps = list_checkpoint_steps(folder) if resume else []
        done = steps[-1] if steps else 0
        if done >= epoch_num:
            # a completed stage: restore its theta (params only) and skip it
            step, _ = vn._restore_theta(folder)
            theta = vn.theta
            stages.append({"t_end": w, "resumed": True, "epochs_done": step})
            if verbose:
                print(f"[varnet/causal] window [0,{w}]: resumed complete ({step} epochs), "
                      "skipping", flush=True)
            continue
        # epoch_num is the window's TOTAL budget: train(resume=True) counts
        # global epochs and runs only the remainder
        res = vn.train(epoch_num=epoch_num, weight=weight, folderpath=folder,
                       resume=bool(done), **tkw)
        theta = vn.theta
        # empty when a fault retry found the work already done
        final_loss = res.losses[-1]["loss"] if res.losses else None
        rec = {"t_end": w, "final_loss": final_loss, "result": res}
        if stage_hook is not None:
            rec.update(stage_hook(vn, w, res) or {})
        stages.append(rec)
        if verbose:
            loss_s = "n/a (restored complete)" if final_loss is None else f"{final_loss:.3e}"
            print(f"[varnet/causal] window [0,{w}]: loss {loss_s}", flush=True)
    return vn, stages
