"""Training step + result record (single device).

PyTorch counterpart of ``varnet_tpu/train/trainer.py``.  The step runs
eagerly; parameters are leaf tensors that the optimizer updates IN PLACE
(the JAX step returns new, donated buffers instead).  ``batch_num > 1``
loops over interior mini-batches inside the epoch, as the JAX step's
``lax.scan`` does; BC/IC penalty points, observation and flux rows stay
full-batch.  Per-node test
tables (order-2 test spaces, refined hats) and the exact-BC quad tables split
with the test functions they belong to.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from ..fem.assembly import QuadData


def split_rows(rows, batch_num: int) -> list:
    """Split a NamedTuple of arrays with a leading test-function axis K (a
    QuadData's node arrays, HardQuad tables; None fields stay None) into
    ``batch_num`` contiguous mini-batches."""
    k = next(a for a in rows if a is not None).shape[0]
    if k % batch_num != 0:
        raise ValueError(f"test-function count {k} not divisible by batch_num "
                         f"{batch_num}; pad with pad_quad(quad, batch_num)")
    kb = k // batch_num
    return [type(rows)(*(None if a is None else a[b * kb:(b + 1) * kb] for a in rows))
            for b in range(batch_num)]


def split_batches(quad: QuadData, batch_num: int) -> List[QuadData]:
    """Split the leading test-function axis K into ``batch_num`` contiguous
    mini-batches (the reference's ``ManageTrainData`` batching); shared [nQ]
    tables are the same object in every batch, per-node [K, nQ] tables split
    with their test functions."""
    if quad.tables_per_node:
        return split_rows(quad, batch_num)
    return [b._replace(N=quad.N, dN=quad.dN, w=quad.w)
            for b in split_rows(quad._replace(N=None, dN=None, w=None), batch_num)]


def make_train_step(loss_fn: Callable, optimizer, batch_num: int = 1):
    """Build the per-epoch update.

    Returns ``epoch_step(theta, quad, bc, ic, weights, prepared, hard=None,
    **rows) -> aux``: one optimizer update per mini-batch; ``quad``/``prepared``/
    ``hard`` are lists of per-batch items when ``batch_num > 1``, and ``rows``
    (the loss's full-batch ``obs`` / ``neu`` / ``hard_obs`` / ``hard_neu``) go
    to every one.  ``aux`` holds detached loss tensors (batch means), still on
    the device.
    """

    def one_update(theta, quad, bc, ic, weights, prepared, hard=None, **rows):
        optimizer.zero_grad()
        total, aux = loss_fn(theta, quad, bc, ic, weights, prepared, hard, **rows)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in aux.items()}

    if batch_num == 1:
        return one_update

    def epoch_step(theta, quads, bc, ic, weights, prepared, hard=None, **rows):
        hards = [None] * len(quads) if hard is None else hard
        auxes = [one_update(theta, qb, bc, ic, weights, pb, hb, **rows)
                 for qb, pb, hb in zip(quads, prepared, hards)]
        return {k: torch.stack([a[k] for a in auxes]).mean() for k in auxes[0]}

    return epoch_step


@dataclass
class TrainResult:
    """Training history (reference ``TrainResult``)."""

    epochs: List[int] = field(default_factory=list)
    losses: List[Dict[str, float]] = field(default_factory=list)
    errors: List[float] = field(default_factory=list)      # rel-L2 vs c_ex
    wall_times: List[float] = field(default_factory=list)  # seconds since start
    quad_evals_per_sec: float = 0.0   # quadrature-point residual evals/s
    steps_per_sec: float = 0.0
    total_steps: int = 0

    def as_dict(self) -> Dict[str, Any]:
        return {
            "epochs": self.epochs,
            "losses": self.losses,
            "errors": self.errors,
            "wall_times": self.wall_times,
            "quad_evals_per_sec": self.quad_evals_per_sec,
            "steps_per_sec": self.steps_per_sec,
            "total_steps": self.total_steps,
        }

    def best_error(self) -> Optional[float]:
        return min(self.errors) if self.errors else None



@dataclass
class EnsembleResult:
    """History of a multi-seed ensemble run (``VarNet.train_ensemble``): E
    independently seeded nets trained side by side, one optimizer update per
    step over all of them."""

    epochs: List[int] = field(default_factory=list)
    member_losses: List[List[float]] = field(default_factory=list)  # [T][E]
    member_errors: List[List[float]] = field(default_factory=list)  # [T][E]
    wall_times: List[float] = field(default_factory=list)
    best_member: int = 0
    best_error: Optional[float] = None
    n_members: int = 0
    # member-evaluations/s: epochs * E * n_quad / wall (each member
    # evaluates every quad point every epoch)
    quad_evals_per_sec: float = 0.0
    steps_per_sec: float = 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {
            "epochs": self.epochs,
            "member_losses": self.member_losses,
            "member_errors": self.member_errors,
            "wall_times": self.wall_times,
            "best_member": self.best_member,
            "best_error": self.best_error,
            "n_members": self.n_members,
            "quad_evals_per_sec": self.quad_evals_per_sec,
            "steps_per_sec": self.steps_per_sec,
        }
