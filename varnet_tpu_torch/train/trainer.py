"""Training step + result record.

PyTorch counterpart of ``varnet_tpu/train/trainer.py``.  The step runs
eagerly; parameters are leaf tensors that the optimizer updates IN PLACE
(the JAX step returns new, donated buffers instead).  ``batch_num > 1``
loops over interior mini-batches inside the epoch, as the JAX step's
``lax.scan`` does; BC/IC penalty points, observation and flux rows stay
full-batch.  Per-node test
tables (order-2 test spaces, refined hats) and the exact-BC quad tables split
with the test functions they belong to.

Data parallel (``parallel/mesh.py``): each rank's loss is its shard's share of
the global loss (the loss normalizes by the global counts), and after the
backward ONE ``dist.all_reduce`` sums the packed gradients and loss terms, as
the JAX step's single packed ``psum``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from ..fem.assembly import QuadData, _pad_to_multiple
from ..parallel.mesh import all_reduce_sum


def reshape_batches(quad: QuadData, batch_num: int) -> QuadData:
    """Host arrays: split the leading test-function axis K into [batch_num,
    K // batch_num] (the JAX package's ``_tree_reshape_batches``); shared [nQ]
    tables are left as they are."""
    k = quad.coords.shape[0]
    if k % batch_num:
        raise ValueError(f"test-function count {k} not divisible by batch_num {batch_num}; "
                         f"pad with pad_quad(quad, batch_num)")

    def r(a, per_node):
        return a.reshape((batch_num, k // batch_num) + a.shape[1:]) if per_node else a

    per_node = quad.tables_per_node
    return QuadData(*(r(a, f not in ("N", "dN", "w") or per_node)
                      for f, a in zip(QuadData._fields, quad)))


def pad_axis1(a: np.ndarray, target: int, fill_zero: bool = False) -> np.ndarray:
    """Pad axis 1 of a batched [B, Kb, ...] host array to ``target`` with each
    batch's row 0 (zeros with ``fill_zero``)."""
    kb = a.shape[1]
    if kb == target:
        return a
    filler = np.repeat(a[:, :1], target - kb, axis=1)
    if fill_zero:
        filler = np.zeros_like(filler)
    return np.concatenate([a, filler], axis=1)


def pad_batched_axis1(quad: QuadData, multiple: int) -> QuadData:
    """Pad the per-batch test axis of a batched host QuadData ([B, Kb, ...]) to
    a multiple of the shard count (the JAX package's ``_pad_batched_axis1``).

    Mini-batch membership is fixed by the batch split BEFORE this padding, so
    the same real test functions land in the same batch for any number of
    ranks; only the masked filler rows (each batch's row 0, zero mask) differ.
    """
    target = _pad_to_multiple(quad.coords.shape[1], multiple)
    per_node = quad.tables_per_node
    return QuadData(*(a if f in ("N", "dN", "w") and not per_node
                      else pad_axis1(a, target, fill_zero=f == "mask")
                      for f, a in zip(QuadData._fields, quad)))


def reduce_grads_and_aux(params, aux: dict, mesh) -> dict:
    """Sum every parameter's gradient and the loss terms ``aux`` over the ranks
    with ONE all-reduce of a packed tensor; the gradients are replaced by their
    sums (a leaf the loss did not reach counts as zero), the summed ``aux`` is
    returned."""
    grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
    vals = [v.detach().reshape(-1).to(grads[0].dtype) for v in aux.values()]
    packed = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads] + vals), mesh)
    offset = 0
    for p, g in zip(params, grads):
        p.grad = packed[offset:offset + g.numel()].view_as(g)
        offset += g.numel()
    out = {}
    for (k, v), flat in zip(aux.items(), vals):
        out[k] = packed[offset:offset + flat.numel()].reshape(v.shape).to(v.dtype)
        offset += flat.numel()
    return out


def make_train_step(loss_fn: Callable, optimizer, batch_num: int = 1, mesh=None):
    """Build the per-epoch update.

    Returns ``epoch_step(theta, quad, bc, ic, weights, prepared, hard=None,
    **rows) -> aux``: one optimizer update per mini-batch; ``quad``/``prepared``/
    ``hard`` are lists of per-batch items when ``batch_num > 1``, and ``rows``
    (the loss's full-batch ``obs`` / ``neu`` / ``hard_obs`` / ``hard_neu``) go
    to every one.  ``aux`` holds detached loss tensors (batch means), still on
    the device.  With a distributed ``mesh`` the data are this rank's shard and
    each update runs one all-reduce (``reduce_grads_and_aux``) before the
    optimizer steps; ``aux`` is then global.
    """
    distributed = mesh is not None and mesh.distributed

    def one_update(theta, quad, bc, ic, weights, prepared, hard=None, **rows):
        optimizer.zero_grad()
        total, aux = loss_fn(theta, quad, bc, ic, weights, prepared, hard, **rows)
        total.backward()
        if distributed:
            aux = reduce_grads_and_aux(optimizer.params, aux, mesh)
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
    # host seconds of the call's set-up before its first step (data layout,
    # rows, optimizer, resume) and of its reports (loss to host, error, log,
    # checkpoint); steps_per_sec leaves both out
    prepare_seconds: float = 0.0
    report_seconds: float = 0.0

    def as_dict(self) -> Dict[str, Any]:
        return {
            "epochs": self.epochs,
            "losses": self.losses,
            "errors": self.errors,
            "wall_times": self.wall_times,
            "quad_evals_per_sec": self.quad_evals_per_sec,
            "steps_per_sec": self.steps_per_sec,
            "total_steps": self.total_steps,
            "prepare_seconds": self.prepare_seconds,
            "report_seconds": self.report_seconds,
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
