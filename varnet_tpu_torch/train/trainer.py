"""Training step + result record (single device).

PyTorch counterpart of ``varnet_tpu/train/trainer.py``.  The step runs
eagerly; parameters are leaf tensors that the optimizer updates IN PLACE
(the JAX step returns new, donated buffers instead).  ``batch_num > 1``
loops over interior mini-batches inside the epoch, as the JAX step's
``lax.scan`` does; BC/IC penalty points stay full-batch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List

import torch

from ..fem.assembly import QuadData


def split_batches(quad: QuadData, batch_num: int) -> List[QuadData]:
    """Split the leading test-function axis K into ``batch_num`` contiguous
    mini-batches (the reference's ``ManageTrainData`` batching); the shared
    [nQ] tables are the same object in every batch."""
    k = quad.coords.shape[0]
    if k % batch_num != 0:
        raise ValueError(f"test-function count {k} not divisible by batch_num "
                         f"{batch_num}; pad with pad_quad(quad, batch_num)")
    kb = k // batch_num
    return [
        quad._replace(**{f: getattr(quad, f)[b * kb:(b + 1) * kb]
                         for f in ("coords", "kappa", "vel", "src", "react", "mask")})
        for b in range(batch_num)
    ]


def make_train_step(loss_fn: Callable, optimizer, batch_num: int = 1):
    """Build the per-epoch update.

    Returns ``epoch_step(theta, quad, bc, ic, weights, prepared) -> aux``:
    one optimizer update per mini-batch; ``quad``/``prepared`` are lists of
    per-batch items when ``batch_num > 1``.  ``aux`` holds detached loss
    tensors (batch means), still on the device.
    """

    def one_update(theta, quad, bc, ic, weights, prepared):
        optimizer.zero_grad()
        total, aux = loss_fn(theta, quad, bc, ic, weights, prepared)
        total.backward()
        optimizer.step()
        return {k: v.detach() for k, v in aux.items()}

    if batch_num == 1:
        return one_update

    def epoch_step(theta, quads, bc, ic, weights, prepared):
        auxes = [one_update(theta, qb, bc, ic, weights, pb)
                 for qb, pb in zip(quads, prepared)]
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

