"""The variational loss of the reference and its residual vector r_vec, with
sum(r_vec^2) = L, block by block.  What the rows are is the configuration's
weak form (``forms/<form>.py``); the sums, the gradient and the loss over all
blocks are the same for every form.
"""

from __future__ import annotations

from types import ModuleType
from typing import Any, NamedTuple, Optional

import torch


class Setup(NamedTuple):
    problem: Any
    data: Any                 # the form's fixed data (mesh, tables, penalty points)
    weights: tuple            # (w_int, w_bc, w_ic)
    bt2pi: Optional[torch.Tensor]
    block: int                # test functions per block
    form: ModuleType          # forms/<form>.py: blocks(setup), rows(params, setup, blk)


def rows(params, setup: Setup, blk) -> torch.Tensor:
    """The rows of r_vec of one block: test functions blk = (k0, k1), or the
    penalty rows for blk None."""
    return setup.form.rows(params, setup, blk)


def all_blocks(setup: Setup):
    return setup.form.blocks(setup) + [None]


def loss_and_grad(params, setup: Setup):
    """(L, dL/dparams) in float32, block by block."""
    leaves = [p.detach().requires_grad_(True) for pair in params for p in pair]
    pairs = list(zip(leaves[0::2], leaves[1::2]))
    total = torch.zeros((), device=leaves[0].device)
    grads = [torch.zeros_like(p) for p in leaves]
    for blk in all_blocks(setup):
        with torch.enable_grad():
            r = rows(pairs, setup, blk)
            part = torch.dot(r, r)
            for g, gp in zip(grads, torch.autograd.grad(part, leaves, allow_unused=True,
                                                          materialize_grads=True)):
                g += gp
        total = total + part.detach()
    return total, [(grads[i], grads[i + 1]) for i in range(0, len(grads), 2)]


def loss(params, setup: Setup) -> torch.Tensor:
    with torch.no_grad():
        total = torch.zeros((), device=params[0][0].device)
        for blk in all_blocks(setup):
            r = rows(params, setup, blk)
            total = total + torch.dot(r, r)
    return total
