"""The numbers that decide ``correct``: the program's first steps against the
reference's from the same weights and data.

Norms are taken per leaf (each weight matrix and bias vector) and compared by
the worst leaf: the gap between the program's norm and the reference's, over
the larger of the reference's norm of that leaf and of the median leaf (some
gradients are all but zero).  A leaf whose reference gradient is under a
thousandth of the median leaf's moves by round-off alone and is left out of
the parameters' change.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional, Sequence

import torch


def leaves(pairs) -> List[torch.Tensor]:
    return [t for pair in pairs for t in pair]


def norms(pairs) -> List[float]:
    return [float(torch.linalg.vector_norm(t.double())) for t in leaves(pairs)]


def moving(ref_grad) -> List[bool]:
    g = norms(ref_grad)
    med = statistics.median(g)
    return [v >= 1e-3 * med for v in g]


def _leaf_gaps(prog: Sequence[float], ref: Sequence[float],
               keep: Optional[Sequence[bool]]) -> List[float]:
    keep = keep or [True] * len(ref)
    med = statistics.median([r for r, k in zip(ref, keep) if k])
    if not all(map(math.isfinite, prog)):
        return [math.inf]
    return [abs(p - r) / max(r, med, 1e-300) for p, r, k in zip(prog, ref, keep) if k]


def leaf_gap(prog: Sequence[float], ref: Sequence[float],
             keep: Optional[Sequence[bool]] = None) -> float:
    """The worst leaf's gap of norms."""
    return max(_leaf_gaps(prog, ref, keep))


def median_leaf_gap(prog: Sequence[float], ref: Sequence[float],
                    keep: Optional[Sequence[bool]] = None) -> float:
    """The median leaf's gap of norms: steady where one small leaf carries the
    noise of the later steps."""
    return statistics.median(_leaf_gaps(prog, ref, keep))


def change(after, before) -> List[float]:
    return [float(torch.linalg.vector_norm((a - b).double()))
            for a, b in zip(leaves(after), leaves(before))]


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    if len(prog) != len(ref) or not all(map(math.isfinite, prog)):
        return math.inf
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref))


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit (a missing limit fails)."""
    return all(name in limits and limits[name] is not None and v <= limits[name]
               for name, v in numbers.items())
