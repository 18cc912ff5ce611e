"""Problem definitions of the plain reference, one file per problem factory of the
program, found by the factory's name: ``problems/<factory>.py`` defines
``build(**kwargs) -> Problem``."""

from __future__ import annotations

import importlib
from typing import Callable, List, NamedTuple, Optional, Sequence


class Problem(NamedTuple):
    """A 2-D transient advection-diffusion problem on the rectangle [lo, hi].

    velocity(x, t) -> [n, 2], source(x, t) -> [n]; bcs: one callable g(x, t) -> [n]
    per boundary segment (bottom, right, top, left), None for a free segment;
    ic(x) -> [n]."""

    lo: Sequence[float]
    hi: Sequence[float]
    t_interval: Sequence[float]
    kappa: float
    velocity: Callable
    source: Callable
    bcs: List[Optional[Callable]]
    ic: Callable


def build(factory: str, **kwargs) -> Problem:
    return importlib.import_module(f"{__name__}.{factory}").build(**kwargs)
