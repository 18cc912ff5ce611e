"""[Copy of ``varnet_tpu/problems/adpde.py``, pure NumPy, so that the PyTorch port
imports no JAX; ``tests/test_torch_host.py`` holds the two bit-equal.]

Advection-diffusion PDE problem definition.

TPU-native re-implementation of the reference problem layer
(reference: ``ADPDE.py``, classes ``ADPDE`` and ``MORvar`` — SURVEY.md
§2.1 #3).  Defines the PDE

    du/dt + v(x,t) . grad(u) - div(kappa(x,t) grad(u)) = s(x,t)   on Omega x (0,T]
    u = g_i(x,t) on boundary segment i (Dirichlet, per segment)
    u = u0(x)    at t = 0

Coefficient fields kappa (diff), v (vel), s (source), BC data g, IC u0 and
the optional exact solution c_ex may each be a constant or a callable; the
callable convention is ``f(x)``, ``f(x, t)`` or ``f(x, t, mu)`` with
x: [N, d] spatial coordinates, t: [N] times (or None for steady problems)
and mu: [N, P] MOR parameter values, returning [N] (scalar fields) or
[N, d] (velocity).  Evaluation happens once on the host at setup; the
results become device-resident constants (SURVEY.md §3.1).
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence

import numpy as np


def _n_positional_params(f: Callable) -> int:
    sig = inspect.signature(f)
    n = 0
    for p in sig.parameters.values():
        if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD):
            n += 1
        elif p.kind == p.VAR_POSITIONAL:
            return 3
    return n


def eval_field(
    f: Any,
    x: np.ndarray,
    t: Optional[np.ndarray] = None,
    mu: Optional[np.ndarray] = None,
    vec_dim: Optional[int] = None,
) -> np.ndarray:
    """Evaluate a constant-or-callable coefficient field at points.

    x: [N, d]; t: [N] or None; mu: [N, P] or None.
    Returns [N] for scalar fields or [N, vec_dim] when ``vec_dim`` is given.
    """
    x = np.atleast_2d(np.asarray(x, dtype=np.float64))
    n = x.shape[0]
    if callable(f):
        nargs = _n_positional_params(f)
        args = [x]
        if nargs >= 2:
            args.append(t)
        if nargs >= 3:
            args.append(mu)
        out = np.asarray(f(*args), dtype=np.float64)
    else:
        out = np.asarray(f, dtype=np.float64)
    # Constant (size-1 / per-component) results materialize via np.full /
    # filled assignment: ascontiguousarray on a stride-0 broadcast copies
    # element-by-element (measured 9.4 s of a 15 s flagship assembly).
    if vec_dim is None:
        if out.size == 1:
            return np.full(n, float(np.squeeze(out)))
        out = np.broadcast_to(np.squeeze(out), (n,)) if out.ndim <= 1 else out.reshape(n)
        return np.ascontiguousarray(out, dtype=np.float64)
    if out.ndim <= 1 and out.size == vec_dim:
        res = np.empty((n, vec_dim), dtype=np.float64)
        res[:] = out.reshape(1, vec_dim)
        return res
    if out.shape != (n, vec_dim):
        out = out.reshape(n, vec_dim)
    return np.ascontiguousarray(out, dtype=np.float64)


@dataclass(frozen=True)
class MORVar:
    """Model-order-reduction (parametric) inputs (reference ``MORvar``).

    One network amortizes a family of PDEs: the trial net receives extra
    inputs mu and is trained over the cartesian pairing of training points
    with the rows of ``samples`` (SURVEY.md §0 item 1, §3.5).

    samples: [M, P] parameter values to train over.
    bounds:  optional [P, 2] lower/upper bounds used for input scaling.
    """

    samples: np.ndarray
    bounds: Optional[np.ndarray] = None

    def __post_init__(self):
        s = np.atleast_2d(np.asarray(self.samples, dtype=np.float64))
        object.__setattr__(self, "samples", s)
        if self.bounds is None:
            lo, hi = s.min(axis=0), s.max(axis=0)
            hi = np.where(hi > lo, hi, lo + 1.0)
            object.__setattr__(self, "bounds", np.stack([lo, hi], axis=-1))

    @property
    def n_params(self) -> int:
        return self.samples.shape[1]

    @property
    def n_samples(self) -> int:
        return self.samples.shape[0]


@dataclass(frozen=True)
class NeumannBC:
    """Flux (Neumann) boundary data for one segment (beyond-reference:
    the reference supports Dirichlet only — SURVEY.md §0 item 8).

    Enforced as a penalty on the normal diffusive flux at the segment's
    boundary points:

        kappa(x, t) * du/dn = flux(x, t)

    where n is the segment's outward unit normal (constant per segment on
    the supported domains).  ``flux`` follows the usual constant-or-
    callable convention.  The penalty shares the Dirichlet BC weight
    (w_bc) and needs only the network's FIRST derivatives — the same
    order the weak interior residual already uses.
    """

    flux: Any = 0.0

    @property
    def alpha(self):
        return 0.0


@dataclass(frozen=True)
class RobinBC:
    """Robin (mixed) boundary data for one segment (beyond-reference):

        alpha(x, t) * u + kappa(x, t) * du/dn = flux(x, t)

    the convective/radiation boundary family; ``alpha = 0`` degenerates
    to :class:`NeumannBC`.  Both coefficients follow the constant-or-
    callable convention; enforcement and weighting are identical to
    NeumannBC (rows in the same FluxData with a per-point alpha)."""

    alpha: Any = 1.0
    flux: Any = 0.0


@dataclass
class ADPDE:
    """Advection-diffusion PDE problem (reference ``ADPDE``).

    domain:     Domain1D / PolygonDomain2D / RectangleDomain2D
    diff:       kappa — scalar diffusivity field (constant or callable)
    vel:        velocity field (constant scalar/[d] or callable -> [N, d])
    source:     source field s (constant or callable); may be None when an
                inverse-source problem supplies it as a trainable function
    react:      reaction coefficient c(x, t) adding + c u to the PDE
                (advection-diffusion-REACTION; 0 = off — beyond-reference
                extension, trivially supported by the weak form)
    nl_adv:     CONSTANT vector b (scalar in 1-D) adding the nonlinear
                advection term u (b . grad u) to the PDE — viscous
                Burgers family (beyond-reference: the reference is
                strictly linear).  None = off.  The weak form needs no
                new derivatives (the term is u * directional-gradient,
                both already produced by the value+jacobian evaluators);
                nonlinear problems ride the fused value+jac kernel path
                rather than the fully-fused residual kernel.
    t_interval: (t0, T) for time-dependent problems, None for steady
    bcs:        per-boundary-segment data, list of length
                domain.n_boundary_segments; entries are constants or
                callables g(x, t) (Dirichlet), ``NeumannBC(flux)`` /
                ``RobinBC(alpha, flux)`` (normal-flux data
                alpha u + kappa du/dn = g — beyond-reference), or None
                (no BC on that segment).  A single scalar/callable is
                broadcast to every segment.  At least one segment must be
                Dirichlet: pure-Neumann problems are only determined up
                to a constant, and pure-Robin (though well-posed for
                alpha > 0) is rejected because the penalty-point set
                would carry no Dirichlet rows.
    ic:         initial condition u0(x) (time-dependent only)
    c_ex:       optional exact solution u(x, t) for error reporting
    mor:        optional MORVar for parametric training
    """

    domain: Any
    diff: Any
    vel: Any
    source: Any = 0.0
    react: Any = 0.0
    nl_adv: Any = None
    t_interval: Optional[Sequence[float]] = None
    bcs: Any = 0.0
    ic: Any = None
    c_ex: Any = None
    mor: Optional[MORVar] = None

    def __post_init__(self):
        nseg = self.domain.n_boundary_segments
        if not isinstance(self.bcs, (list, tuple)):
            self.bcs = [self.bcs] * nseg
        else:
            self.bcs = list(self.bcs)
        if len(self.bcs) != nseg:
            raise ValueError(
                f"bcs has {len(self.bcs)} entries; domain has {nseg} segments"
            )
        if not any(
            g is not None and not isinstance(g, (NeumannBC, RobinBC))
            for g in self.bcs
        ):
            raise ValueError(
                "at least one segment needs Dirichlet data (pure-Neumann "
                "problems are only determined up to a constant; pure-Robin "
                "is unsupported because the penalty-point set would carry "
                "no Dirichlet rows)"
            )
        if self.nl_adv is not None:
            b = np.atleast_1d(np.asarray(self.nl_adv, dtype=np.float64))
            if b.shape != (self.domain.dim,):
                raise ValueError(
                    f"nl_adv must be a constant length-{self.domain.dim} "
                    f"vector (scalar ok in 1-D); got shape {b.shape}"
                )
            self.nl_adv = None if not b.any() else b
        if self.t_interval is not None:
            t0, t1 = float(self.t_interval[0]), float(self.t_interval[1])
            if not t1 > t0:
                raise ValueError("t_interval must satisfy T > t0")
            self.t_interval = (t0, t1)
            if self.ic is None:
                raise ValueError("time-dependent problems require an IC")

    @property
    def time_dependent(self) -> bool:
        return self.t_interval is not None

    @property
    def dim(self) -> int:
        return self.domain.dim

    @property
    def n_inputs(self) -> int:
        """Trial-network input width: x (+ t) (+ mu)."""
        n = self.dim + (1 if self.time_dependent else 0)
        if self.mor is not None:
            n += self.mor.n_params
        return n

    # -- field evaluation helpers (host-side, setup time) ------------------

    def eval_diff(self, x, t=None, mu=None):
        return eval_field(self.diff, x, t, mu)

    def eval_vel(self, x, t=None, mu=None):
        return eval_field(self.vel, x, t, mu, vec_dim=self.dim)

    def eval_source(self, x, t=None, mu=None):
        if self.source is None:
            return np.zeros(np.atleast_2d(x).shape[0])
        return eval_field(self.source, x, t, mu)

    def eval_react(self, x, t=None, mu=None):
        if self.react is None:
            return np.zeros(np.atleast_2d(x).shape[0])
        return eval_field(self.react, x, t, mu)

    def eval_bc(self, seg: int, x, t=None, mu=None):
        g = self.bcs[seg]
        if g is None or isinstance(g, (NeumannBC, RobinBC)):
            return None
        return eval_field(g, x, t, mu)

    def eval_neumann(self, seg: int, x, t=None, mu=None):
        """Target flux g of a NeumannBC/RobinBC segment (None otherwise)."""
        g = self.bcs[seg]
        if not isinstance(g, (NeumannBC, RobinBC)):
            return None
        return eval_field(g.flux, x, t, mu)

    def eval_robin_alpha(self, seg: int, x, t=None, mu=None):
        """Robin u-coefficient alpha of a flux segment (zeros for pure
        Neumann, None for non-flux segments)."""
        g = self.bcs[seg]
        if not isinstance(g, (NeumannBC, RobinBC)):
            return None
        return eval_field(g.alpha, x, t, mu)

    def eval_ic(self, x, mu=None):
        return eval_field(self.ic, x, None, mu)

    def eval_exact(self, x, t=None, mu=None):
        if self.c_ex is None:
            return None
        return eval_field(self.c_ex, x, t, mu)
