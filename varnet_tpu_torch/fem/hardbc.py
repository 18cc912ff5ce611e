"""[Copy of ``varnet_tpu/fem/hardbc.py``, pure NumPy, so that the PyTorch port
imports no JAX; ``tests/test_torch_hardbc.py`` holds the two bit-equal.  Added
here: :func:`tables_to`, the tables as f32 tensors on a device;
:func:`hard_transform` takes tensors as well as arrays.]

Exact (hard-constraint) Dirichlet BC / IC imposition.

Beyond-reference capability (the reference enforces BC/IC only through
penalty terms — SURVEY.md §0 item 5): the trial solution is re-ansatzed as

    u(x, t) = G(x, t) + tau(t) * D(x) * N_theta(x, t)

where

  * ``D`` is an approximate-distance function (ADF) that vanishes exactly
    on every Dirichlet boundary segment and is positive inside the
    domain.  Per-segment affine inward distances are composed with the
    Rvachev R0 conjunction ``a ^ b = a + b - sqrt(a^2 + b^2)`` (which is
    zero iff either operand is, scales like min(a, b), and is smooth away
    from corners) — the standard R-function construction of the
    exact-imposition PINN literature (Sukumar & Srivastava 2022).
  * ``G`` extends the boundary/initial data into the domain:
    steady ``G = g~``; transient ``G(x,t) = g~(x,t) - g~(x,0) + u0(x)``,
    which equals u0 at t = t0 everywhere and equals g on the Dirichlet
    boundary whenever the data are compatible (u0 = g(., t0) on the
    boundary — checked at construction, warned otherwise).  ``g~`` is the
    inverse-distance-weighted blend of the per-segment Dirichlet fields
    (exactly g_e on segment e; the compatible-corner limit is handled by
    an epsilon-regularized product formulation).
  * ``tau(t) = (t - t0) / (T - t0)`` vanishes at the initial time
    (steady: tau = 1).

The BC and IC penalty rows then drop out of the loss entirely — no
weight tuning, no boundary-vs-interior balance — and only the interior
weak residual trains the network.

TPU-first design: ``D``/``G`` involve user callables (NumPy, untraceable),
so everything the device needs is PRECOMPUTED host-side in f64 at the
fixed quadrature/observation points as six tables

    A  = G            dA = grad_x G          At = dG/dt
    B  = tau * D      dB = tau * grad_x D    Bt = D / (T - t0)

after which the transformed fields are elementwise combinations of the
network outputs the (possibly Pallas-fused) value+jacobian evaluator
already produces:

    u      = A  + B * n
    grad u = dA + dB * n + B * grad n
    du/dt  = At + Bt * n + B * dn/dt

(:func:`hard_transform`).  This is exactly the framework's fixed-data
philosophy (SURVEY.md §2.1 #1): one assembly-time host pass, zero extra
device work beyond a handful of fused multiply-adds.  Gradients of D and
G are taken by f64 central differences (h = 1e-6 of the domain extent;
truncation ~1e-12 relative — far below the f32 training floor), keeping
the construction uniform across arbitrary user data fields.
"""

from __future__ import annotations

import warnings
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

__all__ = ["HardBC", "HardQuad", "HardPts", "hard_transform", "tables_to"]

# Epsilon for the IDW corner regularization, relative to the normalized
# (O(1)) per-segment distances.
_IDW_EPS = 1e-12


class HardQuad(NamedTuple):
    """Fixed transform tables at interior quadrature points.

    Shapes mirror the quad coords' leading axes ([K, nQ] scalars,
    [K, nQ, d] gradients); ``At``/``Bt`` are None for steady problems.
    """

    A: np.ndarray
    B: np.ndarray
    dA: np.ndarray
    dB: np.ndarray
    At: Optional[np.ndarray]
    Bt: Optional[np.ndarray]


class HardPts(NamedTuple):
    """Value-only transform tables at penalty/observation points [N]."""

    A: np.ndarray
    B: np.ndarray


def hard_transform(u, grad_u, u_t, hq):
    """Apply the ansatz to network outputs (torch tensors or NumPy arrays).

    u [k, nq], grad_u [k, nq, d], u_t [k, nq] or None; ``hq`` tables
    broadcast-compatible (same shapes).  Returns the transformed triple.
    """
    u_new = hq.A + hq.B * u
    grad_new = hq.dA + hq.dB * u[..., None] + hq.B[..., None] * grad_u
    ut_new = None
    if u_t is not None:
        ut_new = hq.At + hq.Bt * u + hq.B * u_t
    return u_new, grad_new, ut_new


def tables_to(hq, device=None, dtype=None):
    """A HardQuad / HardPts of host arrays as tensors of ``dtype`` (default
    f32) on ``device`` (cast on the host, as the JAX package casts before
    device placement; None fields stay None)."""
    import torch

    np_dtype = np.float32 if dtype is None else torch.empty(0, dtype=dtype).numpy().dtype
    return type(hq)(*(None if a is None
                      else torch.from_numpy(np.array(a, dtype=np_dtype)).to(device)
                      for a in hq))


def _trimmed_segment_adf(x2: np.ndarray, endpoints: np.ndarray) -> np.ndarray:
    """Rvachev-trimmed 2-D segment ADFs, [P, E] (unnormalized): zero
    exactly on each finite edge, positive elsewhere, ~distance near it.
    ``x2`` [P, 2], ``endpoints`` [E, 2, 2].  Shared by the non-convex
    polygon path and the prism wall path (where it is evaluated on the
    xy footprint: the edge's zero set extrudes to exactly the wall)."""
    a = endpoints[:, 0]                                   # [E, 2]
    b = endpoints[:, 1]
    c = 0.5 * (a + b)
    e = b - a
    ln = np.linalg.norm(e, axis=-1)                       # [E]
    rel = x2[:, None, :] - a[None, :, :]                  # [P, E, 2]
    # unsigned distance to the edge LINE
    f = np.abs(rel[..., 0] * e[None, :, 1]
               - rel[..., 1] * e[None, :, 0]) / ln        # [P, E]
    # trimming field: positive inside the edge's slab, ~ -distance^2/L
    # beyond its endpoints
    d2 = np.sum((x2[:, None, :] - c[None, :, :]) ** 2, axis=-1)
    t = (0.25 * ln**2 - d2) / ln                          # [P, E]
    # trimmed ADF: equals f on the slab midline, vanishes exactly on the
    # segment only, first-order normalized
    return np.sqrt(f**2 + 0.25 * (np.sqrt(t**2 + f**4) - t) ** 2)


def _r0_fold(phis: np.ndarray) -> np.ndarray:
    """Rvachev R0 conjunction over the last axis: zero iff any phi is."""
    d = phis[..., 0]
    for e in range(1, phis.shape[-1]):
        p = phis[..., e]
        d = d + p - np.sqrt(d * d + p * p)
    return d


class HardBC:
    """Builder of the exact-imposition transform for an assembled ADPDE.

    Supported domains: ``Domain1D``, ``RectangleDomain2D``,
    ``PolygonDomain2D`` (convex via signed plane distances; NON-convex via
    trimmed segment ADFs, so the L-shape works), ``BoxDomainND``/
    ``BoxDomain3D``, and ``PrismDomain3D`` (wall ADFs = the polygon's
    trimmed segment ADFs on the xy footprint — an edge's 2-D zero set
    extrudes to exactly its wall — composed with cap plane distances, so
    non-convex 3-D cross-sections work too).  Supported BCs:
    Dirichlet data per segment (constants or callables defined on the
    whole domain — the blend evaluates them off their segment), plus
    ``None`` (free) segments and Neumann/Robin flux segments — the flux
    conditions are penalty-shaped, not ansatz-shaped, so they stay
    penalty rows evaluated on the TRANSFORMED solution while the
    Dirichlet data and IC are exact.  MOR (parametric) problems compose:
    the ADF ``D`` is geometry-only (mu-free), and mu-dependent boundary/
    initial data flow through ``G`` — the quad coords arrive already
    cartesian-paired with the mu samples (fem/assembly.py), so the
    tables tile per sample by construction and the BC/IC stay exact for
    EVERY mu.
    """

    def __init__(self, pde):
        from ..problems.adpde import NeumannBC, RobinBC

        self.pde = pde
        self.n_mor = 0 if pde.mor is None else pde.mor.n_params
        self.td = pde.time_dependent
        if self.td:
            self.t0, self.t1 = pde.t_interval
        self.n_space = pde.dim
        lo, hi = pde.domain.bounds
        self._diam = float(np.linalg.norm(np.asarray(hi) - np.asarray(lo)))
        self._fd_h = 1e-6 * max(self._diam, 1.0)
        # Dirichlet segments only: free (None) and flux (Neumann/Robin)
        # segments carry no phi — the ansatz leaves them unconstrained
        # (flux conditions stay penalty rows, on the TRANSFORMED fields).
        self.dir_segs = [
            i for i, g in enumerate(pde.bcs)
            if g is not None and not isinstance(g, (NeumannBC, RobinBC))
        ]
        if not self.dir_segs:  # ADPDE.__post_init__ already guarantees >= 1
            raise ValueError("hard_bc needs at least one Dirichlet segment")
        from ..geometry.domain import PrismDomain3D

        self._endpoints = None  # non-convex polygon: trimmed segment ADFs
        self._prism = None      # extruded polygon: wall ADFs x cap planes
        if isinstance(pde.domain, PrismDomain3D):
            dom = pde.domain
            nv = dom.poly.n_boundary_segments
            edges = dom.poly.segment_endpoints()  # outer + hole walls
            # dir_segs is ascending, and walls (< nv) precede caps, so the
            # wall-then-cap column layout below matches the dir_segs order
            # gtilde() zips against.
            wall_segs = [i for i in self.dir_segs if i < nv]
            self._prism = {
                "edges": (edges[wall_segs] if wall_segs
                          else np.zeros((0, 2, 2))),
                "caps": [s - nv for s in self.dir_segs if s >= nv],
                "z": (dom.z_lo, dom.z_hi),
            }
        else:
            anchors, normals = self._segment_planes(pde.domain)
            if anchors is None:
                from ..geometry.domain import PolygonDomain2D

                assert isinstance(pde.domain, PolygonDomain2D)
                # outer + hole edges, in segment order
                self._endpoints = (
                    pde.domain.segment_endpoints()[self.dir_segs]
                )  # [E, 2, 2]
            else:
                self._anchors = np.stack(
                    [anchors[i] for i in self.dir_segs])   # [E, d]
                self._normals = np.stack(
                    [normals[i] for i in self.dir_segs])   # [E, d]
        # Single-field fast path: every Dirichlet segment shares one data
        # object (the common broadcast-constant case) — skip the blend.
        gs = [pde.bcs[i] for i in self.dir_segs]
        self._single_g = all(g is gs[0] for g in gs) or all(
            np.isscalar(g) and np.isscalar(gs[0]) and float(g) == float(gs[0])
            for g in gs
        )
        if self.td:
            self._warn_if_incompatible()

    # -- geometry ------------------------------------------------------- #

    @staticmethod
    def _segment_planes(domain):
        """Per-segment (anchor point, outward unit normal) pairs; the
        inward distance of segment i is -(x - a_i) . n_i.  Returns
        ``(None, None)`` for NON-CONVEX polygons — there an edge line's
        extension cuts through the interior, so the builder switches to
        trimmed segment ADFs (:meth:`_phis`)."""
        from ..geometry.domain import (
            BoxDomainND,
            Domain1D,
            PolygonDomain2D,
            RectangleDomain2D,
        )

        if isinstance(domain, Domain1D):
            return (
                [np.array([domain.lo]), np.array([domain.hi])],
                [np.array([-1.0]), np.array([1.0])],
            )
        if isinstance(domain, BoxDomainND):
            anchors, normals = [], []
            for j in range(domain.dim):
                for side, val in ((0, domain.lo[j]), (1, domain.hi[j])):
                    a = np.array(domain.lo, dtype=np.float64)
                    a[j] = val
                    anchors.append(a)
                    normals.append(domain.segment_normal(2 * j + side))
            return anchors, normals
        if isinstance(domain, PolygonDomain2D):
            if getattr(domain, "holes", None):
                return None, None  # hole edges: trimmed segment ADFs
            if not isinstance(domain, RectangleDomain2D) and not (
                HardBC._is_convex(domain.vertices)
            ):
                return None, None  # trimmed segment ADFs
            v = domain.vertices
            anchors = [v[i] for i in range(v.shape[0])]
            normals = [domain.segment_normal(i) for i in range(v.shape[0])]
            return anchors, normals
        raise ValueError(
            f"hard_bc: unsupported domain type {type(domain).__name__} "
            "(Domain1D / PolygonDomain2D / BoxDomainND / PrismDomain3D)"
        )

    @staticmethod
    def _is_convex(vertices: np.ndarray) -> bool:
        v = np.asarray(vertices, dtype=np.float64)
        e = np.roll(v, -1, axis=0) - v
        cross = e[:, 0] * np.roll(e[:, 1], -1) - e[:, 1] * np.roll(e[:, 0], -1)
        scale = np.abs(cross).max() + 1e-300
        signs = cross / scale
        return not ((signs > 1e-12).any() and (signs < -1e-12).any())

    def _phis(self, x: np.ndarray) -> np.ndarray:
        """Normalized distances to each Dirichlet segment, [P, E]:
        signed plane distances (positive inside) on plane-based domains;
        trimmed SEGMENT ADFs (Rvachev trimming — zero exactly on the
        finite edge, positive elsewhere, ~distance near it) on non-convex
        polygons, where an extended edge line would wrongly zero the ADF
        at interior points."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        if self._prism is not None:
            cols = []
            if self._prism["edges"].shape[0]:
                cols.append(
                    _trimmed_segment_adf(x[:, :2], self._prism["edges"]))
            z_lo, z_hi = self._prism["z"]
            for cap in self._prism["caps"]:
                d = (x[:, 2] - z_lo) if cap == 0 else (z_hi - x[:, 2])
                cols.append(d[:, None])
            return np.concatenate(cols, axis=1) / self._diam
        if self._endpoints is None:
            rel = x[:, None, :] - self._anchors[None, :, :]   # [P, E, d]
            return -np.einsum("ped,ed->pe", rel, self._normals) / self._diam
        return _trimmed_segment_adf(x, self._endpoints) / self._diam

    def dist(self, x: np.ndarray) -> np.ndarray:
        """ADF D(x): zero exactly on every Dirichlet segment, ~min
        normalized segment distance inside."""
        return _r0_fold(self._phis(x))

    # -- boundary-data extension ---------------------------------------- #

    def gtilde(self, x: np.ndarray, t: Optional[np.ndarray],
               mu: Optional[np.ndarray] = None) -> np.ndarray:
        """Inverse-distance blend of the per-segment Dirichlet fields:
        equals g_e exactly on segment e; smooth inside."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        if self._single_g:
            return self.pde.eval_bc(self.dir_segs[0], x, t, mu)
        # First-power inverse-distance weights: on an interval the blend
        # degenerates to LINEAR interpolation of the endpoint data — the
        # tamest extension the network has to correct.  (epsilon keeps
        # corners finite; compatible data make the corner limit exact.)
        phi1 = np.maximum(self._phis(x), 0.0) + _IDW_EPS        # [P, E]
        # w_e = prod_{j != e} phi1_j: total product / own factor, in log
        # space for robustness.
        logs = np.log(phi1)
        L = logs.sum(axis=1, keepdims=True) - logs              # [P, E]
        # logsumexp-style shift: without it the product of E normalized
        # distances underflows exp() to an all-zero row (0/0 NaN weights)
        # for boundaries with many segments; the shift cancels in the
        # normalization exactly.
        w = np.exp(L - L.max(axis=1, keepdims=True))
        w = w / w.sum(axis=1, keepdims=True)
        out = np.zeros(x.shape[0], dtype=np.float64)
        for col, seg in enumerate(self.dir_segs):
            out += w[:, col] * self.pde.eval_bc(seg, x, t, mu)
        return out

    def _G(self, x: np.ndarray, t: Optional[np.ndarray],
           mu: Optional[np.ndarray] = None) -> np.ndarray:
        if not self.td:
            return self.gtilde(x, None, mu)
        t = np.asarray(t, dtype=np.float64)
        t0 = np.full_like(t, self.t0)
        return (self.gtilde(x, t, mu) - self.gtilde(x, t0, mu)
                + self.pde.eval_ic(x, mu))

    def _warn_if_incompatible(self) -> None:
        """BC/IC compatibility: on the Dirichlet boundary, G(x, t) equals
        g(x, t) only when u0 = g(., t0) there."""
        worst = 0.0
        scale = 1e-30
        mu_rows = ([None] if self.n_mor == 0 else list(self.pde.mor.samples))
        for seg in self.dir_segs:
            pts = self.pde.domain.boundary_points(4)[seg]
            t0 = np.full(pts.shape[0], self.t0)
            for row in mu_rows:
                mu = (None if row is None else
                      np.broadcast_to(row[None, :],
                                      (pts.shape[0], self.n_mor)))
                g0 = self.pde.eval_bc(seg, pts, t0, mu)
                u0 = self.pde.eval_ic(pts, mu)
                worst = max(worst, float(np.abs(g0 - u0).max()))
                scale = max(scale, float(np.abs(g0).max()),
                            float(np.abs(u0).max()), 1.0)
        if worst > 1e-6 * scale:
            warnings.warn(
                f"hard_bc: initial and boundary data are incompatible "
                f"(max |g(x, t0) - u0(x)| = {worst:.2e} on the Dirichlet "
                "boundary); the ansatz reproduces the IC exactly but the "
                "BC only up to that mismatch",
                stacklevel=3,
            )

    # -- tables ---------------------------------------------------------- #

    def _split(self, coords: np.ndarray):
        """[..., n_in] -> (x [P, d], t [P] or None, mu [P, P_mor] or
        None, lead shape).  MOR coords carry mu appended after (x, t) —
        exactly the network-input layout of fem/assembly.py."""
        coords = np.asarray(coords, dtype=np.float64)
        lead = coords.shape[:-1]
        flat = coords.reshape(-1, coords.shape[-1])
        x = flat[:, : self.n_space]
        t = flat[:, self.n_space] if self.td else None
        off = self.n_space + (1 if self.td else 0)
        mu = flat[:, off : off + self.n_mor] if self.n_mor else None
        return x, t, mu, lead

    def value_AB(self, coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(A, B) value tables at arbitrary points (evaluation path)."""
        x, t, mu, lead = self._split(coords)
        A = self._G(x, t, mu)
        B = self.dist(x)
        if self.td:
            B = B * (t - self.t0) / (self.t1 - self.t0)
        return A.reshape(lead), B.reshape(lead)

    def tables(self, coords: np.ndarray) -> HardQuad:
        """Full (A, B, dA, dB, At, Bt) tables at quadrature-like points.

        Spatial/temporal gradients by f64 central differences.  Quad
        points are strictly interior (Gauss points sit >= ~0.2 h from the
        boundary) so probes stay inside; flux-penalty coords sit ON the
        boundary, where a +/-h probe can leave the domain and a user data
        callable may be undefined (NaN) there — those points fall back to
        the finite one-sided difference (D is pure geometry and is
        defined everywhere, so only the data extension G needs the
        guard).
        """

        def _fd(fp, fm, f0, step):
            """Central difference with a one-sided fallback where a
            probe returned non-finite values."""
            out = (fp - fm) / (2 * step)
            bad = ~np.isfinite(out)
            if bad.any():
                fwd = (fp[bad] - f0[bad]) / step
                out[bad] = np.where(np.isfinite(fwd), fwd,
                                    (f0[bad] - fm[bad]) / step)
            return out

        x, t, mu, lead = self._split(coords)
        d, h = self.n_space, self._fd_h
        D = self.dist(x)
        G = self._G(x, t, mu)
        dD = np.empty((x.shape[0], d))
        dG = np.empty((x.shape[0], d))
        for j in range(d):
            xp = x.copy()
            xp[:, j] += h
            xm = x.copy()
            xm[:, j] -= h
            dD[:, j] = (self.dist(xp) - self.dist(xm)) / (2 * h)
            dG[:, j] = _fd(self._G(xp, t, mu), self._G(xm, t, mu), G, h)
        if self.td:
            tau = (t - self.t0) / (self.t1 - self.t0)
            ht = 1e-6 * (self.t1 - self.t0)
            Gt = _fd(self._G(x, t + ht, mu), self._G(x, t - ht, mu), G, ht)
            return HardQuad(
                A=G.reshape(lead),
                B=(tau * D).reshape(lead),
                dA=dG.reshape(lead + (d,)),
                dB=(tau[:, None] * dD).reshape(lead + (d,)),
                At=Gt.reshape(lead),
                Bt=(D / (self.t1 - self.t0)).reshape(lead),
            )
        return HardQuad(
            A=G.reshape(lead), B=D.reshape(lead),
            dA=dG.reshape(lead + (d,)), dB=dD.reshape(lead + (d,)),
            At=None, Bt=None,
        )

    def points(self, coords: np.ndarray) -> HardPts:
        """Value-only (A, B) tables for penalty/observation point sets."""
        A, B = self.value_AB(coords)
        return HardPts(A=A, B=B)
