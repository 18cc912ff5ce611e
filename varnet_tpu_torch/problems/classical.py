"""Classical (finite-difference) reference solvers for cross-validation.

A verbatim copy of ``varnet_tpu/problems/classical.py`` (host NumPy/SciPy;
the port imports nothing of the JAX package), held bit-equal to it by
``tests/test_torch_classical.py``.

The reference validated its 2-D contaminant-transport case against FEM
(COMSOL) data shipped with the repo (SURVEY.md §4 item 2); that data is not
available here, so this module provides the independent classical solver:
a conservative finite-difference discretization of

    u_t + v(x) . grad(u) - div(kappa grad u) + c u = s(x, t)

on a RECTANGLE — optionally with axis-aligned rectangular HOLES (internal
Dirichlet obstacle boundaries: every node inside or on a hole becomes a
Dirichlet row carrying the nearest hole edge's data; align the grid with
the hole edges for second order) — integrated with the theta-scheme
(Crank-Nicolson by default).  Host-side NumPy/SciPy — this is validation tooling, not a
training path.  Second-order central differences for both advection and
diffusion (flux form with midpoint kappa); per-segment boundary handling
mirrors ``ADPDE.bcs``: Dirichlet rows for constrained segments, zero-
normal-gradient (ghost reflection + one-sided advection) for ``None``
(free outflow) segments, and GENERAL flux data for ``NeumannBC(g)``
segments — the reflected ghost value gains the standard correction
``u_ghost = u_refl + 2 h g / kappa_face`` (kappa du/dn = g), which lands
in the right-hand side as a boundary source ``2 g(x, t) / h`` on the
segment's nodes, theta-weighted in time like the volumetric source.

Accuracy: O(h^2 + dt^2) on smooth solutions, verified against the analytic
2-D transient AD configuration in tests/test_classical.py — the same
"validate the validator" step the reference's COMSOL comparison implies.
Central advection requires cell Peclet |v| h / kappa < 2; the solver checks
and warns otherwise.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ..geometry.domain import RectangleDomain2D


def solve_ad_fdm_2d(
    pde,
    nx: int = 128,
    ny: int = 64,
    nt: int = 200,
    theta: float = 0.5,
    sample_times: Optional[Sequence[float]] = None,
    verbose: bool = False,
) -> Dict[str, np.ndarray]:
    """Solve a time-dependent ADPDE on a rectangle by theta-scheme FDM.

    pde:   ADPDE with a RectangleDomain2D, time-dependent, with
           time-INDEPENDENT diff/vel/react fields (the operator is
           factorized once; the source and Dirichlet data may depend on t).
    nx/ny: elements per dimension (nx+1 x ny+1 nodes including boundary)
    nt:    time steps
    theta: 0.5 = Crank-Nicolson (default), 1.0 = implicit Euler
    sample_times: times at which to store the field (default: 8 uniform)

    Returns dict with ``x`` [N, 2] node coordinates, ``times`` [S], and
    ``u`` [S, N] solution snapshots (S sample times).
    """
    if not isinstance(pde.domain, RectangleDomain2D):
        raise ValueError("solve_ad_fdm_2d requires a RectangleDomain2D")
    if not pde.time_dependent:
        raise ValueError("pde must be time-dependent")
    lo, hi = pde.domain.bounds
    t0, t1 = pde.t_interval
    nxn, nyn = nx + 1, ny + 1
    hx = (hi[0] - lo[0]) / nx
    hy = (hi[1] - lo[1]) / ny
    xs = np.linspace(lo[0], hi[0], nxn)
    ys = np.linspace(lo[1], hi[1], nyn)
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    nodes = np.stack([xx.ravel(), yy.ravel()], axis=-1)  # [N, 2], x-major
    n = nodes.shape[0]

    def idx(i, j):
        return i * nyn + j

    tz = np.zeros(n)
    kappa = pde.eval_diff(nodes, tz)          # [N]
    vel = pde.eval_vel(nodes, tz)             # [N, 2]
    react = pde.eval_react(nodes, tz)         # [N]

    # Cell-Peclet sanity for central advection (always warn: a silent
    # violation would pollute downstream cross-validation numbers).
    pe = np.max(np.abs(vel[:, 0])) * hx / max(kappa.min(), 1e-300)
    pe = max(pe, np.max(np.abs(vel[:, 1])) * hy / max(kappa.min(), 1e-300))
    if pe >= 2.0:
        print(f"[classical] WARNING cell Peclet {pe:.2f} >= 2; refine the grid")

    # Midpoint kappa for the conservative diffusion stencil, precomputed
    # vectorized for every node (clipped to the domain at the boundary).
    def _mid(dx, dy):
        pts = nodes + np.array([dx, dy])
        pts[:, 0] = np.clip(pts[:, 0], lo[0], hi[0])
        pts[:, 1] = np.clip(pts[:, 1], lo[1], hi[1])
        return pde.eval_diff(pts, np.zeros(n))

    kxp_all = _mid(hx / 2, 0.0)
    kxm_all = _mid(-hx / 2, 0.0)
    kyp_all = _mid(0.0, hy / 2)
    kym_all = _mid(0.0, -hy / 2)

    # ---- boundary classification (per-segment, reference bcs order:
    # bottom, right, top, left for RectangleDomain2D) --------------------
    # A node is Dirichlet if it lies on ANY constrained segment (corners
    # shared with a free segment stay constrained — continuity of g).
    dirichlet_seg = -np.ones(n, dtype=np.int64)  # segment supplying g
    neumann_dir = np.zeros((n, 2), dtype=np.int64)  # outward normal (int)
    edge_nodes = {
        0: ([idx(i, 0) for i in range(nxn)], (0, -1)),        # bottom
        1: ([idx(nx, j) for j in range(nyn)], (1, 0)),        # right
        2: ([idx(i, ny) for i in range(nxn)], (0, 1)),        # top
        3: ([idx(0, j) for j in range(nyn)], (-1, 0)),        # left
    }
    from .adpde import NeumannBC, RobinBC

    for seg, (nodes_i, normal) in edge_nodes.items():
        if pde.bcs[seg] is None or isinstance(pde.bcs[seg],
                                              (NeumannBC, RobinBC)):
            # free AND flux edges share the ghost-reflected stencil; a
            # NeumannBC edge additionally gets the 2 g / h RHS source
            for k in nodes_i:
                if dirichlet_seg[k] < 0:
                    neumann_dir[k] = normal
        else:
            for k in nodes_i:
                dirichlet_seg[k] = seg
            # A Dirichlet edge overrides a free corner set earlier.
            for k in nodes_i:
                neumann_dir[k] = 0

    # ---- holes (internal obstacle boundaries) --------------------------
    # Every node inside or on an axis-aligned rectangular hole becomes a
    # Dirichlet row carrying the nearest hole edge's data: rows adjacent
    # to the obstacle then couple to exact boundary values, and the
    # decoupled interior-of-hole rows are cosmetic.  Align the grid with
    # the hole edges (hole coords on grid lines) to keep second order.
    holes = list(getattr(pde.domain, "holes", []) or [])
    seg_off = 4
    eps_h = 1e-9 * max(hi[0] - lo[0], hi[1] - lo[1])
    for hv in holes:
        hlo, hhi = hv.min(axis=0), hv.max(axis=0)
        if hv.shape[0] != 4 or not (
            np.allclose(np.sort(np.unique(np.round(hv[:, 0], 12))),
                        np.round([hlo[0], hhi[0]], 12))
            and np.allclose(np.sort(np.unique(np.round(hv[:, 1], 12))),
                            np.round([hlo[1], hhi[1]], 12))
        ):
            raise ValueError(
                "solve_ad_fdm_2d supports axis-aligned rectangular holes "
                "only (the variational path handles arbitrary polygons)"
            )
        for li in range(hv.shape[0]):
            bc = pde.bcs[seg_off + li]
            if bc is None or isinstance(bc, (NeumannBC, RobinBC)):
                # eval_bc would return None and numpy would coerce it to
                # NaN, silently flooding the whole CN solve — fail fast.
                raise ValueError(
                    f"solve_ad_fdm_2d: hole edge (segment {seg_off + li}) "
                    "must carry Dirichlet data (free/Neumann/Robin hole "
                    "edges are not supported by the FDM cross-validator)"
                )
        inside = np.all((nodes >= hlo - eps_h) & (nodes <= hhi + eps_h),
                        axis=1)
        ks = np.where(inside)[0]
        if not ks.size:
            # Silently ignoring the hole would score callers against a
            # hole-FREE reference field.
            raise ValueError(
                "solve_ad_fdm_2d: a hole contains no grid node — refine "
                "nx/ny or align the grid with the hole edges "
                f"(hole bbox {hlo.tolist()}..{hhi.tolist()}, h=({hx}, {hy}))"
            )
        edges = [(hv[i], hv[(i + 1) % 4]) for i in range(4)]
        for k in ks:
            # nearest hole edge supplies the Dirichlet data
            best, best_d = seg_off, np.inf
            for li, (a, b) in enumerate(edges):
                e = b - a
                tpar = np.clip(np.dot(nodes[k] - a, e) / np.dot(e, e), 0, 1)
                d = np.linalg.norm(nodes[k] - (a + tpar * e))
                if d < best_d:
                    best, best_d = seg_off + li, d
            dirichlet_seg[k] = best
            neumann_dir[k] = 0
        seg_off += hv.shape[0]
    is_dir = dirichlet_seg >= 0

    # Per-segment flux-source assembly for NeumannBC edges: node lists and
    # the 2 / h_axis factor (corners shared between two flux edges sum).
    flux_segs = []
    robin_diag = np.zeros(n)
    for seg, (nodes_i, normal) in edge_nodes.items():
        if isinstance(pde.bcs[seg], (NeumannBC, RobinBC)):
            free_nodes = np.array(
                [k for k in nodes_i if dirichlet_seg[k] < 0], dtype=np.int64
            )
            h_axis = hx if normal[0] != 0 else hy
            flux_segs.append((seg, free_nodes, 2.0 / h_axis))
            if free_nodes.size:
                # Robin: the ghost value u_g = u_refl + 2h(g - a u)/kappa
                # contributes -2a/h on the diagonal (a = 0 for Neumann);
                # a must be time-independent like the other operator
                # fields — the variational path honors alpha(x, t), so a
                # time-varying alpha would silently diverge here.
                a_t0 = pde.eval_robin_alpha(
                    seg, nodes[free_nodes], np.full(free_nodes.size, t0)
                )
                a_t1 = pde.eval_robin_alpha(
                    seg, nodes[free_nodes], np.full(free_nodes.size, t1)
                )
                if not np.allclose(a_t0, a_t1):
                    raise ValueError(
                        f"segment {seg}: Robin alpha varies in time; "
                        "solve_ad_fdm_2d factorizes the operator once and "
                        "requires time-independent alpha (like diff/vel/"
                        "react)"
                    )
                robin_diag[free_nodes] += -(2.0 / h_axis) * a_t0

    def flux_source(t):
        """[N] boundary-source vector from NeumannBC segments at time t."""
        fs = np.zeros(n)
        for seg, free_nodes, fac in flux_segs:
            if free_nodes.size:
                g = pde.eval_neumann(
                    seg, nodes[free_nodes], np.full(free_nodes.size, t)
                )
                fs[free_nodes] += fac * g
        return fs

    # ---- spatial operator A: du/dt = A u + s ---------------------------
    rows, cols, vals = [], [], []

    def add(r, c, v):
        rows.append(r)
        cols.append(c)
        vals.append(v)

    for i in range(nxn):
        for j in range(nyn):
            k = idx(i, j)
            if is_dir[k]:
                continue  # Dirichlet row handled via identity later
            ndir = neumann_dir[k]
            # neighbor indices with ghost reflection on free boundaries
            im = i - 1 if i > 0 else i + 1
            ip = i + 1 if i < nx else i - 1
            jm = j - 1 if j > 0 else j + 1
            jp = j + 1 if j < ny else j - 1
            # diffusion: flux form with midpoint kappa (reflected ghost for
            # free boundaries => zero normal diffusive flux)
            kxp, kxm = kxp_all[k], kxm_all[k]
            kyp, kym = kyp_all[k], kym_all[k]
            add(k, idx(ip, j), kxp / hx**2)
            add(k, idx(im, j), kxm / hx**2)
            add(k, k, -(kxp + kxm) / hx**2)
            add(k, idx(i, jp), kyp / hy**2)
            add(k, idx(i, jm), kym / hy**2)
            add(k, k, -(kyp + kym) / hy**2)
            # advection: central in the interior, one-sided (into the
            # domain) on free boundaries
            vx, vy = vel[k]
            if ndir[0] == 0 and 0 < i < nx:
                add(k, idx(i + 1, j), -vx / (2 * hx))
                add(k, idx(i - 1, j), vx / (2 * hx))
            elif i == nx:  # free right edge: backward difference
                add(k, k, -vx / hx)
                add(k, idx(i - 1, j), vx / hx)
            elif i == 0:   # free left edge: forward difference
                add(k, k, vx / hx)
                add(k, idx(i + 1, j), -vx / hx)
            else:
                add(k, idx(i + 1, j), -vx / (2 * hx))
                add(k, idx(i - 1, j), vx / (2 * hx))
            if ndir[1] == 0 and 0 < j < ny:
                add(k, idx(i, j + 1), -vy / (2 * hy))
                add(k, idx(i, j - 1), vy / (2 * hy))
            elif j == ny:
                add(k, k, -vy / hy)
                add(k, idx(i, j - 1), vy / hy)
            elif j == 0:
                add(k, k, vy / hy)
                add(k, idx(i, j + 1), -vy / hy)
            else:
                add(k, idx(i, j + 1), -vy / (2 * hy))
                add(k, idx(i, j - 1), vy / (2 * hy))
            # reaction
            if react[k] != 0.0:
                add(k, k, -react[k])

    a_mat = sp.csr_matrix(
        (vals, (rows, cols)), shape=(n, n), dtype=np.float64
    )
    if np.any(robin_diag):
        a_mat = (a_mat + sp.diags(robin_diag)).tocsr()

    dt = (t1 - t0) / nt
    eye = sp.identity(n, format="csr")
    lhs = (eye - theta * dt * a_mat).tolil()
    rhs_op = (eye + (1.0 - theta) * dt * a_mat).tocsr()
    # Dirichlet rows: identity in LHS (value set directly in the RHS).
    dir_idx = np.where(is_dir)[0]
    for k in dir_idx:
        lhs.rows[k] = [k]
        lhs.data[k] = [1.0]
    lu = spla.splu(lhs.tocsc())

    def dirichlet_values(t):
        g = np.zeros(len(dir_idx))
        tcol = np.full(len(dir_idx), t)
        pts = nodes[dir_idx]
        for seg in np.unique(dirichlet_seg[dir_idx]):
            m = dirichlet_seg[dir_idx] == seg
            g[m] = pde.eval_bc(int(seg), pts[m], tcol[m])
        return g

    def source_at(t):
        return pde.eval_source(nodes, np.full(n, t))

    u = pde.eval_ic(nodes).astype(np.float64)
    u[dir_idx] = dirichlet_values(t0)

    if sample_times is None:
        sample_times = np.linspace(t0, t1, 8)
    sample_times = np.asarray(sample_times, dtype=np.float64)
    snaps = np.zeros((len(sample_times), n))
    taken = np.zeros(len(sample_times), dtype=bool)

    def take(t_prev, t_now, u_prev, u_now):
        """Linear interpolation between bracketing steps (keeps snapshot
        timing error at O(dt^2), matching the scheme's order)."""
        for s, ts in enumerate(sample_times):
            if not taken[s] and t_prev - 1e-12 <= ts <= t_now + 1e-12:
                if t_now > t_prev:
                    a = (ts - t_prev) / (t_now - t_prev)
                else:
                    a = 0.0
                snaps[s] = (1 - a) * u_prev + a * u_now
                taken[s] = True

    take(t0, t0, u, u)
    s_prev = source_at(t0) + flux_source(t0)
    free_mask = (~is_dir).astype(np.float64)
    for step in range(1, nt + 1):
        t_old = t0 + (step - 1) * dt
        t_new = t0 + step * dt
        s_new = source_at(t_new) + flux_source(t_new)
        b = rhs_op @ u + dt * (theta * s_new + (1 - theta) * s_prev)
        b = b * free_mask  # zero the Dirichlet rows ...
        g_new = dirichlet_values(t_new)
        b[dir_idx] = g_new  # ... then set g(t^{n+1})
        u_old = u
        u = lu.solve(b)
        s_prev = s_new
        take(t_old, t_new, u_old, u)
        if verbose and step % max(nt // 10, 1) == 0:
            print(f"[classical] t={t_new:.3f}  max|u|={np.abs(u).max():.4f}")

    return {"x": nodes, "times": sample_times, "u": snaps,
            "shape": (nxn, nyn), "hx": hx, "hy": hy}
