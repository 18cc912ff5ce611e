"""[Copy of ``varnet_tpu/fem/assembly.py``, pure NumPy, so that the PyTorch port
imports no JAX; ``tests/test_torch_host.py`` holds the two bit-equal.]

Fixed-data assembly: from problem + discretization to device constants.

TPU-native re-implementation of the reference trainer's setup path
(reference: ``VarNet.py`` fixed-data construction — SURVEY.md §2.1 #1 and
§3.1): for every hat test function v_k it precomputes the quadrature-point
coordinates over supp(v_k), the test-function values N and spatial
gradients dN, the quadrature weights w (Gauss weight x detJ), and the PDE
coefficient fields kappa, v, s evaluated at those points.  At train time
the weak-form residual is a fixed contraction of these constants against
network outputs (SURVEY.md §0 item 4).

Key TPU-first departures from the reference layout:
  * N / dN / w are [nQ] tables shared by ALL nodes (uniform grid), not
    replicated per node — smaller memory, broadcast in the einsum.
  * Everything is assembled once and kept device-resident; the reference
    re-fed this data host->device every step via feed dicts (SURVEY.md
    §3.2) — do not copy that.
  * Leading axes are padded to a multiple of the data-parallel shard count
    with mask vectors, so arrays shard cleanly over the device mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from ..problems.adpde import ADPDE
from ..utils.helpers import pair_mats
from .element import HatQuadrature


class QuadData(NamedTuple):
    """Interior (weak-form) fixed data.  All entries are arrays.

    coords [K, nQ, n_in]  network inputs at quad points: (x[, t][, mu])
    N      [nQ]           test-function values (shared across nodes)
    dN     [nQ, d]        spatial test-function gradients
    w      [nQ]           Gauss weight x Jacobian determinant
    kappa  [K, nQ]        diffusivity at quad points
    vel    [K, nQ, d]     velocity at quad points
    src    [K, nQ]        source at quad points
    react  [K, nQ]        reaction coefficient at quad points
    mask   [K]            1.0 for real test functions, 0.0 for padding

    Order-2 test spaces (fem/element.py build_test_classes) carry PER-NODE
    tables instead: N/w are [K, nQ] (dN [K, nQ, d]), and after the
    mini-batch reshape [B, Kb, nQ(, d)].  ``tables_per_node`` is the one
    predicate distinguishing the layouts — use it instead of re-deriving
    ndim checks at call sites.
    """

    coords: np.ndarray
    N: np.ndarray
    dN: np.ndarray
    w: np.ndarray
    kappa: np.ndarray
    vel: np.ndarray
    src: np.ndarray
    react: np.ndarray
    mask: np.ndarray

    @property
    def tables_per_node(self) -> bool:
        """True when N/dN/w are per-node (order-2) tables — [K, nQ] or
        batched [B, Kb, nQ] — rather than shared [nQ] ones."""
        return np.ndim(self.N) >= 2


class PointData(NamedTuple):
    """Penalty-point fixed data (BC / IC / observations).

    coords [N, n_in]  network inputs
    values [N]        target values (g on boundary, u0 at t=0, ...)
    mask   [N]        1.0 real / 0.0 padding
    """

    coords: np.ndarray
    values: np.ndarray
    mask: np.ndarray


class FluxData(NamedTuple):
    """Neumann/Robin (normal-flux) penalty-point fixed data (beyond-
    reference: the reference is Dirichlet-only).  The residual at a
    point is ``alpha u + sum_j dirs_j du/dx_j - values`` with
    ``dirs = kappa(x, t) * n_seg`` and ``alpha`` precomputed host-side
    (zeros for pure Neumann), so the loss needs one jacobian contraction
    and no in-graph normal/field logic.

    coords [N, n_in]  network inputs
    dirs   [N, d]     kappa-scaled outward segment normals
    values [N]        target normal flux g
    mask   [N]        1.0 real / 0.0 padding
    alpha  [N]        Robin u-coefficient (0 = Neumann)
    """

    coords: np.ndarray
    dirs: np.ndarray
    values: np.ndarray
    mask: np.ndarray
    alpha: np.ndarray


@dataclass(frozen=True)
class ProblemStatic:
    """Static (non-array) description of the assembled problem."""

    n_space: int
    time_dependent: bool
    n_mor: int
    n_inputs: int
    n_test: int            # real (unpadded) test-function count
    n_quad_per_test: int
    n_bc: int
    n_ic: int
    input_lo: np.ndarray   # [n_inputs] for input scaling
    input_hi: np.ndarray
    test_order: int = 1    # 1 = hat test space, 2 = quadratic Lagrange
    n_neu: int = 0         # real Neumann (flux) penalty points


class FixedData(NamedTuple):
    quad: QuadData
    bc: PointData
    ic: Optional[PointData]
    static: ProblemStatic
    neu: Optional[FluxData] = None


def _pad_axis0(a: np.ndarray, target: int) -> np.ndarray:
    if a.shape[0] == target:
        return a
    pad = target - a.shape[0]
    filler = np.repeat(a[:1], pad, axis=0)
    return np.concatenate([a, filler], axis=0)


def _pad_to_multiple(n: int, m: int) -> int:
    return int(-(-n // m) * m)


def _append_mu(coords: np.ndarray, mu_samples: np.ndarray) -> np.ndarray:
    """Cartesian pairing of point coords with MOR samples.

    coords [..., c]; mu_samples [M, P] -> [M * K, ..., c + P] with the
    sample index varying slowest (reference UF.pairMats semantics,
    SURVEY.md §3.5).
    """
    k = coords.shape[0]
    m, p = mu_samples.shape
    tiled = np.tile(coords, (m,) + (1,) * (coords.ndim - 1))  # [M*K, ..., c]
    mu_rep = np.repeat(mu_samples, k, axis=0)  # [M*K, P], row m*K+k = mu[m]
    mu_full = np.broadcast_to(
        mu_rep.reshape((m * k,) + (1,) * (coords.ndim - 2) + (p,)),
        (m * k,) + coords.shape[1:-1] + (p,),
    )
    return np.concatenate([tiled, mu_full], axis=-1)


def pad_quad(quad: QuadData, multiple: int) -> QuadData:
    """Re-pad a QuadData's leading axis to a multiple (for sharding/batching).

    Padding rows replicate row 0 and are masked out of the loss; existing
    padding is first stripped using the mask.
    """
    real = int(quad.mask.sum())
    target = _pad_to_multiple(real, multiple)
    mask = np.zeros(target)
    mask[:real] = 1.0

    per_node_tables = quad.tables_per_node  # order-2 test space

    def tbl(a):
        # [nQ]-shaped shared tables pass through; per-node [K, nQ(, d)]
        # tables (order-2 test space) pad like the other node arrays
        return _pad_axis0(a[:real], target) if per_node_tables else a

    return QuadData(
        coords=_pad_axis0(quad.coords[:real], target),
        N=tbl(quad.N),
        dN=tbl(quad.dN),
        w=tbl(quad.w),
        kappa=_pad_axis0(quad.kappa[:real], target),
        vel=_pad_axis0(quad.vel[:real], target),
        src=_pad_axis0(quad.src[:real], target),
        react=_pad_axis0(quad.react[:real], target),
        mask=mask,
    )


def pad_flux(flux: FluxData, multiple: int) -> FluxData:
    """Re-pad a FluxData's leading axis to a multiple (mask-aware)."""
    real = int(flux.mask.sum())
    target = _pad_to_multiple(real, multiple)
    mask = np.zeros(target)
    mask[:real] = 1.0
    return FluxData(
        coords=_pad_axis0(flux.coords[:real], target),
        dirs=_pad_axis0(flux.dirs[:real], target),
        values=_pad_axis0(flux.values[:real], target),
        mask=mask,
        alpha=_pad_axis0(flux.alpha[:real], target),
    )


def pad_points(points: PointData, multiple: int) -> PointData:
    """Re-pad a PointData's leading axis to a multiple (mask-aware)."""
    real = int(points.mask.sum())
    target = _pad_to_multiple(real, multiple)
    mask = np.zeros(target)
    mask[:real] = 1.0
    return PointData(
        coords=_pad_axis0(points.coords[:real], target),
        values=_pad_axis0(points.values[:real], target),
        mask=mask,
    )


def build_fixed_data(
    pde: ADPDE,
    disc_num,
    b_disc_num: int = 10,
    t_disc_num: Optional[int] = None,
    integ_p_num: int = 2,
    pad_multiple: int = 1,
    test_order: int = 1,
    max_test: Optional[int] = None,
    subsample_seed: int = 0,
) -> FixedData:
    """Assemble all device constants for a problem + discretization.

    disc_num:    spatial elements per dimension (int or per-dim sequence)
    b_disc_num:  boundary points per segment edge
    t_disc_num:  time elements (required iff pde is time-dependent)
    integ_p_num: Gauss-Legendre points per dimension per element
    pad_multiple: pad leading axes to a multiple of this (shard count)
    test_order:  1 = multilinear hat test functions (the reference's
                 space); 2 = quadratic Lagrange test space (beyond-
                 reference: lifts the O(h^2) invisible-error floor to
                 O(h^3) on the same mesh — fem/element.py).  Order 2
                 stores per-node [K, nQ] test tables because nodes belong
                 to different vertex/bubble classes.
    max_test:    keep only a uniform random subset of this many test-
                 function centres (deterministic in ``subsample_seed``).
                 For DIAGNOSTIC meshes only (``residual_adequacy``
                 probes: the RMS residual density needs thousands of
                 classes, not millions — VERDICT r4 item 3); a TRAINING
                 mesh subsampled this way would leave parts of the
                 domain untested.  Applied before any MOR pairing, so
                 with MOR every mu sample still pairs with the same
                 subset.
    subsample_seed: RNG seed for ``max_test``.
    """
    d = pde.dim
    td = pde.time_dependent
    if td and t_disc_num is None:
        raise ValueError("time-dependent problems require t_disc_num")

    mesh = pde.domain.mesh(disc_num)
    centers_x = mesh.interior_nodes  # [Ks, d]
    if centers_x.shape[0] == 0:
        raise ValueError("no interior test-function centres; refine disc_num")
    h = mesh.spacing.copy()

    if td:
        t0, t1 = pde.t_interval
        nt = int(t_disc_num)
        t_nodes = np.linspace(t0, t1, nt + 1)
        if nt < 2:
            raise ValueError("t_disc_num must be >= 2")
        t_centers = t_nodes[1:-1][:, None]  # interior time nodes
        h_full = np.concatenate([h, [(t1 - t0) / nt]])
        centers = pair_mats(centers_x, t_centers)  # [Ks*(nt-1), d+1]
    else:
        h_full = h
        centers = centers_x

    if test_order == 1:
        if max_test is not None and centers.shape[0] > int(max_test):
            rng = np.random.default_rng(subsample_seed)
            idx = rng.choice(centers.shape[0], int(max_test),
                             replace=False)
            centers = centers[np.sort(idx)]
        hq = HatQuadrature.build(h_full, integ_p_num)
        coords = centers[:, None, :] + hq.offsets[None, :, :]  # [K, nQ, D]
        n_tbl, dn_tbl, w_tbl = hq.N, hq.dN[:, :d], hq.w
    else:
        from .element import build_test_classes

        classes = build_test_classes(h_full, integ_p_num, order=test_order)
        lo_b, hi_b = pde.domain.bounds
        axes_v = [np.linspace(lo_b[j], hi_b[j], mesh.shape[j])
                  for j in range(d)]
        axes_b = [(a[:-1] + a[1:]) / 2.0 for a in axes_v]
        if td:
            t_v = t_nodes[1:-1]
            t_b = (t_nodes[:-1] + t_nodes[1:]) / 2.0
        coords_list, n_list, dn_list, w_list = [], [], [], []
        for cls in classes:
            ax = [axes_v[j] if cls.kinds[j] == "v" else axes_b[j]
                  for j in range(d)]
            grids = np.meshgrid(*ax, indexing="ij")
            cand = np.stack([g.ravel() for g in grids], axis=-1)  # [Nc, d]
            keep = pde.domain.support_inside(cand, cls.half_support[:d])
            cx = cand[keep]
            if td:
                tt = t_v if cls.kinds[d] == "v" else t_b
                cc = pair_mats(cx, tt[:, None])
            else:
                cc = cx
            kc = cc.shape[0]
            if kc == 0:
                continue
            coords_list.append(cc[:, None, :] + cls.offsets[None, :, :])
            n_list.append(np.broadcast_to(cls.N, (kc,) + cls.N.shape))
            dn_list.append(np.broadcast_to(
                cls.dN[None, :, :d], (kc, cls.dN.shape[0], d)))
            w_list.append(np.broadcast_to(cls.w, (kc,) + cls.w.shape))
        if not coords_list:
            raise ValueError(
                "no test-function centres at test_order=2; refine disc_num"
            )
        coords = np.concatenate(coords_list, axis=0)
        n_tbl = np.ascontiguousarray(np.concatenate(n_list, axis=0))
        dn_tbl = np.ascontiguousarray(np.concatenate(dn_list, axis=0))
        w_tbl = np.ascontiguousarray(np.concatenate(w_list, axis=0))
        if max_test is not None and coords.shape[0] > int(max_test):
            # subsample across the concatenated classes (keeps the class
            # mix proportional in expectation) BEFORE the coefficient
            # evals and MOR tiling below
            rng = np.random.default_rng(subsample_seed)
            idx = np.sort(rng.choice(coords.shape[0], int(max_test),
                                     replace=False))
            coords, n_tbl = coords[idx], n_tbl[idx]
            dn_tbl, w_tbl = dn_tbl[idx], w_tbl[idx]
    k_real, nq = coords.shape[0], coords.shape[1]

    # ---- MOR pairing (parametric inputs appended to network coords) ----
    n_mor = 0
    if pde.mor is not None:
        n_mor = pde.mor.n_params
        m_samples = pde.mor.samples.shape[0]
        coords = _append_mu(coords, pde.mor.samples)  # [M*K, nQ, D+P]
        k_real = coords.shape[0]
        if test_order != 1:
            # per-node tables repeat with the mu pairing (sample index
            # varies slowest, matching _append_mu)
            n_tbl = np.tile(n_tbl, (m_samples, 1))
            dn_tbl = np.tile(dn_tbl, (m_samples, 1, 1))
            w_tbl = np.tile(w_tbl, (m_samples, 1))

    flat = coords.reshape(-1, coords.shape[-1])
    x_f = flat[:, :d]
    t_f = flat[:, d] if td else None
    mu_f = flat[:, (d + 1 if td else d):] if n_mor else None
    kappa = pde.eval_diff(x_f, t_f, mu_f).reshape(k_real, nq)
    vel = pde.eval_vel(x_f, t_f, mu_f).reshape(k_real, nq, d)
    src = pde.eval_source(x_f, t_f, mu_f).reshape(k_real, nq)
    react = pde.eval_react(x_f, t_f, mu_f).reshape(k_real, nq)

    # ---- boundary condition points --------------------------------------
    from ..problems.adpde import NeumannBC, RobinBC

    bc_coords_list: List[np.ndarray] = []
    bc_vals_list: List[np.ndarray] = []
    neu_coords_list: List[np.ndarray] = []
    neu_dirs_list: List[np.ndarray] = []
    neu_vals_list: List[np.ndarray] = []
    neu_alpha_list: List[np.ndarray] = []
    seg_points = pde.domain.boundary_points(b_disc_num)
    for seg, pts in enumerate(seg_points):
        if pde.bcs[seg] is None:
            continue
        if td:
            pts_t = pair_mats(pts, np.linspace(*pde.t_interval, int(t_disc_num) + 1)[:, None])
        else:
            pts_t = pts
        if pde.mor is not None:
            pts_t = _append_mu(pts_t, pde.mor.samples)
        xs = pts_t[:, :d]
        ts = pts_t[:, d] if td else None
        mus = pts_t[:, (d + 1 if td else d):] if pde.mor is not None else None
        if isinstance(pde.bcs[seg], (NeumannBC, RobinBC)):
            # flux rows: kappa-scaled outward normal + target flux g
            # (+ the Robin u-coefficient alpha; zeros for pure Neumann)
            normal = pde.domain.segment_normal(seg)  # [d]
            kap = pde.eval_diff(xs, ts, mus)         # [N]
            neu_coords_list.append(pts_t)
            neu_dirs_list.append(kap[:, None] * normal[None, :])
            neu_vals_list.append(pde.eval_neumann(seg, xs, ts, mus))
            neu_alpha_list.append(pde.eval_robin_alpha(seg, xs, ts, mus))
            continue
        vals = pde.eval_bc(seg, xs, ts, mus)
        bc_coords_list.append(pts_t)
        bc_vals_list.append(vals)
    if not bc_coords_list:
        raise ValueError("no Dirichlet BC data on any segment")
    bc_coords = np.concatenate(bc_coords_list, axis=0)
    bc_vals = np.concatenate(bc_vals_list, axis=0)

    # ---- initial condition points ---------------------------------------
    ic: Optional[PointData] = None
    if td:
        in_dom = pde.domain.in_domain(mesh.nodes)
        ic_x = mesh.nodes[in_dom]
        ic_pts = np.concatenate(
            [ic_x, np.full((ic_x.shape[0], 1), pde.t_interval[0])], axis=-1
        )
        if pde.mor is not None:
            ic_pts = _append_mu(ic_pts, pde.mor.samples)
        mus = ic_pts[:, d + 1:] if pde.mor is not None else None
        ic_vals = pde.eval_ic(ic_pts[:, :d], mus)
        n_ic_real = ic_pts.shape[0]
        n_ic_pad = _pad_to_multiple(n_ic_real, pad_multiple)
        ic_mask = np.zeros(n_ic_pad)
        ic_mask[:n_ic_real] = 1.0
        ic = PointData(
            coords=_pad_axis0(ic_pts, n_ic_pad),
            values=_pad_axis0(ic_vals, n_ic_pad),
            mask=ic_mask,
        )

    # ---- padding for clean sharding --------------------------------------
    k_pad = _pad_to_multiple(k_real, pad_multiple)
    quad_mask = np.zeros(k_pad)
    quad_mask[:k_real] = 1.0
    quad = QuadData(
        coords=_pad_axis0(coords, k_pad),
        N=n_tbl if test_order == 1 else _pad_axis0(n_tbl, k_pad),
        dN=dn_tbl if test_order == 1 else _pad_axis0(dn_tbl, k_pad),
        w=w_tbl if test_order == 1 else _pad_axis0(w_tbl, k_pad),
        kappa=_pad_axis0(kappa, k_pad),
        vel=_pad_axis0(vel, k_pad),
        src=_pad_axis0(src, k_pad),
        react=_pad_axis0(react, k_pad),
        mask=quad_mask,
    )

    nb_real = bc_coords.shape[0]
    nb_pad = _pad_to_multiple(nb_real, pad_multiple)
    bc_mask = np.zeros(nb_pad)
    bc_mask[:nb_real] = 1.0
    bc = PointData(
        coords=_pad_axis0(bc_coords, nb_pad),
        values=_pad_axis0(bc_vals, nb_pad),
        mask=bc_mask,
    )

    neu: Optional[FluxData] = None
    n_neu_real = 0
    if neu_coords_list:
        neu_coords = np.concatenate(neu_coords_list, axis=0)
        n_neu_real = neu_coords.shape[0]
        nn_pad = _pad_to_multiple(n_neu_real, pad_multiple)
        neu_mask = np.zeros(nn_pad)
        neu_mask[:n_neu_real] = 1.0
        neu = FluxData(
            coords=_pad_axis0(neu_coords, nn_pad),
            dirs=_pad_axis0(np.concatenate(neu_dirs_list, axis=0), nn_pad),
            values=_pad_axis0(np.concatenate(neu_vals_list, axis=0), nn_pad),
            mask=neu_mask,
            alpha=_pad_axis0(np.concatenate(neu_alpha_list, axis=0), nn_pad),
        )

    # ---- input scaling ranges (network preconditioning) ------------------
    lo, hi = pde.domain.bounds
    lo = list(np.asarray(lo, dtype=np.float64))
    hi = list(np.asarray(hi, dtype=np.float64))
    if td:
        lo.append(pde.t_interval[0])
        hi.append(pde.t_interval[1])
    if pde.mor is not None:
        lo.extend(pde.mor.bounds[:, 0])
        hi.extend(pde.mor.bounds[:, 1])

    static = ProblemStatic(
        n_space=d,
        time_dependent=td,
        n_mor=n_mor,
        n_inputs=coords.shape[-1],
        n_test=k_real,
        n_quad_per_test=nq,
        n_bc=nb_real,
        n_ic=0 if ic is None else int(ic.mask.sum()),
        input_lo=np.asarray(lo),
        input_hi=np.asarray(hi),
        test_order=int(test_order),
        n_neu=n_neu_real,
    )
    return FixedData(quad=quad, bc=bc, ic=ic, static=static, neu=neu)
