"""[Copy of ``varnet_tpu/fem/adaptive.py``, pure NumPy, so that the PyTorch port
imports no JAX; ``tests/test_torch_adaptive.py`` holds the two bit-equal.]

Residual-driven adaptive refinement of the hat test space (h-adaptivity).

Beyond-reference capability: the reference trains against a FIXED uniform
test-function grid (SURVEY.md §0 item 2).  Because the weak-form loss is a
plain sum of independent per-test-function residuals, ENRICHING the test
space is a pure data operation — no graph surgery, no mesh data structure:

  * a refined hat at spacing h/f has the same quadrature count per support
    ((2 integ_p)^D) as its parent, so mixed-scale test spaces are just
    extra rows of ``QuadData``;
  * mixed scales need PER-NODE N/dN/w tables — exactly the layout the
    order-2 test space already uses (``QuadData.tables_per_node``), which
    the loss (ops/residual.py), the trainer sharding (train/trainer.py)
    and the LM refiner (train/gauss_newton.py) all already dispatch on.

Selection criterion: |r_k| of the support-volume-normalized residual
(train/loss.py ``normalize_residual``) — a mean residual *density*,
comparable across scales, so coarse high-residual regions outrank
already-refined ones.

Geometry is recovered STATELESSLY from the quadrature coordinates: the
per-dim Gauss-Legendre offsets of a hat are symmetric (mean 0) and reach
max |offset| = h (1 + xi_max) / 2 with xi_max the largest GL node on
[-1, 1] (fem/element.py ``HatQuadrature.build``), so

    center_k = mean_q coords_k,
    h_k      = max_q |coords_k - center_k| / ((1 + xi_max) / 2).

Refined rows recover their own finer h the same way, so ``refine_fixed``
composes across calls without auxiliary bookkeeping.

Validity of the new supports needs no domain test: each child hat's
support is contained in its parent's (child center at parent_center +
i h/f with |i| <= f-1 and child half-support h/f, so the child support
stays within parent_center +/- h), and parent supports are inside the
closed domain / time interval by construction.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .assembly import FixedData, QuadData, _pad_axis0, _pad_to_multiple
from .element import HatQuadrature, gauss_legendre


def hat_geometry(coords: np.ndarray, integ_p_num: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Recover (centers [K, D], spacings h [K, D]) of hat test functions
    from their quadrature coordinates ``coords [K, nQ, D]`` alone.

    The support of row k is ``centers[k] +/- h[k]`` per dim.
    """
    eta, _ = gauss_legendre(integ_p_num)
    ratio = (1.0 + float(np.max(eta))) / 2.0
    coords = np.asarray(coords, dtype=np.float64)
    centers = coords.mean(axis=1)
    halves = np.abs(coords - centers[:, None, :]).max(axis=1) / ratio
    return centers, halves


def _keys(centers: np.ndarray, spacings: np.ndarray, tol: float):
    """Integer dedup keys for (center, spacing) pairs, robust to the tiny
    floating-point differences between the same grid point reached from
    different parents."""
    ck = np.round(centers / tol).astype(np.int64)
    hk = np.round(spacings / tol).astype(np.int64)
    return [tuple(c) + tuple(h) for c, h in zip(ck, hk)]


def refine_fixed(
    pde,
    fixed: FixedData,
    flags: np.ndarray,
    integ_p_num: int,
    factor: int = 2,
    pad_multiple: int = 1,
) -> Tuple[FixedData, dict]:
    """Enrich the test space of ``fixed`` with finer hats under the
    flagged test functions.

    flags:   boolean [n_test] (real rows only) — which hats to refine.
    factor:  per-dim subdivision; each flagged hat of spacing h spawns the
             (2 factor - 1)^D hats of spacing h/factor whose centers lie
             strictly inside its support (duplicates — against existing
             rows and between adjacent flagged parents — are dropped).

    Returns (new FixedData, info).  BC/IC/flux data are untouched; the
    new quad carries per-node tables (``QuadData.tables_per_node``).
    Not supported: MOR pairing (mu rows are not hat dims) and the
    order-2 test space (its classes are not self-similar under halving).
    """
    static = fixed.static
    quad = fixed.quad
    if static.n_mor:
        raise ValueError("adaptive refinement does not support MOR pairing")
    if static.test_order != 1:
        raise ValueError("adaptive refinement requires test_order=1 hats")
    if int(factor) < 2:
        raise ValueError("factor must be an integer >= 2")
    factor = int(factor)

    k_real = static.n_test
    nq = static.n_quad_per_test
    D = static.n_space + (1 if static.time_dependent else 0)
    d = static.n_space
    flags = np.asarray(flags, dtype=bool)
    if flags.shape[0] != k_real:
        raise ValueError(
            f"flags must cover the {k_real} real test functions, "
            f"got {flags.shape[0]}"
        )

    coords = np.asarray(quad.coords, dtype=np.float64)[:k_real]
    centers, spacings = hat_geometry(coords, integ_p_num)
    tol = float(spacings.min()) / factor * 1e-6
    existing = set(_keys(centers, spacings, tol))

    # ---- candidate child hats (dedup'd) ----------------------------------
    steps = np.arange(-(factor - 1), factor, dtype=np.float64)
    unit = np.stack(
        np.meshgrid(*([steps] * D), indexing="ij"), axis=-1
    ).reshape(-1, D)
    new_centers, new_spacings = [], []
    for k in np.nonzero(flags)[0]:
        h_child = spacings[k] / factor
        cand = centers[k][None, :] + unit * h_child[None, :]
        keys = _keys(cand, np.broadcast_to(h_child, cand.shape), tol)
        for c, key in zip(cand, keys):
            if key in existing:
                continue
            existing.add(key)
            new_centers.append(c)
            new_spacings.append(h_child)
    n_new = len(new_centers)
    info = {"n_flagged": int(flags.sum()), "n_added": n_new,
            "n_test": k_real + n_new}
    if n_new == 0:
        return fixed, info
    new_centers = np.asarray(new_centers)
    new_spacings = np.asarray(new_spacings)

    # ---- tables + coords per spacing group -------------------------------
    # Children of different refinement levels carry different tables; group
    # rows by their (quantized) spacing so each group builds one
    # HatQuadrature and broadcasts it.
    group_ids = {}
    row_group = np.empty(n_new, dtype=np.int64)
    for i, h in enumerate(new_spacings):
        key = tuple(np.round(h / tol).astype(np.int64))
        row_group[i] = group_ids.setdefault(key, len(group_ids))

    c_list, n_list, dn_list, w_list = [], [], [], []
    order = np.argsort(row_group, kind="stable")
    for g in range(len(group_ids)):
        rows = order[row_group[order] == g]
        hq = HatQuadrature.build(new_spacings[rows[0]], integ_p_num)
        cc = new_centers[rows][:, None, :] + hq.offsets[None, :, :]
        c_list.append(cc)
        n_list.append(np.broadcast_to(hq.N, (rows.size, nq)))
        dn_list.append(np.broadcast_to(hq.dN[None, :, :d],
                                       (rows.size, nq, d)))
        w_list.append(np.broadcast_to(hq.w, (rows.size, nq)))
    add_coords = np.concatenate(c_list, axis=0)
    add_n = np.ascontiguousarray(np.concatenate(n_list, axis=0))
    add_dn = np.ascontiguousarray(np.concatenate(dn_list, axis=0))
    add_w = np.ascontiguousarray(np.concatenate(w_list, axis=0))

    # ---- PDE fields at the new quadrature points -------------------------
    flat = add_coords.reshape(-1, D)
    x_f = flat[:, :d]
    t_f = flat[:, d] if static.time_dependent else None
    add_kappa = pde.eval_diff(x_f, t_f).reshape(n_new, nq)
    add_vel = pde.eval_vel(x_f, t_f).reshape(n_new, nq, d)
    add_src = pde.eval_source(x_f, t_f).reshape(n_new, nq)
    add_react = pde.eval_react(x_f, t_f).reshape(n_new, nq)

    # ---- concatenate with the existing real rows (per-node tables) -------
    def per_node(a, extra_shape=()):
        a = np.asarray(a)
        if a.ndim >= 2 + len(extra_shape):  # already per-node
            return a[:k_real]
        return np.broadcast_to(a, (k_real,) + a.shape)

    k_total = k_real + n_new
    k_pad = _pad_to_multiple(k_total, pad_multiple)
    mask = np.zeros(k_pad)
    mask[:k_total] = 1.0

    def cat(old, new):
        return _pad_axis0(
            np.concatenate([np.asarray(old), new], axis=0), k_pad
        )

    new_quad = QuadData(
        coords=cat(coords, add_coords),
        N=cat(per_node(quad.N), add_n),
        dN=cat(per_node(quad.dN, (1,)), add_dn),
        w=cat(per_node(quad.w), add_w),
        kappa=cat(quad.kappa[:k_real], add_kappa),
        vel=cat(quad.vel[:k_real], add_vel),
        src=cat(quad.src[:k_real], add_src),
        react=cat(quad.react[:k_real], add_react),
        mask=mask,
    )
    new_static = dataclasses.replace(static, n_test=k_total)
    return (
        FixedData(quad=new_quad, bc=fixed.bc, ic=fixed.ic,
                  static=new_static, neu=fixed.neu),
        info,
    )
