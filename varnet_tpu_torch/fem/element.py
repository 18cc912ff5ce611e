"""[Copy of ``varnet_tpu/fem/element.py``, pure NumPy, so that the PyTorch port
imports no JAX; ``tests/test_torch_host.py`` holds the two bit-equal.]

Finite-element master element and hat-function quadrature tables.

TPU-native re-implementation of the reference's variational machinery
(reference: ``FiniteElement.py``, class ``FE`` — SURVEY.md §2.1 #5): first
order (multi-)linear shape functions on the master element, tensor-product
Gauss-Legendre quadrature, and the compactly-supported "hat" test functions
centred at grid nodes.

Everything here is host-side NumPy: the outputs are *fixed data* — constant
tables that are uploaded to the TPU once and contracted against network
outputs at train time (SURVEY.md §0 item 4).  Because the training grid is
uniform, the test-function values N, gradients dN, and quadrature weights w
are IDENTICAL for every node: only [nQ]-sized tables are needed, not
[K, nQ] — a large memory saving over the reference layout, and exactly the
broadcast-friendly form the residual einsum wants.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np


def gauss_legendre(n: int):
    """Gauss-Legendre points/weights on [-1, 1]; exact for degree <= 2n-1."""
    pts, wts = np.polynomial.legendre.leggauss(int(n))
    return pts.astype(np.float64), wts.astype(np.float64)


class MasterElement:
    """Multilinear master element on [-1, 1]^dim with 2^dim corner nodes.

    Mirrors the reference FE class surface (SURVEY.md §1 table: "FE(dim,
    integPnum) -> GL points/weights, N, dN on master element").
    """

    def __init__(self, dim: int, integ_p_num: int = 2):
        if dim < 1:
            raise ValueError("dim must be >= 1")
        if integ_p_num < 1:
            raise ValueError("integ_p_num must be >= 1")
        self.dim = int(dim)
        self.integ_p_num = int(integ_p_num)
        # Corner nodes in {-1, +1}^dim, lexicographic order.
        self.nodes = np.array(
            list(itertools.product((-1.0, 1.0), repeat=self.dim)), dtype=np.float64
        )  # [2^dim, dim]
        # Tensor-product Gauss-Legendre rule.
        p1, w1 = gauss_legendre(self.integ_p_num)
        grids = np.meshgrid(*([p1] * self.dim), indexing="ij")
        self.gauss_points = np.stack([g.ravel() for g in grids], axis=-1)
        wgrids = np.meshgrid(*([w1] * self.dim), indexing="ij")
        self.gauss_weights = np.prod(np.stack([g.ravel() for g in wgrids], -1), -1)

    @property
    def n_nodes(self) -> int:
        return 2**self.dim

    def shape_values(self, xi: np.ndarray) -> np.ndarray:
        """N_i(xi) for all corners i.  xi: [P, dim] -> [P, 2^dim].

        N_i(xi) = prod_j (1 + node_ij * xi_j) / 2; partition of unity.
        """
        xi = np.atleast_2d(np.asarray(xi, dtype=np.float64))
        # [P, 2^dim, dim]
        terms = (1.0 + self.nodes[None, :, :] * xi[:, None, :]) / 2.0
        return np.prod(terms, axis=-1)

    def shape_grads(self, xi: np.ndarray) -> np.ndarray:
        """dN_i/dxi_j at xi.  xi: [P, dim] -> [P, 2^dim, dim]."""
        xi = np.atleast_2d(np.asarray(xi, dtype=np.float64))
        terms = (1.0 + self.nodes[None, :, :] * xi[:, None, :]) / 2.0  # [P,2^d,d]
        grads = np.empty(terms.shape, dtype=np.float64)
        for j in range(self.dim):
            others = np.prod(np.delete(terms, j, axis=-1), axis=-1)  # [P, 2^d]
            grads[:, :, j] = (self.nodes[None, :, j] / 2.0) * others
        return grads


@dataclass(frozen=True)
class HatQuadrature:
    """Quadrature tables for a node-centred multilinear hat test function.

    The hat v_k centred at grid node x_k on a uniform grid with per-dim
    spacing h spans the 2^dim elements around x_k (its support is the box
    x_k +/- h).  Because v_k has a kink at x_k along each axis, the rule
    integrates each of the 2^dim orthants of the support with a mapped
    tensor-product Gauss-Legendre rule (SURVEY.md §0 items 2-4).

    Tables (node-independent on a uniform grid):
      offsets [nQ, dim]  quad-point coordinates relative to the node centre
      N       [nQ]       v_k at the quad points
      dN      [nQ, dim]  grad v_k at the quad points (ALL dims, incl. time)
      w       [nQ]       Gauss weight x Jacobian determinant

    nQ = (2 * integ_p_num)^dim.  Per-node quad coordinates are
    ``x_k[None, :] + offsets``.
    """

    dim: int
    h: np.ndarray  # [dim] grid spacing
    integ_p_num: int
    offsets: np.ndarray
    N: np.ndarray
    dN: np.ndarray
    w: np.ndarray

    @staticmethod
    def build(h, integ_p_num: int = 2) -> "HatQuadrature":
        h = np.atleast_1d(np.asarray(h, dtype=np.float64))
        dim = h.shape[0]
        eta, wg = gauss_legendre(integ_p_num)
        # Per-dim combined table over both orthants (2 * n entries per dim).
        # In orthant sign s along dim j, a quad point sits at
        #   x = x_k + s * h_j * (1 + eta) / 2,           eta in [-1, 1]
        # where the 1-D hat factor and its derivative are
        #   hat = (1 - eta) / 2,   dhat/dx = -s / h_j,
        # and the 1-D Jacobian weight is w = wg * h_j / 2.
        off_1d, hat_1d, dhat_1d, w_1d = [], [], [], []
        for j in range(dim):
            offs, hats, dhats, ws = [], [], [], []
            for s in (-1.0, 1.0):
                offs.append(s * h[j] * (1.0 + eta) / 2.0)
                hats.append((1.0 - eta) / 2.0)
                dhats.append(np.full_like(eta, -s / h[j]))
                ws.append(wg * h[j] / 2.0)
            off_1d.append(np.concatenate(offs))
            hat_1d.append(np.concatenate(hats))
            dhat_1d.append(np.concatenate(dhats))
            w_1d.append(np.concatenate(ws))

        # Tensor product across dims.
        n1 = 2 * integ_p_num
        idx = np.meshgrid(*([np.arange(n1)] * dim), indexing="ij")
        idx = np.stack([i.ravel() for i in idx], axis=-1)  # [nQ, dim]
        nq = idx.shape[0]
        offsets = np.empty((nq, dim))
        hat_f = np.empty((nq, dim))
        dhat_f = np.empty((nq, dim))
        w_f = np.empty((nq, dim))
        for j in range(dim):
            offsets[:, j] = off_1d[j][idx[:, j]]
            hat_f[:, j] = hat_1d[j][idx[:, j]]
            dhat_f[:, j] = dhat_1d[j][idx[:, j]]
            w_f[:, j] = w_1d[j][idx[:, j]]
        N = np.prod(hat_f, axis=-1)
        w = np.prod(w_f, axis=-1)
        dN = np.empty((nq, dim))
        for j in range(dim):
            others = np.prod(np.delete(hat_f, j, axis=-1), axis=-1)
            dN[:, j] = dhat_f[:, j] * others
        return HatQuadrature(
            dim=dim, h=h, integ_p_num=int(integ_p_num),
            offsets=offsets, N=N, dN=dN, w=w,
        )

    @property
    def n_quad(self) -> int:
        return self.offsets.shape[0]

    def support_volume(self) -> float:
        """Volume of supp(v_k) = prod_j 2 h_j; integral of weights equals it."""
        return float(np.prod(2.0 * self.h))


# --------------------------------------------------------------------------
# Second-order (quadratic Lagrange) test space — beyond-reference accuracy.
#
# The weak form only sees the trial net through integrals against the test
# functions, so trial error components outside span{v_k} are invisible to
# the loss; with multilinear hats that span approximates functions to
# O(h^2), which is exactly the measured accuracy floor (BASELINE.md h^2-
# bias study: rel-L2 floors at ~0.21 h^2 across meshes).  A quadratic
# Lagrange test space lifts the invisible error to O(h^3) on the SAME mesh.
#
# The uniform-grid quadratic Lagrange basis splits into tensor-product
# CLASSES: per dim, a factor is either a VERTEX function (support: the 2
# elements around a grid vertex; pieces L1(s)=2s^2-s toward the node and
# L0(s)=2s^2-3s+1 away from it) or a BUBBLE (support: 1 element, centred
# at its midpoint; B(s)=4s(1-s)).  dim D gives 2^D classes, each with its
# OWN node grid and ONE node-independent table — the same broadcast-
# friendly design as HatQuadrature, per class.  Each factor uses
# 2*integ_p_num Gauss points per dim (2 pieces x n for vertex, 1 piece x
# 2n for bubble), so nQ = (2*integ_p_num)^D is identical across classes
# and the per-class tables stack into [C, nQ] arrays.
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class TestClassQuadrature:
    """Quadrature tables for ONE tensor-product test-function class.

    kinds: per-dim factor kind, "v" (vertex) or "b" (bubble).
    half_support: per-dim support half-width (h_j for "v", h_j/2 for "b").
    offsets/N/dN/w: as HatQuadrature, node-independent within the class.
    """

    dim: int
    h: np.ndarray
    integ_p_num: int
    kinds: tuple
    half_support: np.ndarray
    offsets: np.ndarray
    N: np.ndarray
    dN: np.ndarray
    w: np.ndarray

    @property
    def n_quad(self) -> int:
        return self.offsets.shape[0]

    def support_volume(self) -> float:
        return float(np.prod(2.0 * self.half_support))


def _factor_tables_1d(kind: str, h: float, n: int):
    """1-D factor tables: (offsets, val, dval, w), each [2 n].

    kind "v": quadratic vertex function across the 2 adjacent elements,
    local coordinate s in [0, 1] per element:
      toward-node piece  L1(s) = 2 s^2 - s      (1 at the node, s = 1)
      away-from-node     L0(s) = 2 s^2 - 3 s + 1 (1 at the node, s = 0)
    kind "b": bubble B(s) = 4 s (1 - s) on ONE element, node at its centre.
    """
    eta, wg = gauss_legendre(n)
    if kind == "v":
        s = (1.0 + eta) / 2.0
        # left element [node - h, node]: node at s = 1
        off_l = -h + h * s
        val_l = 2.0 * s**2 - s
        dval_l = (4.0 * s - 1.0) / h
        # right element [node, node + h]: node at s = 0
        off_r = h * s
        val_r = 2.0 * s**2 - 3.0 * s + 1.0
        dval_r = (4.0 * s - 3.0) / h
        return (
            np.concatenate([off_l, off_r]),
            np.concatenate([val_l, val_r]),
            np.concatenate([dval_l, dval_r]),
            np.concatenate([wg * h / 2.0, wg * h / 2.0]),
        )
    if kind == "b":
        eta2, wg2 = gauss_legendre(2 * n)
        s = (1.0 + eta2) / 2.0
        return (
            h * (s - 0.5),
            4.0 * s * (1.0 - s),
            (4.0 - 8.0 * s) / h,
            wg2 * h / 2.0,
        )
    raise ValueError(f"unknown factor kind {kind!r}")


def build_test_classes(h, integ_p_num: int = 2, order: int = 1):
    """Quadrature tables for every test-function class of the given order.

    order 1: the single multilinear-hat class (== HatQuadrature tables).
    order 2: the 2^dim quadratic Lagrange classes described above.
    Returns a list of TestClassQuadrature; all classes share one nQ.
    """
    h = np.atleast_1d(np.asarray(h, dtype=np.float64))
    dim = h.shape[0]
    if order == 1:
        hq = HatQuadrature.build(h, integ_p_num)
        return [TestClassQuadrature(
            dim=dim, h=h, integ_p_num=int(integ_p_num), kinds=("v",) * dim,
            half_support=h.copy(), offsets=hq.offsets, N=hq.N, dN=hq.dN,
            w=hq.w,
        )]
    if order != 2:
        raise ValueError("test_order must be 1 or 2")

    classes = []
    n1 = 2 * int(integ_p_num)
    for kinds in itertools.product(("v", "b"), repeat=dim):
        fac = [_factor_tables_1d(k, h[j], int(integ_p_num))
               for j, k in enumerate(kinds)]
        idx = np.meshgrid(*([np.arange(n1)] * dim), indexing="ij")
        idx = np.stack([i.ravel() for i in idx], axis=-1)  # [nQ, dim]
        nq = idx.shape[0]
        offsets = np.empty((nq, dim))
        val_f = np.empty((nq, dim))
        dval_f = np.empty((nq, dim))
        w_f = np.empty((nq, dim))
        for j in range(dim):
            offsets[:, j] = fac[j][0][idx[:, j]]
            val_f[:, j] = fac[j][1][idx[:, j]]
            dval_f[:, j] = fac[j][2][idx[:, j]]
            w_f[:, j] = fac[j][3][idx[:, j]]
        N = np.prod(val_f, axis=-1)
        w = np.prod(w_f, axis=-1)
        dN = np.empty((nq, dim))
        for j in range(dim):
            others = np.prod(np.delete(val_f, j, axis=-1), axis=-1)
            dN[:, j] = dval_f[:, j] * others
        half = np.where(np.array(kinds) == "v", h, h / 2.0)
        classes.append(TestClassQuadrature(
            dim=dim, h=h, integ_p_num=int(integ_p_num), kinds=kinds,
            half_support=half, offsets=offsets, N=N, dN=dN, w=w,
        ))
    return classes
