"""[Copy of ``varnet_tpu/geometry/domain.py``, pure NumPy, so that the PyTorch port
imports no JAX; ``tests/test_torch_host.py`` holds the two bit-equal.]

Computational domains: meshes, interiors, boundary discretization.

TPU-native re-implementation of the reference geometry layer
(reference: ``Domain.py`` — classes ``Domain1D`` and ``PolygonDomain2D``,
SURVEY.md §2.1 #4): produces the interior node grid (test-function centres),
per-segment boundary point sets for the Dirichlet BC penalty, and
point-in-domain queries for masking plots.  All host-side NumPy — this is
setup-time code; its outputs become device-resident constants.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np

from ..utils.helpers import cartesian_grid


@dataclass(frozen=True)
class Mesh:
    """A uniform node grid over the domain's bounding box.

    nodes     [N, dim]  all grid nodes
    shape     per-dim node counts
    spacing   [dim] grid spacing h
    interior_mask  [N] True where a node is a valid hat test-function
                   centre: the FULL support patch (node +/- h box) must lie
                   inside the domain so the hat quadrature tables apply
                   unmodified and integration-by-parts boundary terms vanish.
    """

    nodes: np.ndarray
    shape: Tuple[int, ...]
    spacing: np.ndarray
    interior_mask: np.ndarray

    @property
    def interior_nodes(self) -> np.ndarray:
        return self.nodes[self.interior_mask]


class Domain1D:
    """Interval domain [lo, hi] (reference Domain1D, SURVEY.md §2.1 #4)."""

    dim = 1

    def __init__(self, lo: float = 0.0, hi: float = 1.0):
        if not hi > lo:
            raise ValueError("Domain1D requires hi > lo")
        self.lo = float(lo)
        self.hi = float(hi)

    @property
    def bounds(self):
        return np.array([self.lo]), np.array([self.hi])

    def in_domain(self, pts: np.ndarray) -> np.ndarray:
        pts = np.atleast_2d(pts)
        return (pts[:, 0] > self.lo) & (pts[:, 0] < self.hi)

    def support_inside(self, centers: np.ndarray, half) -> np.ndarray:
        """True where the support box centre +/- half lies inside the
        interval (it may touch the endpoints: the test function vanishes
        there).  Used by the order-2 assembly, whose vertex and bubble
        classes have different support half-widths."""
        c = np.atleast_2d(centers)[:, 0]
        h = float(np.atleast_1d(half)[0])
        eps = 1e-12 * max(self.hi - self.lo, 1.0)
        return (c - h >= self.lo - eps) & (c + h <= self.hi + eps)

    def mesh(self, disc_num: int) -> Mesh:
        """Uniform grid with ``disc_num`` elements (disc_num + 1 nodes)."""
        n = int(disc_num) + 1
        nodes, _, spacing = cartesian_grid([self.lo], [self.hi], [n])
        interior = np.zeros(n, dtype=bool)
        interior[1:-1] = True
        return Mesh(nodes=nodes, shape=(n,), spacing=spacing, interior_mask=interior)

    def boundary_points(self, b_disc_num: int = 1) -> List[np.ndarray]:
        """Two segments: the endpoints (one point each)."""
        del b_disc_num
        return [np.array([[self.lo]]), np.array([[self.hi]])]

    def segment_normal(self, seg: int) -> np.ndarray:
        """Outward unit normal of a boundary segment (Neumann BCs)."""
        return np.array([-1.0]) if seg == 0 else np.array([1.0])

    @property
    def n_boundary_segments(self) -> int:
        return 2

    def grid_in_domain(self, counts) -> Tuple[np.ndarray, np.ndarray]:
        """Uniform evaluation grid with an all-true mask (for viz/eval)."""
        n = int(counts) if np.isscalar(counts) else int(counts[0])
        nodes, _, _ = cartesian_grid([self.lo], [self.hi], [n])
        return nodes, np.ones(nodes.shape[0], dtype=bool)


def _raycast(vertices: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Vectorized even-odd (ray casting) point-in-polygon test."""
    x, y = pts[:, 0], pts[:, 1]
    x1, y1 = vertices[:, 0], vertices[:, 1]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
    inside = np.zeros(pts.shape[0], dtype=bool)
    for i in range(vertices.shape[0]):
        crosses = (y1[i] > y) != (y2[i] > y)
        with np.errstate(divide="ignore", invalid="ignore"):
            x_int = x1[i] + (y - y1[i]) / (y2[i] - y1[i]) * (x2[i] - x1[i])
        inside ^= crosses & (x < x_int)
    return inside


def _segments_cross(p1, p2, p3, p4, eps: float) -> bool:
    """True if segments [p1,p2] and [p3,p4] intersect, including touching
    and collinear-overlap cases (holes must stay STRICTLY clear of other
    rings, so any contact counts)."""
    def cross2(u, v):
        return u[0] * v[1] - u[1] * v[0]

    d1 = cross2(p4 - p3, p1 - p3)
    d2 = cross2(p4 - p3, p2 - p3)
    d3 = cross2(p2 - p1, p3 - p1)
    d4 = cross2(p2 - p1, p4 - p1)
    if (((d1 > eps and d2 < -eps) or (d1 < -eps and d2 > eps))
            and ((d3 > eps and d4 < -eps) or (d3 < -eps and d4 > eps))):
        return True

    def on_seg(a, b, c):
        return (abs(cross2(b - a, c - a)) <= eps
                and min(a[0], b[0]) - eps <= c[0] <= max(a[0], b[0]) + eps
                and min(a[1], b[1]) - eps <= c[1] <= max(a[1], b[1]) + eps)

    return (on_seg(p3, p4, p1) or on_seg(p3, p4, p2)
            or on_seg(p1, p2, p3) or on_seg(p1, p2, p4))


def _rings_cross(a: np.ndarray, b: np.ndarray, eps: float) -> bool:
    """Any edge of closed ring a touches/crosses any edge of ring b."""
    ea = [(a[i], a[(i + 1) % a.shape[0]]) for i in range(a.shape[0])]
    eb = [(b[j], b[(j + 1) % b.shape[0]]) for j in range(b.shape[0])]
    return any(_segments_cross(p1, p2, p3, p4, eps)
               for p1, p2 in ea for p3, p4 in eb)


class PolygonDomain2D:
    """Polygonal 2-D domain, convex or not (reference PolygonDomain2D),
    optionally with polygonal HOLES (beyond-reference: internal obstacle
    boundaries — the geometry of flow-around-an-obstacle / cloaking
    applications).

    vertices: [V, 2] in order (either orientation); the polygon is closed
    implicitly (last vertex connects back to the first).  Boundary segment i
    is the edge vertices[i] -> vertices[i+1], so per-segment Dirichlet data
    can be attached edge by edge (SURVEY.md §0 item 8).

    holes: optional sequence of [Vh >= 3, 2] vertex arrays, each strictly
    inside the outer polygon and mutually disjoint.  Hole edges continue
    the segment numbering after the outer edges (outer 0..V-1, then hole 0's
    edges, then hole 1's, ...), so per-segment BC data attaches uniformly.
    The interior mask keeps only hats whose support avoids every hole, via
    the same 3x3 probe stencil as the outer boundary — so a hole must be
    RESOLVED by the mesh (diameter >~ h); a hole much smaller than one
    element can slip between probes.
    """

    dim = 2

    def __init__(self, vertices: np.ndarray, holes=()):
        vertices = np.asarray(vertices, dtype=np.float64)
        if vertices.ndim != 2 or vertices.shape[1] != 2 or vertices.shape[0] < 3:
            raise ValueError("vertices must be [V>=3, 2]")
        self.vertices = vertices
        self.holes = []
        lo, hi = vertices.min(axis=0), vertices.max(axis=0)
        eps = 1e-12 * float(max(hi - lo))
        for h in holes:
            h = np.asarray(h, dtype=np.float64)
            if h.ndim != 2 or h.shape[1] != 2 or h.shape[0] < 3:
                raise ValueError("each hole must be [V>=3, 2]")
            if not _raycast(vertices, h).all():
                raise ValueError("hole vertices must lie inside the outer "
                                 "polygon")
            # Vertex containment alone misses edges that leave a NON-CONVEX
            # outer ring (e.g. a hole spanning the cut-out of an L-shape):
            # require no edge contact with the outer ring or earlier holes,
            # and no mutual vertex containment (together: strictly inside,
            # mutually disjoint — exact for simple polygons).
            if _rings_cross(vertices, h, eps):
                raise ValueError("hole edges must stay strictly inside the "
                                 "outer polygon (an edge touches or crosses "
                                 "the outer boundary)")
            for g in self.holes:
                if (_raycast(g, h).any() or _raycast(h, g).any()
                        or _rings_cross(g, h, eps)):
                    raise ValueError("holes must be mutually disjoint")
            self.holes.append(h)

    @property
    def bounds(self):
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    @property
    def n_boundary_segments(self) -> int:
        return self.vertices.shape[0] + sum(h.shape[0] for h in self.holes)

    def segment_endpoints(self) -> np.ndarray:
        """[S, 2, 2] endpoint pairs of every boundary segment, in segment
        order (outer edges, then each hole's edges)."""
        rings = [self.vertices] + self.holes
        return np.stack([
            np.stack([v[i], v[(i + 1) % v.shape[0]]])
            for v in rings for i in range(v.shape[0])
        ])

    def in_domain(self, pts: np.ndarray) -> np.ndarray:
        """Inside the outer polygon and outside every hole.

        Points on an edge are classified by the half-open edge convention;
        mesh interiors additionally require a margin via the support check,
        so edge ambiguity is harmless.
        """
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
        inside = _raycast(self.vertices, pts)
        for h in self.holes:
            inside &= ~_raycast(h, pts)
        return inside

    def mesh(self, disc_num) -> Mesh:
        """Uniform bounding-box grid; interior mask keeps nodes whose full
        hat support lies inside the polygon.

        disc_num: int (elements per dim) or pair (nx_elems, ny_elems).
        """
        if np.isscalar(disc_num):
            counts = (int(disc_num) + 1, int(disc_num) + 1)
        else:
            counts = tuple(int(d) + 1 for d in disc_num)
        lo, hi = self.bounds
        nodes, _, spacing = cartesian_grid(lo, hi, counts)
        interior = self._support_inside(nodes, spacing)
        return Mesh(nodes=nodes, shape=counts, spacing=spacing, interior_mask=interior)

    def support_inside(self, centers: np.ndarray, half) -> np.ndarray:
        """Public support-box check with arbitrary per-dim half-widths
        (order-2 assembly: vertex classes use h, bubble classes h/2)."""
        return self._support_inside(
            np.atleast_2d(centers), np.atleast_1d(np.asarray(half, float))
        )

    def _support_inside(self, nodes: np.ndarray, h: np.ndarray) -> np.ndarray:
        """True where node and all 8 support-patch sample points are inside.

        Checks the 3x3 stencil {node + (i*h_x, j*h_y), i,j in {-1,0,1}}.
        This keeps only hats whose support box is (up to sampling) inside
        the polygon — the conservative choice that keeps the uniform
        quadrature tables exact; coverage near the boundary is provided by
        the BC penalty points (SURVEY.md §7 "hard parts" item 3).
        """
        # The support may TOUCH the boundary (the hat vanishes there, which
        # is the standard FEM interior basis), so probes are shrunk slightly
        # inward to avoid excluding nodes exactly one spacing from an edge.
        shrink = 1.0 - 1e-9
        ok = np.ones(nodes.shape[0], dtype=bool)
        for di in (-1.0, 0.0, 1.0):
            for dj in (-1.0, 0.0, 1.0):
                probe = nodes + shrink * np.array([di * h[0], dj * h[1]])
                ok &= self.in_domain(probe)
        return ok

    def boundary_points(self, b_disc_num: int = 10) -> List[np.ndarray]:
        """Per-edge uniform boundary points, HALF-OPEN: each edge owns its
        start vertex and excludes its end vertex, so every polygon corner
        appears in exactly ONE segment's point set.  (Closed edges would
        double-weight corners in the BC MSE and silently average conflicting
        per-segment g values at a discontinuity.)

        Returns a list of [b_disc_num, 2] arrays, one per edge, in segment
        order (outer edges, then each hole's) so per-segment BC callables
        line up; a corner's Dirichlet value comes from the edge STARTING
        at it.
        """
        n = int(b_disc_num)
        pts = []
        for v in [self.vertices] + self.holes:
            for i in range(v.shape[0]):
                a, b = v[i], v[(i + 1) % v.shape[0]]
                t = np.linspace(0.0, 1.0, n + 1)[:-1, None]
                pts.append(a[None, :] * (1 - t) + b[None, :] * t)
        return pts

    def _ring_of(self, seg: int):
        """(ring vertices, local edge index, is_hole) for segment ``seg``."""
        if seg < self.vertices.shape[0]:
            return self.vertices, seg, False
        s = seg - self.vertices.shape[0]
        for h in self.holes:
            if s < h.shape[0]:
                return h, s, True
            s -= h.shape[0]
        raise IndexError(f"segment {seg} out of range")

    def segment_normal(self, seg: int) -> np.ndarray:
        """DOMAIN-outward unit normal of edge ``seg``, orientation-aware
        via the owning ring's signed area (Neumann BCs).  On a hole edge
        the domain-outward direction points INTO the hole, i.e. it is the
        hole polygon's inward-flipped normal."""
        v, i, is_hole = self._ring_of(seg)
        a, b = v[i], v[(i + 1) % v.shape[0]]
        d = b - a
        n = np.array([d[1], -d[0]])  # right-hand normal (outward for CCW)
        x1, y1 = v[:, 0], v[:, 1]
        x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
        signed_area = 0.5 * np.sum(x1 * y2 - x2 * y1)
        if signed_area < 0:  # clockwise vertex order: flip
            n = -n
        if is_hole:  # polygon-outward = into the domain: flip again
            n = -n
        return n / np.linalg.norm(n)

    def grid_in_domain(self, counts) -> Tuple[np.ndarray, np.ndarray]:
        """Uniform evaluation grid masked to the polygon (for viz/eval)."""
        lo, hi = self.bounds
        nodes, _, _ = cartesian_grid(lo, hi, counts)
        return nodes, self.in_domain(nodes)


def _box_in_domain(lo, hi, pts) -> np.ndarray:
    """Strict interior test for an axis-aligned box."""
    pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
    return np.all((pts > lo) & (pts < hi), axis=1)


def _box_support_inside(lo, hi, nodes, h) -> np.ndarray:
    """True where node +/- h lies inside the box, with a relative eps so
    supports that exactly TOUCH a face (test fn vanishes there) pass."""
    eps = 1e-12 * np.maximum(np.abs(hi - lo), 1.0)
    return np.all(
        (nodes - h >= lo - eps) & (nodes + h <= hi + eps), axis=1
    )


class BoxDomainND:
    """Axis-aligned box in any spatial dimension (beyond-reference: the
    reference geometry layer stops at 2-D — SURVEY.md §2.1 #4; every other
    layer here is dimension-generic, so a box domain is all 3-D needs).

    Boundary segments are the 2*dim faces, ordered (x_lo, x_hi, y_lo,
    y_hi, ...), so per-face Dirichlet data attaches like per-edge data in
    2-D.  Face points are CELL-CENTRED in the transverse dims (offset
    half a spacing from face edges): no point lies on a face edge, so no
    point is shared between faces — the half-open corner-ownership
    bookkeeping the 2-D polygon needs does not arise.
    """

    def __init__(self, lo, hi):
        lo = np.atleast_1d(np.asarray(lo, dtype=np.float64))
        hi = np.atleast_1d(np.asarray(hi, dtype=np.float64))
        if lo.shape != hi.shape or lo.ndim != 1:
            raise ValueError("lo and hi must be 1-D of equal length")
        if not np.all(hi > lo):
            raise ValueError("BoxDomainND requires hi > lo per dim")
        self.lo = lo
        self.hi = hi
        self.dim = int(lo.shape[0])

    @property
    def bounds(self):
        return self.lo.copy(), self.hi.copy()

    @property
    def n_boundary_segments(self) -> int:
        return 2 * self.dim

    def in_domain(self, pts: np.ndarray) -> np.ndarray:
        return _box_in_domain(self.lo, self.hi, pts)

    def support_inside(self, centers: np.ndarray, half) -> np.ndarray:
        """True where the support box centre +/- half lies inside (it may
        touch the faces: the test function vanishes there)."""
        c = np.atleast_2d(np.asarray(centers, dtype=np.float64))
        h = np.broadcast_to(
            np.atleast_1d(np.asarray(half, dtype=np.float64)), (self.dim,)
        )
        return _box_support_inside(self.lo, self.hi, c, h)

    def mesh(self, disc_num) -> Mesh:
        """Uniform grid; interior mask keeps nodes one spacing from every
        face.  disc_num: int (elements per dim) or per-dim sequence."""
        if np.isscalar(disc_num):
            counts = (int(disc_num) + 1,) * self.dim
        else:
            counts = tuple(int(d) + 1 for d in disc_num)
        nodes, _, spacing = cartesian_grid(self.lo, self.hi, counts)
        interior = self.support_inside(nodes, spacing)
        return Mesh(nodes=nodes, shape=counts, spacing=spacing,
                    interior_mask=interior)

    def boundary_points(self, b_disc_num: int = 8) -> List[np.ndarray]:
        """Per-face cell-centred grids: face (j, side) gets
        b_disc_num^(dim-1) points with the j-th coordinate pinned to the
        face and every transverse coordinate at (i + 1/2)/b_disc_num of
        its range."""
        n = int(b_disc_num)
        t = (np.arange(n) + 0.5) / n
        pts = []
        for j in range(self.dim):
            axes = [
                self.lo[k] + t * (self.hi[k] - self.lo[k])
                for k in range(self.dim) if k != j
            ]
            if axes:
                grids = np.meshgrid(*axes, indexing="ij")
                trans = np.stack([g.ravel() for g in grids], axis=-1)
            else:
                trans = np.zeros((1, 0))
            for side in (self.lo[j], self.hi[j]):
                face = np.empty((trans.shape[0], self.dim))
                face[:, j] = side
                face[:, [k for k in range(self.dim) if k != j]] = trans
                pts.append(face)
        return pts

    def segment_normal(self, seg: int) -> np.ndarray:
        """Outward unit normal of face ``seg`` (order x_lo, x_hi, y_lo,
        ...): face 2j+s has normal (-1)^(1-s) e_j (Neumann BCs)."""
        n = np.zeros(self.dim)
        n[seg // 2] = -1.0 if seg % 2 == 0 else 1.0
        return n

    def grid_in_domain(self, counts) -> Tuple[np.ndarray, np.ndarray]:
        """Uniform evaluation grid with an all-true mask (for eval)."""
        if np.isscalar(counts):
            counts = (int(counts),) * self.dim
        else:
            counts = tuple(int(c) for c in counts)
        nodes, _, _ = cartesian_grid(self.lo, self.hi, counts)
        return nodes, np.ones(nodes.shape[0], dtype=bool)


class BoxDomain3D(BoxDomainND):
    """3-D axis-aligned box: faces ordered x_lo, x_hi, y_lo, y_hi, z_lo,
    z_hi."""

    def __init__(self, lo=(0.0, 0.0, 0.0), hi=(1.0, 1.0, 1.0)):
        super().__init__(lo, hi)
        if self.dim != 3:
            raise ValueError("BoxDomain3D requires 3 coordinates")


class PrismDomain3D:
    """Extruded-polygon 3-D domain: a ``PolygonDomain2D`` cross-section
    (convex or NOT — e.g. an L-shaped duct) swept along z over
    [z_lo, z_hi].  Beyond-reference: the reference geometry layer stops at
    2-D polygons (SURVEY.md §2.1 #4); this extends its non-convex story to
    3-D, complementing the axis-aligned ``BoxDomainND``.

    Boundary segments, in order:
      0 .. V-1 : the V side walls (polygon edge i x [z_lo, z_hi]); per-wall
                 Dirichlet data attaches like per-edge data in 2-D.
      V        : the bottom cap (z = z_lo)
      V + 1    : the top cap  (z = z_hi)
    Wall points reuse the polygon's HALF-OPEN edge convention in xy (each
    wall owns its starting vertical edge) and are cell-centred in z; cap
    points are cell-centred in xy and masked to the polygon interior — so
    no boundary point is shared between segments, the same no-double-count
    invariant the 2-D polygon and the ND box maintain.
    """

    dim = 3

    def __init__(self, vertices: np.ndarray, z_lo: float = 0.0,
                 z_hi: float = 1.0, holes=()):
        self.poly = PolygonDomain2D(vertices, holes=holes)
        if not float(z_hi) > float(z_lo):
            raise ValueError("PrismDomain3D requires z_hi > z_lo")
        self.z_lo = float(z_lo)
        self.z_hi = float(z_hi)

    @property
    def vertices(self) -> np.ndarray:
        return self.poly.vertices

    @property
    def holes(self):
        return self.poly.holes

    @property
    def bounds(self):
        lo, hi = self.poly.bounds
        return (np.concatenate([lo, [self.z_lo]]),
                np.concatenate([hi, [self.z_hi]]))

    @property
    def n_boundary_segments(self) -> int:
        return self.poly.n_boundary_segments + 2

    def in_domain(self, pts: np.ndarray) -> np.ndarray:
        pts = np.atleast_2d(np.asarray(pts, dtype=np.float64))
        return (self.poly.in_domain(pts[:, :2])
                & (pts[:, 2] > self.z_lo) & (pts[:, 2] < self.z_hi))

    def support_inside(self, centers: np.ndarray, half) -> np.ndarray:
        """Support box centre +/- half inside the prism: the xy footprint
        passes the polygon's stencil check, the z extent stays within the
        slab (it may touch the caps: the test function vanishes there)."""
        c = np.atleast_2d(np.asarray(centers, dtype=np.float64))
        h = np.broadcast_to(np.atleast_1d(np.asarray(half, float)), (3,))
        eps = 1e-12 * max(self.z_hi - self.z_lo, 1.0)
        z_ok = ((c[:, 2] - h[2] >= self.z_lo - eps)
                & (c[:, 2] + h[2] <= self.z_hi + eps))
        return self.poly.support_inside(c[:, :2], h[:2]) & z_ok

    def mesh(self, disc_num) -> Mesh:
        """Uniform bounding-box grid; interior mask keeps nodes whose full
        hat support lies inside the prism.  disc_num: int or per-dim
        (nx, ny, nz) element counts."""
        if np.isscalar(disc_num):
            counts = (int(disc_num) + 1,) * 3
        else:
            counts = tuple(int(d) + 1 for d in disc_num)
        lo, hi = self.bounds
        nodes, _, spacing = cartesian_grid(lo, hi, counts)
        interior = self.support_inside(nodes, spacing)
        return Mesh(nodes=nodes, shape=counts, spacing=spacing,
                    interior_mask=interior)

    def boundary_points(self, b_disc_num: int = 8) -> List[np.ndarray]:
        n = int(b_disc_num)
        tz = self.z_lo + (np.arange(n) + 0.5) / n * (self.z_hi - self.z_lo)
        pts: List[np.ndarray] = []
        for edge in self.poly.boundary_points(n):
            wall = np.concatenate(
                [np.repeat(edge, n, axis=0),
                 np.tile(tz, edge.shape[0])[:, None]], axis=1)
            pts.append(wall)
        lo, hi = self.poly.bounds
        t = (np.arange(n) + 0.5) / n
        gx, gy = np.meshgrid(lo[0] + t * (hi[0] - lo[0]),
                             lo[1] + t * (hi[1] - lo[1]), indexing="ij")
        xy = np.stack([gx.ravel(), gy.ravel()], axis=-1)
        xy = xy[self.poly.in_domain(xy)]
        for z in (self.z_lo, self.z_hi):
            cap = np.concatenate(
                [xy, np.full((xy.shape[0], 1), z)], axis=1)
            pts.append(cap)
        return pts

    def segment_normal(self, seg: int) -> np.ndarray:
        """Walls inherit the polygon edge normal (z-component 0); the caps
        are -e_z / +e_z (Neumann BCs)."""
        nv = self.poly.n_boundary_segments
        if seg < nv:
            return np.concatenate([self.poly.segment_normal(seg), [0.0]])
        return np.array([0.0, 0.0, -1.0 if seg == nv else 1.0])

    def grid_in_domain(self, counts) -> Tuple[np.ndarray, np.ndarray]:
        """Uniform evaluation grid over the bounding box, masked to the
        polygon footprint (z spans the slab exactly, like the ND box)."""
        if np.isscalar(counts):
            counts = (int(counts),) * 3
        else:
            counts = tuple(int(c) for c in counts)
        lo, hi = self.bounds
        nodes, _, _ = cartesian_grid(lo, hi, counts)
        return nodes, self.poly.in_domain(nodes[:, :2])


class RectangleDomain2D(PolygonDomain2D):
    """Axis-aligned rectangle convenience domain, optionally with holes.

    Outer segments are ordered bottom, right, top, left (counter-clockwise
    from (x_lo, y_lo)); hole edges continue the numbering from 4.
    """

    def __init__(self, lo=(0.0, 0.0), hi=(1.0, 1.0), holes=()):
        lo = np.asarray(lo, dtype=np.float64)
        hi = np.asarray(hi, dtype=np.float64)
        if not np.all(hi > lo):
            raise ValueError("RectangleDomain2D requires hi > lo per dim")
        super().__init__(
            np.array(
                [
                    [lo[0], lo[1]],
                    [hi[0], lo[1]],
                    [hi[0], hi[1]],
                    [lo[0], hi[1]],
                ]
            ),
            holes=holes,
        )

    def in_domain(self, pts: np.ndarray) -> np.ndarray:
        lo, hi = self.bounds
        ins = _box_in_domain(lo, hi, pts)
        for h in self.holes:
            pts2 = np.atleast_2d(np.asarray(pts, dtype=np.float64))
            ins &= ~_raycast(h, pts2)
        return ins

    def _support_inside(self, nodes, h):
        lo, hi = self.bounds
        ok = _box_support_inside(lo, hi, nodes, h)
        if self.holes:
            # probe-stencil check for the holes (the box factor above is
            # exact; PolygonDomain2D's stencil uses the hole-aware
            # in_domain, so the conjunction trims around every hole)
            ok &= PolygonDomain2D._support_inside(self, nodes, h)
        return ok
