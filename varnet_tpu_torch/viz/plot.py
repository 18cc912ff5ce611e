"""Solution visualization (a copy of ``varnet_tpu/viz/plot.py``).

The reference's plotting layer (``ContourPlot.py`` class ``ContourPlot`` + the
plotting side of ``VarNet.simRes`` -- SURVEY.md §2.1 #6, §3.3): meshgrid over
the domain's bounding box masked by ``in_domain``, contour plots of 2-D fields,
time-snapshot series and animation, 1-D line plots, and training-history
curves.  All host-side matplotlib; the network is evaluated through the port's
``VarNet.evaluate``.  matplotlib is imported here only, and ``VarNet.sim_res``
imports this module lazily, so the rest of the package runs without it.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


class ContourPlot:
    """2-D contour plotting over a (possibly non-convex) domain.

    Mirrors the reference surface ``ContourPlot(domain).conPlot/anim``
    (SURVEY.md §1 table).
    """

    def __init__(self, domain, disc: int = 64):
        if domain.dim != 2:
            raise ValueError("ContourPlot requires a 2-D domain")
        self.domain = domain
        self.disc = int(disc)
        lo, hi = domain.bounds
        self.xg = np.linspace(lo[0], hi[0], self.disc + 1)
        self.yg = np.linspace(lo[1], hi[1], self.disc + 1)
        xx, yy = np.meshgrid(self.xg, self.yg, indexing="ij")
        self.points = np.stack([xx.ravel(), yy.ravel()], axis=-1)
        self.mask = domain.in_domain(self.points)

    def _field(self, values: np.ndarray) -> np.ndarray:
        z = np.full(self.points.shape[0], np.nan)
        z[self.mask] = np.asarray(values, dtype=np.float64)[self.mask]
        return z.reshape(len(self.xg), len(self.yg))

    def con_plot(
        self,
        values: np.ndarray,
        title: str = "",
        path: Optional[str] = None,
        levels: int = 30,
    ):
        """Filled contour of values given at ``self.points`` (masked)."""
        z = self._field(values)
        fig, ax = plt.subplots(figsize=(6, 5))
        cs = ax.contourf(self.xg, self.yg, z.T, levels=levels, cmap="viridis")
        fig.colorbar(cs, ax=ax)
        ax.set_title(title)
        ax.set_xlabel("x")
        ax.set_ylabel("y")
        if path:
            fig.savefig(path, dpi=120, bbox_inches="tight")
            plt.close(fig)
            return path
        return fig

    def snapshots(
        self,
        eval_fn,
        times: Sequence[float],
        folder: str,
        prefix: str = "sol",
    ) -> List[str]:
        """One contour per time (reference time-snapshot series)."""
        os.makedirs(folder, exist_ok=True)
        paths = []
        for tv in times:
            vals = eval_fn(self.points, tv)
            p = os.path.join(folder, f"{prefix}_t{tv:.4f}.png")
            self.con_plot(vals, title=f"t = {tv:.4f}", path=p)
            paths.append(p)
        return paths

    def anim(
        self,
        eval_fn,
        times: Sequence[float],
        path: str,
        fps: int = 4,
    ) -> str:
        """GIF animation over time (reference ``ContourPlot.anim``)."""
        from matplotlib.animation import FuncAnimation, PillowWriter

        frames = [self._field(eval_fn(self.points, tv)) for tv in times]
        vmin = np.nanmin([np.nanmin(f) for f in frames])
        vmax = np.nanmax([np.nanmax(f) for f in frames])
        fig, ax = plt.subplots(figsize=(6, 5))

        def draw(i):
            ax.clear()
            ax.contourf(
                self.xg, self.yg, frames[i].T, levels=30,
                cmap="viridis", vmin=vmin, vmax=vmax,
            )
            ax.set_title(f"t = {times[i]:.4f}")
            return []

        ani = FuncAnimation(fig, draw, frames=len(frames))
        ani.save(path, writer=PillowWriter(fps=fps))
        plt.close(fig)
        return path


def plot_domain(domain, path: Optional[str] = None, disc: int = 40):
    """Domain geometry plot: boundary segments + interior mesh nodes
    (reference ``Domain`` plotting — SURVEY.md §2.1 #4)."""
    fig, ax = plt.subplots(figsize=(6, 5))
    if domain.dim == 1:
        lo, hi = domain.bounds
        ax.plot([lo[0], hi[0]], [0, 0], "k-", lw=2)
        ax.plot([lo[0], hi[0]], [0, 0], "rs")
        ax.set_yticks([])
    else:
        # A prism (extruded polygon) is drawn as its xy FOOTPRINT: wall
        # segment i is footprint edge i (hole walls included), the two
        # caps are noted in the title.  Scattering the 3-D interior nodes
        # directly would overplot every z-layer into one blob.
        poly = getattr(domain, "poly", None)
        foot = poly if (domain.dim == 3 and poly is not None) else domain
        seg = 0
        rings = [foot.vertices] + list(getattr(foot, "holes", []))
        for v in rings:
            closed = np.vstack([v, v[:1]])
            ax.plot(closed[:, 0], closed[:, 1], "k-", lw=2)
            for i in range(v.shape[0]):
                mid = (v[i] + v[(i + 1) % v.shape[0]]) / 2
                ax.annotate(f"seg {seg}", mid, fontsize=8, color="tab:red")
                seg += 1
        mesh = foot.mesh(disc)
        pts = mesh.interior_nodes
        ax.plot(pts[:, 0], pts[:, 1], ".", ms=2, color="tab:blue")
        ax.set_aspect("equal")
    if domain.dim == 3:
        ax.set_title(f"domain footprint (caps: segs {seg}, {seg + 1})")
    else:
        ax.set_title("domain")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def plot_line_1d(
    x: np.ndarray,
    series: dict,
    title: str = "",
    path: Optional[str] = None,
):
    """1-D solution line plot; ``series`` maps label -> values."""
    fig, ax = plt.subplots(figsize=(6, 4))
    for label, v in series.items():
        style = "--" if "exact" in label.lower() else "-"
        ax.plot(np.asarray(x).ravel(), np.asarray(v).ravel(), style, label=label)
    ax.set_title(title)
    ax.set_xlabel("x")
    ax.set_ylabel("u")
    ax.legend()
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def plot_history(result, path: Optional[str] = None):
    """Loss / error curves (reference ``TrainResult`` loss plots)."""
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    ep = result.epochs
    for key in result.losses[0].keys():
        axes[0].semilogy(ep, [l[key] for l in result.losses], label=key)
    axes[0].set_xlabel("epoch")
    axes[0].set_title("loss terms")
    axes[0].legend()
    errs = [e for e in result.errors if np.isfinite(e)]
    if errs:
        axes[1].semilogy(ep[: len(result.errors)], result.errors)
        axes[1].set_xlabel("epoch")
        axes[1].set_title("rel-L2 error vs exact")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def plot_fields(pde, folderpath: str, disc: int = 64, t: float = 0.0):
    """Render the PDE input fields kappa, v, s over the domain (reference
    ``ADPDE`` input-field plotting — SURVEY.md §2.1 #3)."""
    os.makedirs(folderpath, exist_ok=True)
    td = pde.time_dependent
    out: List[str] = []
    if pde.dim == 1:
        lo, hi = pde.domain.bounds
        x = np.linspace(float(lo[0]), float(hi[0]), disc + 1)[:, None]
        tcol = np.full(x.shape[0], t) if td else None
        series = {
            "kappa": pde.eval_diff(x, tcol),
            "velocity": pde.eval_vel(x, tcol)[:, 0],
            "source": pde.eval_source(x, tcol),
        }
        for name, v in series.items():
            p = os.path.join(folderpath, f"field_{name}.png")
            plot_line_1d(x, {name: v}, title=name, path=p)
            out.append(p)
        return out
    if pde.dim == 3:
        def field_fn(name):
            if name == "kappa":
                return lambda pts: pde.eval_diff(
                    pts, np.full(pts.shape[0], t) if td else None)
            if name == "source":
                return lambda pts: pde.eval_source(
                    pts, np.full(pts.shape[0], t) if td else None)
            j = {"vel_x": 0, "vel_y": 1, "vel_z": 2}[name]
            return lambda pts: pde.eval_vel(
                pts, np.full(pts.shape[0], t) if td else None)[:, j]

        for name in ("kappa", "vel_x", "vel_y", "vel_z", "source"):
            out += plot_slices_3d(pde.domain, field_fn(name), folderpath,
                                  disc=min(disc, 48), fracs=(0.5,),
                                  prefix=f"field_{name}")
        return out
    if pde.dim > 3:
        raise ValueError(f"plot_fields supports dim <= 3 (got {pde.dim})")
    cp = ContourPlot(pde.domain, disc=disc)
    tcol = np.full(cp.points.shape[0], t) if td else None
    vel = pde.eval_vel(cp.points, tcol)
    fields = {
        "kappa": pde.eval_diff(cp.points, tcol),
        "vel_x": vel[:, 0],
        "vel_y": vel[:, 1],
        "source": pde.eval_source(cp.points, tcol),
    }
    for name, v in fields.items():
        p = os.path.join(folderpath, f"field_{name}.png")
        cp.con_plot(v, title=name + (f" (t={t})" if td else ""), path=p)
        out.append(p)
    return out


def plot_slices_3d(domain, eval_fn, folderpath: str, disc: int = 48,
                   axis: int = 2, fracs=(0.25, 0.5, 0.75),
                   prefix: str = "sol_slice"):
    """Planar contour slices of a 3-D field: for each fraction f, a filled
    contour of ``eval_fn(points)`` on the plane where the ``axis``-th
    coordinate is lo + f (hi - lo).  The 3-D analogue of the 2-D
    ContourPlot surface (beyond-reference: the reference viz stops at
    2-D, SURVEY.md §2.1 #6)."""
    lo, hi = domain.bounds
    j, k = [a for a in range(3) if a != axis]
    u = np.linspace(lo[j], hi[j], disc + 1)
    v = np.linspace(lo[k], hi[k], disc + 1)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    out = []
    for f in fracs:
        s = lo[axis] + f * (hi[axis] - lo[axis])
        pts = np.empty((uu.size, 3))
        pts[:, j], pts[:, k], pts[:, axis] = uu.ravel(), vv.ravel(), s
        vals = np.asarray(eval_fn(pts)).reshape(uu.shape)
        fig, ax = plt.subplots(figsize=(5, 4))
        m = ax.contourf(uu, vv, vals, levels=30)
        fig.colorbar(m, ax=ax)
        ax.set_xlabel(f"x{j}")
        ax.set_ylabel(f"x{k}")
        ax.set_title(f"x{axis} = {s:.3f}")
        p = os.path.join(folderpath, f"{prefix}_x{axis}_{f:.2f}.png")
        fig.savefig(p, dpi=110, bbox_inches="tight")
        plt.close(fig)
        out.append(p)
    return out


def plot_solution(vn, folderpath: str, disc: int = 64, n_times: int = 5):
    """Render the trained solution into the case folder (the body of
    ``VarNet.sim_res`` — reference ``VarNet.simRes``, SURVEY.md §3.3).

    1-D steady: line plot (with exact overlay when available).
    1-D transient: one line plot per time snapshot.
    2-D steady: contour (+ exact + pointwise-error contours if c_ex).
    2-D transient: contour snapshot series + GIF animation.
    Always: training-history curves when the model has been trained.
    """
    os.makedirs(folderpath, exist_ok=True)
    pde = vn.pde
    td = vn.static.time_dependent
    out: List[str] = []

    if pde.dim == 1:
        x = np.linspace(*map(float, np.concatenate(pde.domain.bounds)), disc + 1)[
            :, None
        ]
        if td:
            t0, t1 = pde.t_interval
            for tv in np.linspace(t0, t1, n_times):
                series = {"u_theta": vn.evaluate(x, tv)}
                if pde.c_ex is not None:
                    series["exact"] = pde.eval_exact(x, np.full(x.shape[0], tv))
                p = os.path.join(folderpath, f"sol_t{tv:.4f}.png")
                plot_line_1d(x, series, title=f"t = {tv:.4f}", path=p)
                out.append(p)
        else:
            series = {"u_theta": vn.evaluate(x)}
            if pde.c_ex is not None:
                series["exact"] = pde.eval_exact(x)
            p = os.path.join(folderpath, "sol.png")
            plot_line_1d(x, series, title="steady solution", path=p)
            out.append(p)
    elif pde.dim == 3:
        t_last = pde.t_interval[1] if td else None

        def ev(pts):
            return vn.evaluate(pts, t_last) if td else vn.evaluate(pts)

        out += plot_slices_3d(pde.domain, ev, folderpath, disc=min(disc, 48))
        if pde.c_ex is not None:

            def err(pts):
                ex = (pde.eval_exact(pts, np.full(pts.shape[0], t_last))
                      if td else pde.eval_exact(pts))
                return np.abs(ev(pts) - ex)

            out += plot_slices_3d(pde.domain, err, folderpath,
                                  disc=min(disc, 48), prefix="abs_err_slice")
    elif pde.dim > 3:
        raise ValueError(
            f"plot_solution supports dim <= 3 (got {pde.dim}); training "
            "and error evaluation are dimension-generic, plots are not"
        )
    else:
        cp = ContourPlot(pde.domain, disc=disc)
        if td:
            t0, t1 = pde.t_interval
            times = np.linspace(t0, t1, n_times)
            out += cp.snapshots(
                lambda pts, tv: vn.evaluate(pts, tv), times, folderpath
            )
            out.append(
                cp.anim(
                    lambda pts, tv: vn.evaluate(pts, tv),
                    times,
                    os.path.join(folderpath, "sol_anim.gif"),
                )
            )
            if pde.c_ex is not None:
                out += cp.snapshots(
                    lambda pts, tv: np.abs(
                        vn.evaluate(pts, tv)
                        - pde.eval_exact(pts, np.full(pts.shape[0], tv))
                    ),
                    times,
                    folderpath,
                    prefix="abs_err",
                )
        else:
            p = os.path.join(folderpath, "sol.png")
            cp.con_plot(vn.evaluate(cp.points), title="steady solution", path=p)
            out.append(p)
            if pde.c_ex is not None:
                exact = pde.eval_exact(cp.points)
                p2 = os.path.join(folderpath, "sol_exact.png")
                cp.con_plot(exact, title="exact solution", path=p2)
                p3 = os.path.join(folderpath, "sol_abs_err.png")
                cp.con_plot(
                    np.abs(vn.evaluate(cp.points) - exact),
                    title="|u_theta - exact|",
                    path=p3,
                )
                out += [p2, p3]

    if vn.train_result is not None and vn.train_result.losses:
        p = os.path.join(folderpath, "history.png")
        plot_history(vn.train_result, path=p)
        out.append(p)

    # Per-time error table vs exact solution (reference error reports).
    if pde.c_ex is not None:
        import json

        table = {}
        if td:
            t0, t1 = pde.t_interval
            for tv in np.linspace(t0, t1, n_times):
                pts, mask = pde.domain.grid_in_domain(
                    (disc + 1,) * pde.dim if pde.dim > 1 else disc + 1
                )
                pts = pts[mask]
                pred = vn.evaluate(pts, tv)
                exact = pde.eval_exact(pts, np.full(pts.shape[0], tv))
                from ..utils.helpers import rel_l2_error

                table[f"{tv:.4f}"] = rel_l2_error(pred, exact)
        table["overall"] = vn.compute_error(disc=disc, n_times=n_times)
        p = os.path.join(folderpath, "error_table.json")
        with open(p, "w") as f:
            json.dump(table, f, indent=2)
        out.append(p)
    return out
