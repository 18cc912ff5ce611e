"""The port's CN-FDM solver (``varnet_tpu_torch/problems/classical.py``, a copy of
the reference's ``varnet_tpu/problems/classical.py``) against the reference on
small grids: the same problem built from each package's geometry and problem
classes gives bit-equal nodes, sample times and fields, on the all-Dirichlet
flagship problem, with a rectangular hole, with Neumann and Robin flux edges and
with a free outflow edge; and the solver's refusals carry the same messages."""

import numpy as np
import pytest

import varnet_tpu.geometry.domain as jax_domain
import varnet_tpu.problems.adpde as jax_adpde
from varnet_tpu.problems.analytic import transient_ad_2d as jax_transient_ad_2d
from varnet_tpu.problems.classical import solve_ad_fdm_2d as jax_solve
import varnet_tpu_torch.geometry.domain as domain
import varnet_tpu_torch.problems.adpde as adpde
from varnet_tpu_torch.problems import solve_ad_fdm_2d
from varnet_tpu_torch.problems.analytic import transient_ad_2d

HOLE = np.array([[0.75, 0.25], [1.25, 0.25], [1.25, 0.75], [0.75, 0.75]])


def _inlet(x, t):
    return np.sin(np.pi * x[:, 1]) * (1.0 - np.exp(-4.0 * np.asarray(t)))


def _source(x, t):
    return np.exp(-20.0 * ((x[:, 0] - 0.6) ** 2 + (x[:, 1] - 0.4) ** 2)) * np.cos(
        2.0 * np.asarray(t))


def _flux(x, t):
    return 0.2 * x[:, 0] * np.exp(-np.asarray(t))


def _problem(name, dom, pde_mod):
    """One of the cases, from a package's domain and problem modules."""
    rect = dom.RectangleDomain2D
    kw = dict(diff=0.05, vel=np.array([0.4, 0.1]), source=_source, t_interval=(0.0, 0.5),
              ic=0.0)
    if name == "hole":
        return pde_mod.ADPDE(rect((0.0, 0.0), (2.0, 1.0), holes=[HOLE]),
                             bcs=[0.0, 0.0, 0.0, _inlet] + [lambda x, t: 1.0 + 0.0 * x[:, 0]] * 4,
                             **kw)
    walls = {"neumann": [pde_mod.NeumannBC(_flux), 0.0, pde_mod.NeumannBC(0.0), _inlet],
             "robin": [pde_mod.RobinBC(alpha=1.5, flux=0.5), 0.0, 0.0, _inlet],
             "outflow": [0.0, None, 0.0, _inlet]}[name]
    return pde_mod.ADPDE(rect((0.0, 0.0), (1.0, 1.0)), bcs=walls, **kw)


GRID = dict(nx=12, ny=8, nt=10, sample_times=np.linspace(0.0, 0.5, 4))


def _equal(ours, ref):
    assert set(ours) == set(ref)
    for key in ref:
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


def test_flagship_problem_bit_equal():
    _equal(solve_ad_fdm_2d(transient_ad_2d()["pde"], **GRID),
           jax_solve(jax_transient_ad_2d()["pde"], **GRID))


@pytest.mark.parametrize("name", ["hole", "neumann", "robin", "outflow"])
def test_boundary_cases_bit_equal(name):
    grid = dict(GRID, nx=16) if name == "hole" else GRID
    ours = solve_ad_fdm_2d(_problem(name, domain, adpde), **grid)
    ref = jax_solve(_problem(name, jax_domain, jax_adpde), **grid)
    _equal(ours, ref)
    assert np.all(np.isfinite(ours["u"])) and np.abs(ours["u"][-1]).max() > 0.0


def test_refusals_match():
    steady = adpde.ADPDE(domain.RectangleDomain2D(), diff=0.1, vel=np.zeros(2), source=0.0,
                         bcs=[0.0] * 4)
    with pytest.raises(ValueError, match="pde must be time-dependent"):
        solve_ad_fdm_2d(steady)
    bad = _problem("hole", domain, adpde)
    bad.bcs[4] = None
    with pytest.raises(ValueError, match="must carry Dirichlet data"):
        solve_ad_fdm_2d(bad, **dict(GRID, nx=16))
