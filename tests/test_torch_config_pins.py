"""The port re-scores the remaining pinned thetas the JAX package's tests hold
(``tests/test_accuracy_pin.py``, ``tests/test_classical.py``) on the CPU, under
the same bounds and within rtol 1e-3 of the JAX package's own re-score of the
same theta on the same points:

* the five per-config thetas (``benchmarks/per_config_accuracy.CONFIGS``), the
  3-D steady d16 theta and the three flagship waypoints 5.4e-4 / 1.3e-4 /
  1.1e-4, at reduced evaluation grids (the pinned error is a property of the
  theta; the grid only samples it);
* the contaminant thetas against the shipped CN-FDM fields (t > 0 rows): the
  causal hard-BC net against ``contaminant_fdm.npz``, the inlet, inlet-hard,
  source-FF and FF-hard nets against the ``*_fdm.csv`` files read through the
  port's ``load_observations_csv``.  A Fourier-feature net needs B as the JAX
  package draws it, which a ``torch.Generator`` cannot reproduce: the test
  draws it with the reference and passes it as ``fourier_b=``; the causal
  nets' B is the committed ``contaminant_causal_fourier_b.npy``;
* (slow) the 9.91% obstacle theta against the reference's CN-FDM oracle at
  320 x 160 x 800.  Its flux walls are refused by the port's ``VarNet``, and
  evaluation does not need them (exact BC imposes the Dirichlet walls only), so
  the port scores it on the same problem with those walls left free.
"""

import os
import sys

import numpy as np
import pytest

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.problems import analytic as jax_analytic
from varnet_tpu_torch import VarNet, load_theta_npz
from varnet_tpu_torch.problems import analytic
from varnet_tpu_torch.utils.helpers import rel_l2_error
from varnet_tpu_torch.utils.io import CONTAMINANT_CAUSAL_FOURIER_B, load_observations_csv

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
RESULTS = os.path.join(ROOT, "benchmarks", "results")
DATA = os.path.join(ROOT, "benchmarks", "data")
RTOL_JAX = 1e-3

# per-config name -> (rel-L2 bound, evaluation disc, n_times)
PER_CONFIG = {
    "1d_steady": (1e-3, 96, 7),
    "1d_transient": (1e-3, 96, 7),
    "2d_steady": (1e-3, 48, 7),
    "2d_transient": (1e-3, 48, 5),
    "lshape_manufactured": (2e-3, 48, 7),
}


def _configs():
    sys.path.insert(0, ROOT)
    from benchmarks.per_config_accuracy import CONFIGS

    return CONFIGS


def _both(factory, kw=None, **vn_kw):
    """The port's and the JAX package's VarNet of the same problem (small mesh:
    evaluation does not depend on it)."""
    kw = kw or {}
    pde = getattr(analytic, factory)(**kw)["pde"]
    jpde = getattr(jax_analytic, factory)(**kw)["pde"]
    mesh = dict(disc_num=4, t_disc_num=3 if pde.time_dependent else None)
    b_from_jax = vn_kw.pop("fourier_b", None) == "jax"
    jax_vn = JaxVarNet(jpde, n_devices=1, **mesh, **vn_kw)
    if b_from_jax:
        vn_kw["fourier_b"] = np.asarray(jax_vn.fourier_b)
    return VarNet(pde, device="cpu", **mesh, **vn_kw), jax_vn


@pytest.mark.parametrize("name", list(PER_CONFIG))
def test_per_config_pin(name):
    factory, _, _, width, layers, _ = _configs()[name]
    bound, disc, n_times = PER_CONFIG[name]
    theta = load_theta_npz(os.path.join(RESULTS, f"theta_{name}.npz"))
    port, ref = _both(factory.__name__, layer_width=(width,) * layers)
    ours = port.compute_error(theta, disc=disc, n_times=n_times)
    np.testing.assert_allclose(ours, ref.compute_error(theta, disc=disc, n_times=n_times),
                               rtol=RTOL_JAX)
    assert ours < bound, f"theta_{name}: rel-L2 {ours:.4e} >= {bound:g}"


# pin file -> (factory, widths, eval disc, n_times, bound)
PINS = {
    "theta_ad3d_d16.npz": ("steady_ad_3d", (64,) * 3, 16, 1, 6e-4),
    "flagship_theta_5.4e-4.npz": ("transient_ad_2d", (48,) * 3, 32, 3, 7e-4),
    "flagship_theta_1.3e-4.npz": ("transient_ad_2d", (48,) * 3, 32, 3, 1.8e-4),
    "flagship_theta_1.1e-04.npz": ("transient_ad_2d", (48,) * 3, 32, 3, 1.4e-4),
}


@pytest.mark.parametrize("pin", list(PINS))
def test_analytic_pin(pin):
    factory, widths, disc, n_times, bound = PINS[pin]
    theta = load_theta_npz(os.path.join(RESULTS, pin))
    port, ref = _both(factory, layer_width=widths)
    ours = port.compute_error(theta, disc=disc, n_times=n_times)
    np.testing.assert_allclose(ours, ref.compute_error(theta, disc=disc, n_times=n_times),
                               rtol=RTOL_JAX)
    assert ours < bound, f"{pin}: rel-L2 {ours:.4e} >= {bound:g}"


def _score(vn, coords, values):
    return rel_l2_error(np.asarray(vn.evaluate(coords[:, :2], t=coords[:, 2])), values)


# pin -> (csv, factory kwargs, VarNet kwargs, bound)
CSV_PINS = {
    "theta_contaminant_inlet": ("contaminant_inlet_fdm.csv", "contaminant_inlet_2d", {},
                                dict(layer_width=(48,) * 3), 0.08),
    "theta_contaminant_inlet_hard": ("contaminant_inlet_fdm.csv", "contaminant_inlet_2d", {},
                                     dict(layer_width=(48,) * 3, hard_bc=True), 0.03),
    "theta_contaminant_src_ff": ("contaminant_src_ff_fdm.csv", "contaminant_transport_2d",
                                 dict(kappa=0.03, src_sigma=0.12),
                                 dict(layer_width=(48,) * 3, fourier_features=64,
                                      fourier_scale=0.5, fourier_b="jax"), 0.06),
    "theta_contaminant_ff_hard": ("contaminant_fdm.csv", "contaminant_transport_2d", {},
                                  dict(layer_width=(96,) * 3, hard_bc=True,
                                       fourier_features=128, fourier_scale="0.5,2.0",
                                       fourier_b="jax"), 0.035),
}


@pytest.mark.parametrize("pin", list(CSV_PINS))
def test_contaminant_csv_pin(pin):
    csv, factory, kw, vn_kw, bound = CSV_PINS[pin]
    obs = load_observations_csv(os.path.join(DATA, csv))
    m = obs.coords[:, 2] > 0
    port, ref = _both(factory, kw, **dict(vn_kw))
    theta = load_theta_npz(os.path.join(RESULTS, f"{pin}.npz"))
    port.theta = port._params(theta)
    ref.theta = theta
    ours = _score(port, obs.coords[m], obs.values[m])
    np.testing.assert_allclose(ours, _score(ref, obs.coords[m], obs.values[m]), rtol=RTOL_JAX)
    assert ours < bound, f"{pin}: rel-L2 {ours:.4e} >= {bound:g}"


def test_observations_csv_matches_jax():
    from varnet_tpu.utils.io import load_observations_csv as jax_load

    path = os.path.join(DATA, "contaminant_inlet_fdm.csv")
    ours, ref = load_observations_csv(path), jax_load(path)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    sub = load_observations_csv(path, coord_cols=[0, 1], value_col=3)
    np.testing.assert_array_equal(sub.coords, ref.coords[:, :2])


def test_causal_hard_pin():
    """``theta_contaminant_causal_hard.npz`` against the CN-FDM field, < 2.5%;
    the committed B is the JAX package's draw for this net too."""
    z = np.load(os.path.join(DATA, "contaminant_fdm.npz"))
    net = dict(layer_width=(96,) * 3, b_disc_num=4, seed=0, input_scaling=False,
               hard_bc=True)
    ref = JaxVarNet(jax_analytic.contaminant_transport_2d()["pde"], n_devices=1, disc_num=4,
                    t_disc_num=3, fourier_features=128, fourier_scale=[0.5, 2.0], **net)
    b = np.load(CONTAMINANT_CAUSAL_FOURIER_B)
    np.testing.assert_array_equal(b, np.asarray(ref.fourier_b))
    port = VarNet(analytic.contaminant_transport_2d()["pde"], device="cpu", disc_num=4,
                  t_disc_num=3, fourier_b=b, **net)
    theta = load_theta_npz(os.path.join(RESULTS, "theta_contaminant_causal_hard.npz"))
    port.theta, ref.theta = port._params(theta), theta
    keep = z["times"] > 0
    x = z["x"].astype(np.float64)
    coords = np.concatenate([np.column_stack([x, np.full(len(x), t)])
                             for t in z["times"][keep]])
    values = np.concatenate([z["u"][s].astype(np.float64) for s in np.flatnonzero(keep)])
    ours = _score(port, coords, values)
    np.testing.assert_allclose(ours, _score(ref, coords, values), rtol=RTOL_JAX)
    assert ours < 0.025, f"causal hard: rel-L2 {ours:.4e} >= 0.025"


@pytest.mark.slow
def test_obstacle_dense_lm_pin():
    """The 9.91% obstacle theta (w48x2, exact BC on the inlet and rod) against the
    reference's CN-FDM oracle at 320 x 160 x 800 (t > 0 samples, in-domain
    nodes), as ``benchmarks/obstacle_refine.py`` scores it; bound 0.105."""
    from benchmarks.obstacle_validation import ROD_HI, ROD_LO, build_pde
    from varnet_tpu.problems.classical import solve_ad_fdm_2d
    from varnet_tpu_torch.geometry.domain import RectangleDomain2D
    from varnet_tpu_torch.problems.adpde import ADPDE

    sys.path.insert(0, ROOT)
    jpde = build_pde()
    times = np.linspace(0.0, 1.0, 6)
    oracle = solve_ad_fdm_2d(jpde, nx=320, ny=160, nt=800, sample_times=times)
    mask = jpde.domain.in_domain(oracle["x"])
    hole = np.array([[ROD_LO[0], ROD_LO[1]], [ROD_HI[0], ROD_LO[1]],
                     [ROD_HI[0], ROD_HI[1]], [ROD_LO[0], ROD_HI[1]]])

    def rod_g(x, t):
        return 1.0 - np.exp(-8.0 * np.asarray(t)) * np.ones(np.atleast_2d(x).shape[0])

    # the same problem with the zero-flux walls (bottom, top) left free
    pde = ADPDE(RectangleDomain2D((0.0, 0.0), (2.0, 1.0), holes=[hole]), diff=0.05,
                vel=np.array([1.0, 0.0]), source=0.0, bcs=[None, None, None, 0.0] + [rod_g] * 4,
                t_interval=(0.0, 1.0), ic=0.0)
    mesh = dict(layer_width=(48, 48), disc_num=(8, 4), t_disc_num=4, b_disc_num=8,
                hard_bc=True)
    port = VarNet(pde, device="cpu", **mesh)
    ref = JaxVarNet(jpde, n_devices=1, **mesh)
    theta = load_theta_npz(os.path.join(RESULTS, "theta_obstacle_dense_LM.npz"))
    port.theta, ref.theta = port._params(theta), theta
    x = oracle["x"][mask]
    coords = np.concatenate([np.column_stack([x, np.full(len(x), t)])
                             for t in times if t > 0])
    values = np.concatenate([oracle["u"][s][mask] for s, t in enumerate(times) if t > 0])
    ours = _score(port, coords, values)
    np.testing.assert_allclose(ours, _score(ref, coords, values), rtol=RTOL_JAX)
    assert ours < 0.105, f"obstacle dense LM: rel-L2 {ours:.4e} >= 0.105"
