"""The port re-scores the pinned flagship theta like the JAX package does
(``tests/test_accuracy_pin.py``), at reduced evaluation grids.

Tolerance.  Both packages evaluate u in f32, about 6e-7 (absolute) from an
f64 evaluation of the same theta, and a rel-L2 of 1e-4 magnifies that noise:
the JAX package's own CPU re-score sits 2.5e-4 (relative) from the f64
re-score at this theta, the port's 3e-5 to 8e-5.  So the port is held to the
f64 re-score within rtol 2e-4 and to the JAX package's within rtol 1e-3.
"""

import os

import numpy as np
import pytest

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.problems.analytic import transient_ad_2d as jax_transient_ad_2d
from varnet_tpu_torch import VarNet, load_theta_npz
from varnet_tpu_torch.problems.analytic import transient_ad_2d
from varnet_tpu_torch.utils.helpers import rel_l2_error

PIN = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "results",
                   "flagship_theta_1.0e-04.npz")
MESH = dict(layer_width=(48, 48, 48), disc_num=8, t_disc_num=4)


def _f64_error(vn, theta, disc, n_times):
    """The same re-score with the net evaluated in f64 NumPy."""
    pde = vn.pde
    pts, mask = pde.domain.grid_in_domain((disc + 1,) * 2)
    pts = pts[mask]
    lo, hi = vn.static.input_lo, vn.static.input_hi
    preds, exact = [], []
    for tv in np.linspace(*pde.t_interval, n_times):
        t = np.full(len(pts), tv)
        a = (np.column_stack([pts, t]) - (lo + hi) / 2.0) * (2.0 / (hi - lo))
        for layer in theta[:-1]:
            a = np.tanh(a @ layer["w"].astype(np.float64) + layer["b"])
        preds.append((a @ theta[-1]["w"].astype(np.float64) + theta[-1]["b"])[:, 0])
        exact.append(pde.eval_exact(pts, t, None))
    return rel_l2_error(np.concatenate(preds), np.concatenate(exact))


@pytest.mark.parametrize("disc,n_times", [(32, 3), (16, 5)])
def test_pinned_theta_rescores_like_jax(disc, n_times):
    theta = load_theta_npz(PIN)
    vn = VarNet(transient_ad_2d()["pde"], device="cpu", **MESH)
    port = vn.compute_error(theta, disc=disc, n_times=n_times)
    ref = JaxVarNet(jax_transient_ad_2d()["pde"], n_devices=1, **MESH).compute_error(
        theta, disc=disc, n_times=n_times)
    np.testing.assert_allclose(port, _f64_error(vn, theta, disc, n_times), rtol=2e-4)
    np.testing.assert_allclose(port, ref, rtol=1e-3)
    assert port < 1.25e-4   # the pin's bound (tests/test_accuracy_pin.py)


def test_evaluate_takes_numpy_or_tensor_theta():
    vn = VarNet(transient_ad_2d()["pde"], device="cpu", **MESH)
    theta = load_theta_npz(PIN)
    x = np.random.default_rng(0).uniform(0.0, 1.0, (100, 2))
    u_np = vn.evaluate(x, t=0.5, theta=theta)
    u_jax = JaxVarNet(jax_transient_ad_2d()["pde"], n_devices=1, **MESH).evaluate(
        x, t=0.5, theta=theta)
    np.testing.assert_allclose(u_np, u_jax, rtol=0, atol=2e-6)  # f32 noise of a 48x3 net
    vn.theta = vn._params(theta)
    np.testing.assert_array_equal(vn.evaluate(x, t=0.5), u_np)
    # chunking changes the matmul blocking, not the values beyond f32 rounding
    np.testing.assert_allclose(vn.evaluate(x, t=0.5, chunk=7), u_np, rtol=0, atol=1e-6)
