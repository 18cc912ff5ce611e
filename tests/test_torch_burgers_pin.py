"""The port re-scores the five pinned viscous-Burgers thetas
(``theta_burgers_*.npz``, benchmarks/burgers_accuracy.py) on the CPU under the
bounds of ``tests/test_accuracy_pin.py::BURGERS_PINS`` and like the JAX package
does: the same cases, widths (32,) * 3, evaluation grids and time slices.

Tolerance: both packages evaluate the net in f32 (exact BC: the ansatz A + B n
in f64); the two re-scores agree within rtol 2e-3 (7.5e-4 measured at the
traveling front, where a rel-L2 of 4e-5 magnifies the f32 noise most).
"""

import os

import numpy as np
import pytest

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.problems import analytic as jax_analytic
from varnet_tpu_torch import VarNet, load_theta_npz
from varnet_tpu_torch.problems import analytic

RESULTS = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "results")

CASES = {
    "traveling_front": ("burgers_1d_transient", dict(nu=0.05, a=0.4, c=0.6)),
    "steady_shock": ("burgers_1d_steady", dict(nu=0.07, a=1.0)),
    "front_2d": ("burgers_2d_front", dict(nu=0.1)),
}
# pin stem -> (evaluation disc, bound)
PINS = {
    "traveling_front": (256, 1e-4),
    "steady_shock": (256, 8e-4),
    "front_2d": (96, 2e-4),
    "traveling_front_hard": (256, 2e-6),
    "steady_shock_hard": (256, 7e-4),
}
N_TIMES = 5


@pytest.mark.parametrize("pin", list(PINS))
def test_burgers_pin_rescores_like_jax(pin):
    disc, bound = PINS[pin]
    hard = pin.endswith("_hard")
    name, kw = CASES[pin[: -len("_hard")] if hard else pin]
    theta = load_theta_npz(os.path.join(RESULTS, f"theta_burgers_{pin}.npz"))
    pde = getattr(analytic, name)(**kw)["pde"]
    mesh = dict(disc_num=8, t_disc_num=4 if pde.time_dependent else None)
    vn = VarNet(pde, layer_width=(32,) * 3, device="cpu", hard_bc=hard, **mesh)
    assert vn.nl_vec is not None
    ours = vn.compute_error(theta, disc=disc, n_times=N_TIMES)
    ref = JaxVarNet(getattr(jax_analytic, name)(**kw)["pde"], layer_width=(32,) * 3,
                    n_devices=1, hard_bc=hard, **mesh).compute_error(theta, disc=disc,
                                                                     n_times=N_TIMES)
    np.testing.assert_allclose(ours, ref, rtol=2e-3)
    assert ours < bound, f"theta_burgers_{pin}: rel-L2 {ours:.4e} >= {bound:g}"
