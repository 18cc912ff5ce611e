"""The port re-scores the four pinned exact-BC thetas (``theta_hardbc_*.npz``,
benchmarks/hardbc_tpu.py) on the CPU like the JAX package does, and under
their bounds (``tests/test_accuracy_pin.py``; the 2-D pin, which no JAX test
holds, at 1.24x its recorded 3.232e-5).  Evaluation grids as in the JAX pin
tests and the recipe's ``err_disc``.

Tolerance.  Both packages evaluate the net in f32 and apply the ansatz A + B n
in f64, and a rel-L2 of 5e-7 .. 4e-4 magnifies the f32 noise.  The port is held
to an f64 re-score of the same theta within rtol 1e-3 and to the JAX package's
CPU re-score within rtol 1e-3, except at the 1-D transient pin (rel-L2 5.3e-7),
where JAX's own re-score sits 8.8e-4 above the f64 one and the port's 5.3e-4
below it: there the two packages are held within 2e-3 of each other.
"""

import os

import numpy as np
import pytest

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.problems import analytic as jax_analytic
from varnet_tpu_torch import VarNet, load_theta_npz
from varnet_tpu_torch.problems import analytic
from varnet_tpu_torch.utils.helpers import rel_l2_error

RESULTS = os.path.join(os.path.dirname(__file__), "..", "benchmarks", "results")

# pin: factory, widths, mesh (irrelevant to evaluation; small), eval disc, bound, rtol vs JAX
PINS = {
    "1dt": ("transient_ad_1d", (32,) * 3, dict(disc_num=8, t_disc_num=4), 256, 5e-6, 2e-3),
    "2d": ("steady_ad_2d", (48,) * 2, dict(disc_num=8), 96, 4.0e-5, 1e-3),
    "3d": ("steady_ad_3d", (64,) * 2, dict(disc_num=4), 32, 8e-4, 1e-3),
    "3dt": ("transient_ad_3d", (64,) * 2, dict(disc_num=4, t_disc_num=3), 24, 3e-4, 1e-3),
}
N_TIMES = 5


def _f64_error(vn, theta, disc):
    """The same re-score with the net evaluated in f64 NumPy."""
    pde = vn.pde
    pts, mask = pde.domain.grid_in_domain((disc + 1,) * pde.dim if pde.dim > 1 else disc + 1)
    pts = pts[mask]
    lo, hi = vn.static.input_lo, vn.static.input_hi
    times = np.linspace(*pde.t_interval, N_TIMES) if vn.static.time_dependent else [None]
    preds, exact = [], []
    for tv in times:
        t = None if tv is None else np.full(len(pts), tv)
        coords = pts if t is None else np.column_stack([pts, t])
        a = (coords - (lo + hi) / 2.0) * (2.0 / (hi - lo))
        for layer in theta[:-1]:
            a = np.tanh(a @ layer["w"].astype(np.float64) + layer["b"])
        n = (a @ theta[-1]["w"].astype(np.float64) + theta[-1]["b"])[:, 0]
        big_a, big_b = vn.hard.value_AB(coords)
        preds.append(big_a + big_b * n)
        exact.append(pde.eval_exact(pts, t, None))
    return rel_l2_error(np.concatenate(preds), np.concatenate(exact))


@pytest.mark.parametrize("pin", list(PINS))
def test_hardbc_pin_rescores_like_jax(pin):
    name, widths, mesh, disc, bound, rtol_jax = PINS[pin]
    theta = load_theta_npz(os.path.join(RESULTS, f"theta_hardbc_{pin}.npz"))
    vn = VarNet(getattr(analytic, name)()["pde"], layer_width=widths, device="cpu",
                hard_bc=True, **mesh)
    ours = vn.compute_error(theta, disc=disc, n_times=N_TIMES)
    ref = JaxVarNet(getattr(jax_analytic, name)()["pde"], layer_width=widths, n_devices=1,
                    hard_bc=True, **mesh).compute_error(theta, disc=disc, n_times=N_TIMES)
    np.testing.assert_allclose(ours, _f64_error(vn, theta, disc), rtol=1e-3)
    np.testing.assert_allclose(ours, ref, rtol=rtol_jax)
    assert ours < bound, f"theta_hardbc_{pin}: rel-L2 {ours:.4e} >= {bound:g}"
