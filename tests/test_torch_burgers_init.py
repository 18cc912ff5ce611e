"""The committed initial theta of the 2-D Burgers front recipe
(``varnet_tpu_torch/data/burgers_front_2d_jax_init.npz``) is the JAX package's
seed-0 draw for ``benchmarks/burgers_accuracy.py --two-d`` (n_in 3, w32x3), and 20
Adam epochs of the port from it follow the JAX package's (rtol 2e-4, the Adam band
of ``test_torch_train.py``) at a small mesh with the recipe's optimizer.

The card has no JAX, so ``scripts/burgers_recipe.py --init jax`` reads this file to
start the port's Adam stage where the published run started.
"""

import jax
import numpy as np
import pytest

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.problems import analytic as jax_analytic
from varnet_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from varnet_tpu_torch import VarNet, load_theta_npz, params_from_jax
from varnet_tpu_torch.problems import analytic
from varnet_tpu_torch.train.optim import OptimizerConfig
from varnet_tpu_torch.utils.io import BURGERS_FRONT_2D_JAX_INIT

NET = dict(layer_width=(32, 32, 32))
SMALL = dict(disc_num=8, b_disc_num=8, t_disc_num=4)
ADAM = dict(lr=2e-3, decay_rate=0.1, decay_steps=5)   # the recipe's, at 20 epochs
TRAIN = dict(epoch_num=20, weight=(1.0, 10.0, 10.0), save_freq=1, verbose=False,
             error_disc=32, error_times=3)


@pytest.fixture(scope="module")
def jax_vn():
    return JaxVarNet(jax_analytic.burgers_2d_front(nu=0.1)["pde"], n_devices=1,
                     optimizer=JaxOptimizerConfig(**ADAM), **NET, **SMALL)


def test_committed_init_is_the_jax_draw(jax_vn):
    ours = load_theta_npz(BURGERS_FRONT_2D_JAX_INIT)
    ref = jax.tree_util.tree_map(np.asarray, jax_vn.theta)
    assert [tuple(layer["w"].shape) for layer in ours] == [(3, 32), (32, 32), (32, 32), (32, 1)]
    for a, b in zip(ours, ref):
        for k in ("w", "b"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_adam_from_the_committed_init_matches_jax(jax_vn):
    jres = jax_vn.train(**TRAIN)
    vn = VarNet(analytic.burgers_2d_front(nu=0.1)["pde"], device="cpu",
                optimizer=OptimizerConfig(**ADAM), **NET, **SMALL)
    vn.theta = params_from_jax(load_theta_npz(BURGERS_FRONT_2D_JAX_INIT))
    res = vn.train(**TRAIN)
    assert res.epochs == jres.epochs == list(range(1, 21))
    for key in ("loss", "loss_int", "loss_bc", "loss_ic"):
        np.testing.assert_allclose([r[key] for r in res.losses],
                                   [r[key] for r in jres.losses], rtol=2e-4, atol=1e-12,
                                   err_msg=key)
    np.testing.assert_allclose(res.errors, jres.errors, rtol=2e-4)
    assert res.losses[-1]["loss"] < res.losses[0]["loss"]
