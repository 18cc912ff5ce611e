"""The port's ``VarNet.refine_lm`` against the JAX package's on the CPU: two LM
iterations of five CG iterations from the same (briefly Adam-trained) theta on
the small flagship mesh, through the general path and through the value+jac
Function (its plain versions here).  Losses, lam and rel-L2 are held within
rtol 2e-2, the LM band of ``__graft_entry__.py::dryrun_multichip``."""

import jax
import numpy as np
import pytest

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.problems.analytic import transient_ad_2d as jax_transient_ad_2d
from varnet_tpu_torch import VarNet, params_from_jax
from varnet_tpu_torch.problems.analytic import transient_ad_2d

MESH = dict(layer_width=(20, 20), disc_num=8, b_disc_num=6, t_disc_num=4)
LM = dict(steps=2, weight=(1.0, 10.0, 10.0), cg_iters=5, save_freq=1, verbose=False,
          error_disc=8, error_times=2)


@pytest.fixture(scope="module")
def jax_lm():
    vn = JaxVarNet(jax_transient_ad_2d()["pde"], n_devices=1, **MESH)
    vn.train(epoch_num=30, weight=(1.0, 10.0, 10.0), save_freq=30, verbose=False,
             error_disc=8, error_times=2)
    theta = jax.tree_util.tree_map(np.asarray, vn.theta)
    return theta, vn.refine_lm(**LM)


def _port(theta, **kw):
    vn = VarNet(transient_ad_2d()["pde"], device="cpu", **{**MESH, **kw})
    vn.theta = params_from_jax(theta)
    return vn


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel_fn", "general"])
def test_refine_lm_matches_jax(jax_lm, use_pallas):
    theta, jres = jax_lm
    res = _port(theta, use_pallas=use_pallas).refine_lm(**LM)
    assert res.epochs == jres.epochs == [1, 2] and res.total_steps == 2
    for key in ("loss", "lam"):
        np.testing.assert_allclose([r[key] for r in res.losses],
                                   [r[key] for r in jres.losses], rtol=2e-2, err_msg=key)
    np.testing.assert_allclose(res.errors, jres.errors, rtol=2e-2)
    assert res.losses[-1]["loss"] < res.losses[0]["loss"] * (1 + 1e-6)
    assert len(res.wall_times) == 2 and res.wall_times[0] <= res.wall_times[1]


def test_target_error_stops_early(jax_lm):
    res = _port(jax_lm[0]).refine_lm(**{**LM, "steps": 3, "target_error": 10.0})
    assert res.epochs == [1]


@pytest.mark.parametrize("mode", ["leaf", "diag"])
def test_preconditioned_lm_runs_and_does_not_raise_the_loss(jax_lm, mode):
    vn = _port(jax_lm[0])
    start = vn.refine_lm(**{**LM, "steps": 1, "cg_iters": 0}).losses[0]["loss"]
    res = _port(jax_lm[0]).refine_lm(**{**LM, "precond": 4, "precond_mode": mode})
    losses = [r["loss"] for r in res.losses]
    assert np.all(np.isfinite(losses)) and losses[0] <= start and losses[1] <= losses[0]


def test_refine_lm_updates_theta_and_result(jax_lm):
    vn = _port(jax_lm[0])
    res = vn.refine_lm(**LM)
    assert vn.train_result is res
    assert not np.allclose(vn.theta[0]["w"].numpy(), jax_lm[0][0]["w"])
    assert vn.compute_error(disc=8, n_times=2) == pytest.approx(res.errors[-1], rel=1e-6)
