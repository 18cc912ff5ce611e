"""The port's optimizers and trainer against the JAX package's: optax updates
on fixed gradients, and a 20-epoch Adam run on the small flagship mesh from the
same theta (the Adam band of ``__graft_entry__.py``: rtol 2e-4)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.problems.analytic import transient_ad_2d as jax_transient_ad_2d
from varnet_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from varnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from varnet_tpu_torch import VarNet
from varnet_tpu_torch.models.mlp import params_from_jax, params_to_numpy
from varnet_tpu_torch.problems.analytic import transient_ad_2d
from varnet_tpu_torch.train.optim import OptimizerConfig, make_optimizer
from _torch_threads import _one_intra_op_thread  # noqa: F401


OPT_CASES = {
    "adam": dict(name="adam", lr=1e-2),
    "rmsprop": dict(name="rmsprop", lr=1e-2),
    "sgd": dict(name="sgd", lr=1e-1),
    "adam_decay_clip": dict(name="adam", lr=1e-2, decay_rate=0.5, decay_steps=3,
                            grad_clip=2.0),
    "rmsprop_decay_clip": dict(name="rmsprop", lr=1e-2, decay_rate=0.5, decay_steps=3,
                               grad_clip=2.0),
    "sgd_decay_clip": dict(name="sgd", lr=1e-1, decay_rate=0.5, decay_steps=3,
                           grad_clip=2.0),
}


@pytest.mark.parametrize("case", list(OPT_CASES))
def test_optimizer_matches_optax(case):
    """10 updates on fixed gradients (scaled so the clip triggers on some
    steps only) land on optax's parameters within rtol 1e-6."""
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal((5, 4)).astype(np.float32),
          rng.standard_normal(4).astype(np.float32)]
    grads = [[(s * rng.standard_normal(p.shape)).astype(np.float32) for p in p0]
             for s in np.linspace(0.2, 1.5, 10)]

    jopt = jax_make_optimizer(JaxOptimizerConfig(**OPT_CASES[case]))
    jp = [jnp.asarray(p) for p in p0]
    state = jopt.init(jp)
    for g in grads:
        updates, state = jopt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = [torch.from_numpy(p.copy()).requires_grad_(True) for p in p0]
    opt = make_optimizer(OptimizerConfig(**OPT_CASES[case]), tp)
    for g in grads:
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        opt.step()

    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)


MESH = dict(layer_width=(20, 20), disc_num=8, b_disc_num=6, t_disc_num=4)
TRAIN = dict(epoch_num=20, weight=(1.0, 10.0, 10.0), save_freq=1, verbose=False,
             error_disc=8, error_times=2)


@pytest.fixture(scope="module")
def jax_run():
    vn = JaxVarNet(jax_transient_ad_2d()["pde"], n_devices=1, **MESH)
    theta0 = jax.tree_util.tree_map(np.asarray, vn.theta)
    res = vn.train(**TRAIN)
    return theta0, res, jax.tree_util.tree_map(np.asarray, vn.theta)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "general"])
def test_adam_trajectory_matches_jax(jax_run, fused):
    theta0, jres, jtheta = jax_run
    vn = VarNet(transient_ad_2d()["pde"], device="cpu", use_fused_residual=fused, **MESH)
    vn.theta = params_from_jax(theta0)
    res = vn.train(**TRAIN)
    assert res.epochs == jres.epochs == list(range(1, 21))
    for key in ("loss", "loss_int", "loss_bc", "loss_ic"):
        np.testing.assert_allclose([r[key] for r in res.losses],
                                   [r[key] for r in jres.losses], rtol=2e-4, err_msg=key)
    np.testing.assert_allclose(res.errors, jres.errors, rtol=2e-4)
    for a, b in zip(params_to_numpy(vn.theta), jtheta):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=2e-4 * np.abs(b[k]).max())
    assert res.quad_evals_per_sec > 0 and res.total_steps == 19


def test_cuda_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VarNet(transient_ad_2d()["pde"], device="cuda", **MESH)


def test_target_error_stops_at_the_first_report():
    vn = VarNet(transient_ad_2d()["pde"], device="cpu", **MESH)
    res = vn.train(epoch_num=10, weight=(1.0, 10.0, 10.0), save_freq=2, verbose=False,
                   error_disc=8, error_times=2, target_error=10.0)
    assert res.epochs == [2]


def test_minibatch_epoch_runs_each_batch(tmp_path):
    """batch_num > 1: one update per mini-batch; the JSONL log records the
    batch-mean losses."""
    vn = VarNet(transient_ad_2d()["pde"], device="cpu", **MESH)
    res = vn.train(epoch_num=3, weight=(1.0, 10.0, 10.0), batch_num=3, save_freq=1,
                   verbose=False, error_disc=8, error_times=2, folderpath=str(tmp_path))
    assert res.total_steps == 2 * 3
    lines = (tmp_path / "train_log.jsonl").read_text().splitlines()
    assert len(lines) == 3 and (tmp_path / "train_result.json").exists()
    assert all(np.isfinite(r["loss"]) for r in res.losses)
