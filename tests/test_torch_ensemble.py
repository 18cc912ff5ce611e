"""The port's ``VarNet.train_ensemble`` / ``evaluate_ensemble`` against the JAX
package's on the CPU.

A ``torch.Generator`` cannot reproduce ``jax.random.split(PRNGKey(seed), E)``, so
the JAX members (``_init_theta(k)`` for each split key) are carried across: the
port's ``_init_member`` is patched to return them.  Then 20 epochs with E = 3 on
the small flagship mesh give each member's losses and final theta within the
Adam band (rtol 2e-4) and the same selected member, on the fused path (K1/K2's
plain version here), on the general path, and behind a Fourier-feature embedding
(JAX's B passed as ``fourier_b``; K2-FF's plain version).  JAX runs its members
with ``vmap`` on the CPU (its fused kernel needs a TPU); the port runs them one
after another: the same sum.  ``evaluate_ensemble``'s mean and std follow JAX's
within rtol 2e-4; the stacked members round-trip through the npz helpers."""

import jax
import numpy as np
import pytest

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.problems.analytic import transient_ad_2d as jax_transient_ad_2d
from varnet_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from varnet_tpu_torch import OptimizerConfig, VarNet, load_theta_npz, save_theta_npz
from varnet_tpu_torch.models.mlp import tree_leaves
from varnet_tpu_torch.problems.analytic import transient_ad_2d
from _torch_threads import _one_intra_op_thread  # noqa: F401


MESH = dict(layer_width=(12, 12), disc_num=6, b_disc_num=5, t_disc_num=3)
E = 3
ENS = dict(epoch_num=20, n_members=E, weight=(1.0, 10.0, 10.0), save_freq=10, verbose=False,
           error_disc=6, error_times=2)
CASES = {"fused": {}, "general": dict(use_fused_residual=False),
         "fourier": dict(fourier_features=4)}
POINTS = np.random.default_rng(3).uniform(0.0, 1.0, (40, 2))


def _allclose(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4 * np.abs(b).max(), err_msg=what)


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's ensembles, by embedding: on the CPU the JAX package runs the fused and
    the general configuration alike (vmapped general path), so one run serves both."""
    return {}


@pytest.fixture(scope="module", params=list(CASES))
def runs(request, jax_runs):
    """(case, JAX VarNet after its ensemble, its result, JAX members, the port's
    VarNet after its ensemble from those members, its result)."""
    kw = CASES[request.param]
    ff = {k: v for k, v in kw.items() if k == "fourier_features"}
    key = "fourier" if ff else "plain"
    if key not in jax_runs:
        jvn = JaxVarNet(jax_transient_ad_2d()["pde"], n_devices=1, seed=5,
                        optimizer=JaxOptimizerConfig(lr=5e-3), **MESH, **ff)
        keys = jax.random.split(jax.random.PRNGKey(jvn.seed), E)
        members = [jax.tree_util.tree_map(np.asarray, jvn._init_theta(k)) for k in keys]
        jax_runs[key] = (jvn, jvn.train_ensemble(**ENS), members)
    jvn, jres, members = jax_runs[key]

    port_kw = dict(kw)
    if ff:
        port_kw["fourier_b"] = np.asarray(jvn.fourier_b)
    vn = VarNet(transient_ad_2d()["pde"], device="cpu", seed=5,
                optimizer=OptimizerConfig(lr=5e-3), **MESH, **port_kw)
    vn._init_member = lambda i: members[i]
    res = vn.train_ensemble(**ENS)
    return request.param, jvn, jres, members, vn, res


def test_members_follow_jax(runs):
    case, jvn, jres, _, vn, res = runs
    assert res.epochs == jres.epochs == [10, 20] and res.n_members == E
    _allclose(res.member_losses, jres.member_losses, f"{case}: member losses")
    _allclose(res.member_errors, jres.member_errors, f"{case}: member rel-L2")
    for ours, ref in zip(tree_leaves(vn._ensemble_thetas),
                         jax.tree_util.tree_leaves(jvn._ensemble_thetas)):
        assert ours.shape == np.shape(ref) and ours.shape[0] == E
        _allclose(ours, ref, f"{case}: member thetas")
    assert res.best_member == jres.best_member
    _allclose(res.best_error, jres.best_error, f"{case}: best rel-L2")
    # the winner is self.theta, the joint optimizer state is dropped
    for ours, stacked in zip(tree_leaves(vn.theta), tree_leaves(vn._ensemble_thetas)):
        np.testing.assert_array_equal(ours.numpy(), stacked[res.best_member])
    assert vn.opt_state is None
    assert res.steps_per_sec > 0 and res.quad_evals_per_sec > 0
    assert set(res.as_dict()) == set(jres.as_dict())


def test_evaluate_ensemble_follows_jax(runs):
    case, jvn, _, _, vn, _ = runs
    mean, std, members = vn.evaluate_ensemble(POINTS, t=0.3, return_members=True)
    jmean, jstd = jvn.evaluate_ensemble(POINTS, t=0.3)
    assert members.shape == (E, len(POINTS))
    _allclose(mean, jmean, f"{case}: mean")
    _allclose(std, jstd, f"{case}: std")
    np.testing.assert_allclose(mean, members.mean(axis=0))


def test_stacked_members_round_trip_npz(runs, tmp_path):
    _, _, _, _, vn, _ = runs
    path = str(tmp_path / "ens.npz")
    save_theta_npz(path, vn._ensemble_thetas)
    back = load_theta_npz(path)
    for a, b in zip(tree_leaves(back), tree_leaves(vn._ensemble_thetas)):
        np.testing.assert_array_equal(a, b)
    m1, s1 = vn.evaluate_ensemble(POINTS, t=0.3, thetas=back)
    m2, s2 = vn.evaluate_ensemble(POINTS, t=0.3)
    np.testing.assert_array_equal(m1, m2)
    np.testing.assert_array_equal(s1, s2)


def test_select_loss_picks_the_lowest_final_loss():
    vn = VarNet(transient_ad_2d()["pde"], device="cpu", **MESH)
    res = vn.train_ensemble(**{**ENS, "epoch_num": 4, "save_freq": 2}, select="loss")
    assert res.best_member == int(np.argmin(res.member_losses[-1]))
    # members draw from generators of their own: they differ from each other
    w0 = [m[0]["w"] for m in (vn._init_member(i) for i in range(E))]
    assert all(not np.array_equal(w0[0].numpy(), w.numpy()) for w in w0[1:])


@pytest.mark.parametrize("kw,match", [
    (dict(n_members=1), "n_members >= 2"),
    (dict(select="median"), "select must be"),
    (dict(grad_clip=1.0), "grad_clip couples"),
])
def test_refusals_carry_jax_messages(kw, match):
    opt = OptimizerConfig(grad_clip=kw.pop("grad_clip", None))
    vn = VarNet(transient_ad_2d()["pde"], device="cpu", optimizer=opt, **MESH)
    with pytest.raises(ValueError, match=match):
        vn.train_ensemble(**{**ENS, **kw})
    with pytest.raises(ValueError, match="no ensemble available"):
        vn.evaluate_ensemble(POINTS, t=0.3)
