"""The port's trainable source fields (``models/source.py``) and the parameter tree
of an inverse problem against the JAX package's.

* ``make_gaussian_source``, ``make_mlp_source`` and ``make_mlp_source_xt``: shapes and
  values against JAX at the same phi (the JAX ``phi0`` carried across with
  ``params_from_jax``: a ``torch.Generator`` cannot reproduce ``jax.random``).
* ``ravel_params`` / ``leaf_segments`` of a dict theta in ``ravel_pytree``'s order
  (dict keys sorted: ``kap < net < src < vel``; ``amp < center < log_sigma``).
* The optimizer's global-norm clip spans every leaf, as optax's chain does.
* A dict theta round-trips through checkpoints, ``load_model``, resume and the npz
  helpers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from varnet_tpu.models import source as jax_source
from varnet_tpu_torch import VarNet
from varnet_tpu_torch.fem.assembly import PointData
from varnet_tpu_torch.models import source
from varnet_tpu_torch.models.mlp import (
    init_mlp,
    leaf_segments,
    params_from_jax,
    params_to_numpy,
    ravel_params,
    tree_leaves,
)
from varnet_tpu_torch.problems.analytic import inverse_source_2d
from varnet_tpu_torch.train.optim import OptimizerConfig, make_optimizer
from varnet_tpu_torch.utils.io import load_theta_npz, persist_theta_if_better, save_theta_npz


def _points(n, d, seed=0):
    return np.random.default_rng(seed).uniform(0.0, 1.0, (n, d)).astype(np.float32)


@pytest.mark.parametrize("n_space", [1, 2, 3])
def test_gaussian_source_matches_jax(n_space):
    fn, phi0 = source.make_gaussian_source(n_space)
    jfn, jphi0 = jax_source.make_gaussian_source(n_space)
    assert sorted(phi0) == sorted(jphi0) == ["amp", "center", "log_sigma"]
    for k in phi0:
        np.testing.assert_array_equal(phi0[k].numpy(), np.asarray(jphi0[k]))
    rng = np.random.default_rng(n_space)
    phi = {"amp": np.float32(1.7), "center": rng.uniform(0, 1, n_space).astype(np.float32),
           "log_sigma": np.float32(-1.3)}
    x = _points(9, n_space)
    s = fn(params_from_jax(phi), torch.from_numpy(x))
    js = jfn(jax.tree_util.tree_map(jnp.asarray, phi), jnp.asarray(x))
    assert s.shape == (9,)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    peak, off = (float(fn(phi0, x0)[0]) for x0 in (torch.zeros(1, n_space),
                                                   torch.ones(1, n_space)))
    assert peak > off   # the peak at the (origin) center


@pytest.mark.parametrize("scaled", [False, True], ids=["raw", "scaled"])
@pytest.mark.parametrize("xt", [False, True], ids=["x", "xt"])
def test_mlp_source_matches_jax(xt, scaled):
    n_space = 2
    n_in = n_space + xt
    lo, hi = (np.zeros(n_in), np.array([1.0, 2.0, 0.5])[:n_in]) if scaled else (None, None)
    make, jmake = ((source.make_mlp_source_xt, jax_source.make_mlp_source_xt) if xt else
                   (source.make_mlp_source, jax_source.make_mlp_source))
    fn, phi0 = make(torch.Generator().manual_seed(0), n_space, hidden=(8, 6), lo=lo, hi=hi)
    jfn, jphi0 = jmake(jax.random.PRNGKey(1), n_space, hidden=(8, 6), lo=lo, hi=hi)
    assert [tuple(layer["w"].shape) for layer in phi0] == [
        tuple(layer["w"].shape) for layer in jphi0]
    x, t = _points(11, n_space), _points(11, 1, 1)[:, 0]
    s = fn(params_from_jax(jphi0), torch.from_numpy(x), torch.from_numpy(t) if xt else None)
    js = jfn(jphi0, jnp.asarray(x), jnp.asarray(t) if xt else None)
    assert s.shape == (11,)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-6)


def _dict_theta(kind):
    """An inverse problem's theta (torch) of each shape the port trains."""
    gen = torch.Generator().manual_seed(3)
    net = init_mlp(gen, 2, (5, 4))
    if kind == "mlp-source":
        return {"net": net, "src": init_mlp(gen, 2, (3,))}
    if kind == "gaussian-source":
        return {"net": net, "src": {"amp": torch.tensor(1.5),
                                    "center": torch.randn(2, generator=gen),
                                    "log_sigma": torch.tensor(-0.7)}}
    return {"vel": torch.randn(2, generator=gen), "net": net,
            "kap": torch.randn(1, generator=gen), "src": init_mlp(gen, 2, (3,))}


@pytest.mark.parametrize("kind", ["mlp-source", "gaussian-source", "all-hooks"])
def test_ravel_order_matches_ravel_pytree(kind):
    theta = _dict_theta(kind)
    flat, unravel = ravel_params(theta)
    jflat, junravel = ravel_pytree(jax.tree_util.tree_map(jnp.asarray, params_to_numpy(theta)))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    sizes = [int(np.size(leaf)) for leaf in jax.tree_util.tree_leaves(junravel(jflat))]
    np.testing.assert_array_equal(leaf_segments(theta),
                                  np.repeat(np.arange(len(sizes)), sizes))
    # unravel gives views in the same tree, and carries the vector's values
    back = unravel(2.0 * flat)
    assert jax.tree_util.tree_structure(params_to_numpy(back)) == jax.tree_util.tree_structure(
        params_to_numpy(theta))
    for a, b in zip(tree_leaves(back), tree_leaves(theta)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.numpy(), 2.0 * b.numpy())


def test_params_from_jax_round_trips_a_dict_theta():
    theta = _dict_theta("all-hooks")
    host = params_to_numpy(theta)
    assert isinstance(host["kap"], np.ndarray) and isinstance(host["net"][0]["w"], np.ndarray)
    for a, b in zip(tree_leaves(params_from_jax(host)), tree_leaves(theta)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_global_norm_clip_spans_every_leaf_as_optax():
    """Adam with a global-norm clip on a {net, src, kap} tree: the clip's norm
    includes the src and kap gradients (optax.chain(clip_by_global_norm, adam))."""
    theta = _dict_theta("all-hooks")
    rng = np.random.default_rng(5)
    grads = [rng.standard_normal(leaf.shape).astype(np.float32) for leaf in tree_leaves(theta)]
    leaves = [leaf.clone().requires_grad_(True) for leaf in tree_leaves(theta)]
    opt = make_optimizer(OptimizerConfig(lr=1e-2, grad_clip=0.5), leaves)
    jtx = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-2))
    jparams = [jnp.asarray(leaf.detach().numpy().copy()) for leaf in leaves]
    jstate = jtx.init(jparams)
    for _ in range(3):
        for leaf, g in zip(leaves, grads):
            leaf.grad = torch.from_numpy(g.copy())
        opt.step()
        upd, jstate = jtx.update([jnp.asarray(g) for g in grads], jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
    for leaf, jp in zip(leaves, jparams):
        np.testing.assert_allclose(leaf.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)


def _inverse_vn(seed=0):
    case = inverse_source_2d(kappa=0.1, n_obs=16)
    lo, hi = case["pde"].domain.bounds
    fn, phi0 = source.make_mlp_source(torch.Generator().manual_seed(1), 2, hidden=(6,),
                                      lo=lo, hi=hi)
    obs = PointData(coords=case["obs_x"], values=case["obs_u"],
                    mask=np.ones(case["obs_x"].shape[0]))
    return VarNet(case["pde"], layer_width=(6, 6), disc_num=4, b_disc_num=4, device="cpu",
                  seed=seed, source_fn=fn, source_init=phi0, obs_data=obs)


TRAIN = dict(weight=(1.0, 10.0, 100.0), save_freq=2, verbose=False, error_disc=8)


def test_dict_theta_checkpoint_round_trip(tmp_path):
    """Train 4 epochs straight, and 2 then a resume to 4 in a fresh VarNet: the same
    {net, src} theta to the bit; ``load_model`` and an LM checkpoint restore the
    dict; the config's param_count is the net's."""
    straight = _inverse_vn()
    straight.train(epoch_num=4, **TRAIN)
    cut = _inverse_vn()
    cut.train(epoch_num=2, folderpath=str(tmp_path), **TRAIN)
    resumed = _inverse_vn()
    resumed.train(epoch_num=4, folderpath=str(tmp_path), resume=True, **TRAIN)
    assert set(resumed.theta) == {"net", "src"}
    for a, b in zip(tree_leaves(resumed.theta), tree_leaves(straight.theta)):
        assert torch.equal(a, b)
    loaded = _inverse_vn(seed=9)
    assert loaded.load_model(str(tmp_path)) == 4
    for a, b in zip(tree_leaves(loaded.theta), tree_leaves(straight.theta)):
        assert torch.equal(a, b)
    assert loaded.config_dict()["param_count"] == sum(
        v.numel() for v in tree_leaves(loaded.theta["net"]))
    lm = _inverse_vn()
    lm.theta = straight.theta
    lm.refine_lm(steps=1, weight=TRAIN["weight"], cg_iters=2, folderpath=str(tmp_path),
                 verbose=False, error_disc=8)
    back = _inverse_vn(seed=9)
    step, _ = back._restore_theta(str(tmp_path / "lm"))
    assert step == 1
    for a, b in zip(tree_leaves(back.theta), tree_leaves(lm.theta)):
        assert torch.equal(a, b)


def test_dict_theta_npz_round_trip(tmp_path):
    """save_theta_npz writes the net_ / src_ pair of the JAX package's inverse-source
    files (and kap / vel arrays, a Gaussian source's named leaves); load_theta_npz
    and the improve-only guard read it back."""
    theta = _dict_theta("all-hooks")
    theta["src"] = {"amp": torch.tensor(1.5), "center": torch.zeros(2),
                    "log_sigma": torch.tensor(-1.0)}
    path = str(tmp_path / "t.npz")
    save_theta_npz(path, theta)
    files = set(np.load(path).files)
    assert {"net_l0_w", "net_l2_b", "kap", "vel", "src_amp", "src_center"} <= files
    back = load_theta_npz(path)
    assert sorted(back) == ["kap", "net", "src", "vel"]
    for a, b in zip(tree_leaves(params_from_jax(back)), tree_leaves(theta)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    inv = {"net": theta["net"], "src": init_mlp(torch.Generator().manual_seed(0), 2, (3,))}
    p2 = str(tmp_path / "inv.npz")
    assert persist_theta_if_better(p2, inv, 1e-3, verbose=False)
    assert not persist_theta_if_better(p2, inv, 2e-3, verbose=False)
    z = np.load(p2)
    assert len(load_theta_npz(z, prefix="net_")) == 3 and len(load_theta_npz(z, "src_")) == 2
