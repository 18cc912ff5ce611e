"""The port's Neumann / Robin flux rows against the JAX package's.

The loss adds w_bc * mean |alpha u + dirs . grad u - g|^2 over the flux points
(``train/loss.py``) and the LM residual the rows sqrt(w_bc / n_neu) (flux - g) mask
(``train/gauss_newton.py``); with exact BC they take the transformed u through the
tables at the flux coords.  Held to JAX at a seeded theta (loss rtol 1e-5,
gradients 1e-4), over 20 Adam epochs (rtol 2e-4) and 2 LM iterations (rtol 2e-2),
on ``steady_ad_1d_neumann``, ``steady_ad_2d_neumann`` and a Robin variant, in
penalty and hard mode, on the fused and the general path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.fem import assembly as jas
from varnet_tpu.fem.hardbc import HardBC as JaxHardBC
from varnet_tpu.problems import analytic as jax_analytic
from varnet_tpu.problems.adpde import RobinBC as JaxRobinBC
from varnet_tpu.train.loss import make_loss_fn as jax_make_loss_fn
from varnet_tpu_torch import VarNet
from varnet_tpu_torch.fem.assembly import build_fixed_data, pad_flux, pad_points, pad_quad
from varnet_tpu_torch.fem.hardbc import HardBC, tables_to
from varnet_tpu_torch.models.mlp import (
    make_input_scaling,
    params_from_jax,
    tree_leaves,
)
from varnet_tpu_torch.ops.fused_residual import prepare_residual_coeffs, prepare_residual_data
from varnet_tpu_torch.problems import analytic
from varnet_tpu_torch.problems.adpde import RobinBC
from varnet_tpu_torch.train.loss import make_loss_fn
from _torch_threads import _one_intra_op_thread  # noqa: F401


FLUX = ["steady_ad_1d_neumann", "steady_ad_2d_neumann"]
MESH = dict(disc_num=4, b_disc_num=4, device="cpu")
ROBIN = dict(alpha=1.5, flux=0.7)


def _pde(pkg, name):
    """A flux problem of ``pkg`` (the port's analytic module or JAX's); 'robin':
    steady_ad_1d_neumann with a Robin condition at x = 1."""
    if name != "robin":
        return getattr(pkg, name)()["pde"]
    pde = pkg.steady_ad_1d_neumann()["pde"]
    robin = RobinBC if pkg is analytic else JaxRobinBC
    return dataclasses.replace(pde, bcs=[0.0, robin(**ROBIN)])


def _theta(n_in, widths, seed=0):
    rng = np.random.default_rng(seed)
    sizes = (n_in,) + widths + (1,)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b))).astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _torch(t):
    return type(t)(*(None if a is None else torch.from_numpy(np.array(a, dtype=np.float32))
                     for a in t))


def _jnp(t):
    return type(t)(*(None if a is None else jnp.asarray(a, jnp.float32) for a in t))


@pytest.mark.parametrize("path", ["fused", "general"])
@pytest.mark.parametrize("hard", [False, True], ids=["penalty", "hard"])
@pytest.mark.parametrize("name", FLUX + ["robin"])
def test_flux_loss_and_grads_match_jax(name, hard, path):
    disc = 8 if name == "steady_ad_2d_neumann" else 12
    widths = (12, 12)
    kw = dict(b_disc_num=6)
    fd = build_fixed_data(_pde(analytic, name), disc, **kw)
    jfd = jas.build_fixed_data(_pde(jax_analytic, name), disc, **kw)
    st = fd.static
    assert st.n_neu > 0 and st.n_neu == jfd.static.n_neu
    raw = _theta(st.n_inputs, widths)
    weights = [1.0, 10.0, 0.0, 0.0]

    # JAX: the general path (its fused hook computes the same loss)
    jneu = _jnp(jas.pad_flux(jfd.neu, 1))
    jhard = None
    if hard:
        hb = JaxHardBC(_pde(jax_analytic, name))
        jhard = (_jnp(hb.tables(jfd.quad.coords)), None, _jnp(hb.tables(jneu.coords)))
    jloss = jax_make_loss_fn(jfd.static, hard_mode=hard)
    (jtot, jaux), jgrad = jax.value_and_grad(
        lambda th: jloss(th, _jnp(jfd.quad), _jnp(jfd.bc), None, None,
                         jnp.asarray(weights), neu=jneu, hard=jhard),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, raw))

    # port
    quad = pad_quad(fd.quad, 1)
    neu = pad_flux(fd.neu, 1)
    hq = hn = prepared = None
    if hard:
        hb = HardBC(_pde(analytic, name))
        hq, hn = hb.tables(quad.coords), tables_to(hb.tables(neu.coords))
    fused = path == "fused"
    if fused:
        scale, shift = make_input_scaling(st.input_lo, st.input_hi)
        prep = prepare_residual_coeffs if hard else prepare_residual_data
        prepared = prep(_torch(quad), scale, shift, time_dependent=False, has_react=False,
                        **({"hard": hq} if hard else {}))
    loss = make_loss_fn(st, fused=fused, hard_mode=hard)
    theta = params_from_jax(raw)
    for leaf in tree_leaves(theta):
        leaf.requires_grad_(True)
    tot, aux = loss(theta, _torch(quad), _torch(pad_points(fd.bc, 1)), None, weights, prepared,
                    hard=None if hq is None or fused else tables_to(hq), neu=_torch(neu),
                    hard_neu=hn)
    grads = torch.autograd.grad(tot, tree_leaves(theta))
    aux = {k: v.detach() for k, v in aux.items()}

    assert set(aux) == set(jaux) and "loss_neu" in aux
    for key in aux:
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), rtol=1e-5, err_msg=key)
    for g, jg in zip(grads, jax.tree_util.tree_leaves(jgrad)):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max())


def _pair(name, hard, **kw):
    """A port VarNet and a JAX one on the same flux problem, the port holding the
    JAX net's initial theta."""
    jv = JaxVarNet(_pde(jax_analytic, name), n_devices=1, hard_bc=hard, **kw)
    vn = VarNet(_pde(analytic, name), device="cpu", hard_bc=hard, **kw)
    vn.theta = params_from_jax(jax.tree_util.tree_map(np.asarray, jv.theta))
    return vn, jv


def _losses(res, key="loss"):
    return np.array([rec[key] for rec in res.losses])


ADAM = dict(epoch_num=20, weight=(1.0, 10.0), save_freq=1, verbose=False, error_disc=8)


@pytest.mark.parametrize("hard", [False, True], ids=["penalty", "hard"])
@pytest.mark.parametrize("name", FLUX + ["robin"])
def test_flux_adam_trajectory_matches_jax(name, hard):
    vn, jv = _pair(name, hard, layer_width=(12, 12), disc_num=6, b_disc_num=4)
    assert vn._fused_kind == ("precoeff" if hard else "dir")
    res, jres = vn.train(**ADAM), jv.train(**ADAM)
    lk, lj = _losses(res), _losses(jres)
    np.testing.assert_allclose(lk, lj, rtol=2e-4)
    np.testing.assert_allclose(_losses(res, "loss_neu"), _losses(jres, "loss_neu"), rtol=2e-4)
    assert np.all(np.isfinite(lk)) and lk[-1] < lk[0]
    if hard:
        assert np.all(_losses(res, "loss_bc") == 0.0)


def test_flux_rows_with_batches_match_jax():
    """batch_num 2: the interior splits, the flux rows stay full-batch."""
    vn, jv = _pair("steady_ad_2d_neumann", False, layer_width=(8, 8), disc_num=6,
                   b_disc_num=4)
    kw = dict(ADAM, epoch_num=10, batch_num=2)
    np.testing.assert_allclose(_losses(vn.train(**kw)), _losses(jv.train(**kw)), rtol=2e-4)


def test_flux_rows_behind_fourier_features_match_jax():
    """A Fourier-feature net (the JAX draw of B carried across) on the flux problem:
    the interior on K2-FF's plain version, the flux rows through ff_value_and_jac."""
    kw = dict(layer_width=(8, 8), disc_num=6, b_disc_num=4)
    jv = JaxVarNet(_pde(jax_analytic, "steady_ad_2d_neumann"), n_devices=1,
                   fourier_features=4, **kw)
    vn = VarNet(_pde(analytic, "steady_ad_2d_neumann"), device="cpu",
                fourier_b=np.asarray(jv.fourier_b), **kw)
    vn.theta = params_from_jax(jax.tree_util.tree_map(np.asarray, jv.theta))
    assert vn._fused_kind == "dir"
    t = dict(ADAM, epoch_num=10)
    np.testing.assert_allclose(_losses(vn.train(**t), "loss_neu"),
                               _losses(jv.train(**t), "loss_neu"), rtol=2e-4)


LM = dict(steps=2, weight=(1.0, 10.0), cg_iters=20, save_freq=1, verbose=False,
          error_disc=8)


@pytest.mark.parametrize("hard", [False, True], ids=["penalty", "hard"])
@pytest.mark.parametrize("name", FLUX)
def test_flux_lm_matches_jax(name, hard):
    """2 LM iterations with the flux rows from a 100-epoch JAX start (the port
    takes the same theta), within rtol 2e-2."""
    vn, jv = _pair(name, hard, layer_width=(12, 12), disc_num=6, b_disc_num=4)
    jv.train(**dict(ADAM, epoch_num=100, save_freq=100))
    vn.theta = params_from_jax(jax.tree_util.tree_map(np.asarray, jv.theta))
    lk, lj = _losses(vn.refine_lm(**LM)), _losses(jv.refine_lm(**LM))
    np.testing.assert_allclose(lk, lj, rtol=2e-2)
    assert lk[-1] <= lk[0] * (1 + 1e-6)


def test_diff_fn_with_flux_rows_raises():
    """JAX's refusal: flux data bakes kappa-scaled normals at assembly time."""
    with pytest.raises(ValueError, match="Neumann/Robin"):
        VarNet(_pde(analytic, "steady_ad_1d_neumann"), diff_fn=lambda p, x, t: p,
               diff_init=np.zeros(1), **MESH)


@pytest.mark.parametrize("name", FLUX)
def test_flux_problems_have_flux_rows_in_both_packages(name):
    """Both packages build the same flux rows for these problems."""
    kw = dict(b_disc_num=4)
    ours = build_fixed_data(_pde(analytic, name), 4, **kw)
    ref = jas.build_fixed_data(_pde(jax_analytic, name), 4, **kw)
    assert ours.neu is not None and ref.neu is not None
    for field, a, b in zip(ours.neu._fields, ours.neu, ref.neu):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=field)


@pytest.mark.parametrize("hard", [False, True], ids=["penalty", "hard"])
@pytest.mark.parametrize("factory", ["steady_ad_1d", "steady_ad_2d"])
def test_dirichlet_problems_still_build(factory, hard):
    vn = VarNet(getattr(analytic, factory)()["pde"], layer_width=(8, 8), hard_bc=hard,
                **MESH)
    assert vn.fixed.neu is None
    assert (vn.hard is not None) == hard
    assert vn.evaluate(vn.fixed.quad.coords.reshape(-1, vn.static.n_inputs)[:5]).shape[0] == 5
