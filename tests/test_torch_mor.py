"""Parametric (MOR) training through the port against the JAX package on the
CPU, on ``mor_steady_ad_2d`` (velocity (mu, 0), four samples of mu): the fixed
data bit-equal (the mu columns included), the loss terms and parameter
gradients at a fixed theta through the fused residual and the general path
(rtol 1e-5 / 1e-4, as ``tests/test_torch_loss.py``), and 20 Adam epochs from the
same theta (rtol 2e-4, the Adam band of ``__graft_entry__.py``), with the
per-sample rel-L2 of the amortized net."""

import jax
import numpy as np
import pytest
import torch

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.problems.analytic import mor_steady_ad_2d as jax_mor
from varnet_tpu.train.loss import make_loss_fn as jax_make_loss_fn
from varnet_tpu_torch import VarNet, params_from_jax
from varnet_tpu_torch.ops.fused_residual import prepare_residual_data
from varnet_tpu_torch.problems.analytic import mor_steady_ad_2d
from varnet_tpu_torch.train.loss import make_loss_fn

MESH = dict(layer_width=(12, 12), disc_num=6, b_disc_num=6)
W = (1.0, 10.0)
TRAIN = dict(epoch_num=20, weight=W, save_freq=1, verbose=False, error_disc=8)


@pytest.fixture(scope="module")
def jax_run():
    vn = JaxVarNet(jax_mor()["pde"], n_devices=1, **MESH)
    theta0 = jax.tree_util.tree_map(np.asarray, vn.theta)
    res = vn.train(**TRAIN)
    return vn, theta0, res


def _port(theta, **kw):
    vn = VarNet(mor_steady_ad_2d()["pde"], device="cpu", **{**MESH, **kw})
    vn.theta = params_from_jax(theta)
    return vn


def test_mor_fixed_data_bit_equal(jax_run):
    jvn = jax_run[0]
    port = _port(jax_run[1])
    assert port.static.n_mor == jvn.static.n_mor == 1
    assert port.static.n_inputs == 3
    for part in ("quad", "bc"):
        for field, a, b in zip(getattr(port.fixed, part)._fields, getattr(port.fixed, part),
                               getattr(jvn.fixed, part)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{part}.{field}")


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "general"])
def test_mor_loss_and_grads_match_jax(jax_run, fused):
    jvn, theta0, _ = jax_run
    st = jvn.static
    jloss = jax_make_loss_fn(st)
    pad = jvn.fixed
    jquad = type(pad.quad)(*(jax.numpy.asarray(a, jax.numpy.float32) for a in pad.quad))
    jbc = type(pad.bc)(*(jax.numpy.asarray(a, jax.numpy.float32) for a in pad.bc))
    w4 = jax.numpy.asarray([W[0], W[1], 0.0, 0.0], jax.numpy.float32)
    (jtot, jaux), jgrad = jax.value_and_grad(
        lambda th: jloss(th, jquad, jbc, None, None, w4), has_aux=True)(
        [{k: jax.numpy.asarray(v) for k, v in layer.items()} for layer in theta0])

    port = _port(theta0)
    quad, bc = port._to_device(port.fixed.quad), port._to_device(port.fixed.bc)
    prepared = (prepare_residual_data(quad, port.scale, port.shift, time_dependent=False,
                                      has_react=False, device="cpu") if fused else None)
    loss = make_loss_fn(port.static, fused=fused, device="cpu")
    theta = params_from_jax(theta0)
    leaves = [layer[k] for layer in theta for k in ("w", "b")]
    for v in leaves:
        v.requires_grad_(True)
    tot, aux = loss(theta, quad, bc, None, W + (0.0,), prepared)
    grads = torch.autograd.grad(tot, leaves)
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-5)
    for key in aux:
        np.testing.assert_allclose(float(aux[key].detach()), float(jaux[key]), rtol=1e-5,
                                   err_msg=key)
    jleaves = [np.asarray(layer[k]) for layer in jgrad for k in ("w", "b")]
    for g, jg in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max())


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "general"])
def test_mor_adam_matches_jax(jax_run, fused):
    jvn, theta0, jres = jax_run
    port = _port(theta0, use_fused_residual=fused)
    res = port.train(**TRAIN)
    assert res.epochs == jres.epochs
    for key in ("loss", "loss_int", "loss_bc"):
        np.testing.assert_allclose([r[key] for r in res.losses],
                                   [r[key] for r in jres.losses], rtol=2e-4, err_msg=key)
    np.testing.assert_allclose(res.errors, jres.errors, rtol=2e-4)
    # the amortized net evaluated per sample of mu, as mor_1d scores it
    x = np.random.default_rng(0).random((64, 2))
    for mu in port.pde.mor.samples:
        np.testing.assert_allclose(port.evaluate(x, mu=mu), np.asarray(jvn.evaluate(x, mu=mu)),
                                   rtol=2e-4, atol=2e-4)
