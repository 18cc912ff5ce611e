"""The rest of the port's single-device API against the JAX package on the CPU:

* ``make_loss_fn(normalize_residual=False)`` (the reference's raw sum of r_k^2):
  loss terms (rtol 1e-5) and gradients (rtol 1e-4) at a seeded theta, fused and
  general, and ``train(normalize_residual=False)`` on it;
* ``evaluate_grad``: u, grad u and u_t within 1e-5 of JAX's, penalty and exact
  BC, through the plain chain and the value + jacobian Function;
* ``train``'s other new arguments: ``value_and_jac`` (the general path),
  ``matmul_precision`` (reduced values raise), ``profile_dir`` (a Chrome trace is
  written) and ``debug_nans`` (a NaN leaf raises ``FloatingPointError`` naming
  the epoch; autograd's anomaly mode is left as it was found).
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.fem.assembly import PointData as JPoints
from varnet_tpu.fem.assembly import QuadData as JQuad
from varnet_tpu.fem.assembly import build_fixed_data
from varnet_tpu.ops.pallas_residual import pallas_fused_residual
from varnet_tpu.problems import analytic as jax_analytic
from varnet_tpu.train.loss import make_loss_fn as jax_make_loss_fn
from varnet_tpu_torch import VarNet, params_from_jax
from varnet_tpu_torch.fem.assembly import PointData, QuadData
from varnet_tpu_torch.models.mlp import make_input_scaling, mlp_value_and_jac
from varnet_tpu_torch.ops.fused_residual import prepare_residual_data
from varnet_tpu_torch.problems import analytic
from varnet_tpu_torch.train.loss import make_loss_fn
from _torch_threads import _one_intra_op_thread  # noqa: F401


MESH = dict(layer_width=(10, 10), disc_num=6, b_disc_num=5, t_disc_num=3)
W = (1.0, 10.0, 10.0)


def _theta(n_in, widths, seed=0):
    rng = np.random.default_rng(seed)
    sizes = (n_in,) + widths + (1,)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b))).astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "general"])
def test_unnormalized_loss_matches_jax(fused):
    fd = build_fixed_data(jax_analytic.transient_ad_2d()["pde"], 8, b_disc_num=6,
                          t_disc_num=4)
    st = fd.static
    raw = _theta(st.n_inputs, (12, 12))
    hook = (functools.partial(pallas_fused_residual, time_dependent=True, has_react=False,
                              interpret=True, tile=fd.quad.coords.shape[0]) if fused else None)
    jloss = jax_make_loss_fn(st, fused_residual=hook, normalize_residual=False)
    f32 = lambda t: [jnp.asarray(a, jnp.float32) for a in t]  # noqa: E731
    (jtot, jaux), jgrad = jax.value_and_grad(
        lambda th: jloss(th, JQuad(*f32(fd.quad)), JPoints(*f32(fd.bc)), JPoints(*f32(fd.ic)),
                         None, jnp.asarray(W + (0.0,), jnp.float32)),
        has_aux=True)([{k: jnp.asarray(v) for k, v in layer.items()} for layer in raw])

    prepared = None
    if fused:
        scale, shift = make_input_scaling(st.input_lo, st.input_hi)
        prepared = prepare_residual_data(fd.quad, scale, shift, time_dependent=True,
                                         has_react=False)
    t32 = lambda t: [torch.from_numpy(np.asarray(a, np.float32)) for a in t]  # noqa: E731
    theta = params_from_jax(raw)
    leaves = [layer[k] for layer in theta for k in ("w", "b")]
    for v in leaves:
        v.requires_grad_(True)
    tot, aux = make_loss_fn(st, fused=fused, normalize_residual=False)(
        theta, QuadData(*t32(fd.quad)), PointData(*t32(fd.bc)), PointData(*t32(fd.ic)), W,
        prepared)
    grads = torch.autograd.grad(tot, leaves)

    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-5)
    for key in jaux:
        np.testing.assert_allclose(float(aux[key].detach()), float(jaux[key]), rtol=1e-5,
                                   err_msg=key)
    # the raw sum differs from the normalized mean: the switch does something
    normed = make_loss_fn(st, fused=fused)(theta, QuadData(*t32(fd.quad)),
                                           PointData(*t32(fd.bc)), PointData(*t32(fd.ic)),
                                           W, prepared)[1]["loss_int"]
    assert abs(float(normed) - float(aux["loss_int"])) > 1e-3 * float(aux["loss_int"])
    for g, jg in zip(grads, [np.asarray(layer[k]) for layer in jgrad for k in ("w", "b")]):
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max())


def test_train_unnormalized_follows_jax():
    """5 Adam epochs with normalize_residual=False from one theta: losses within
    the Adam band (rtol 2e-4)."""
    train = dict(epoch_num=5, weight=W, save_freq=1, verbose=False, error_disc=6,
                 error_times=2, normalize_residual=False)
    jvn = JaxVarNet(jax_analytic.transient_ad_2d()["pde"], n_devices=1, **MESH)
    theta0 = jax.tree_util.tree_map(np.asarray, jvn.theta)
    jres = jvn.train(**train)
    vn = VarNet(analytic.transient_ad_2d()["pde"], device="cpu", **MESH)
    vn.theta = params_from_jax(theta0)
    res = vn.train(**train)
    np.testing.assert_allclose([r["loss"] for r in res.losses],
                               [r["loss"] for r in jres.losses], rtol=2e-4)


POINTS = np.random.default_rng(4).uniform(0.05, 0.95, (57, 2))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernel_fn"])
@pytest.mark.parametrize("hard", [False, True], ids=["penalty", "hard"])
def test_evaluate_grad_matches_jax(hard, use_pallas):
    jvn = JaxVarNet(jax_analytic.transient_ad_2d()["pde"], n_devices=1, hard_bc=hard,
                    seed=3, **MESH)
    vn = VarNet(analytic.transient_ad_2d()["pde"], device="cpu", hard_bc=hard,
                use_pallas=use_pallas, **MESH)
    vn.theta = params_from_jax(jax.tree_util.tree_map(np.asarray, jvn.theta))
    t = np.linspace(0.0, 0.5, len(POINTS))
    ref = jvn.evaluate_grad(POINTS, t)
    ours = vn.evaluate_grad(POINTS, t, chunk=20)   # three chunks
    assert set(ours) == set(ref) == {"u", "grad", "u_t"}
    for key in ref:
        assert ours[key].shape == np.shape(ref[key])
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-5,
                                   atol=1e-5 * np.abs(ref[key]).max(), err_msg=key)
    np.testing.assert_allclose(ours["u"], vn.evaluate(POINTS, t), rtol=1e-6, atol=1e-7)


def test_evaluate_grad_steady_has_no_u_t():
    vn = VarNet(analytic.steady_ad_2d()["pde"], layer_width=(6, 6), disc_num=4, device="cpu")
    out = vn.evaluate_grad(POINTS)
    assert set(out) == {"u", "grad"} and out["grad"].shape == (len(POINTS), 2)


def _vn(**kw):
    return VarNet(analytic.transient_ad_2d()["pde"], device="cpu", **MESH, **kw)


def test_value_and_jac_override_takes_the_general_path():
    train = dict(epoch_num=3, weight=W, save_freq=1, verbose=False, error_disc=6,
                 error_times=2)
    calls = []

    def counted(*args):
        calls.append(1)
        return mlp_value_and_jac(*args)

    a = _vn().train(value_and_jac=counted, **train)
    b = _vn(use_fused_residual=False).train(**train)
    assert len(calls) == 3
    np.testing.assert_allclose([r["loss"] for r in a.losses], [r["loss"] for r in b.losses],
                               rtol=1e-6)


def test_matmul_precision_reduced_raises():
    with pytest.raises(NotImplementedError, match="not ported"):
        _vn().train(epoch_num=1, verbose=False, matmul_precision="default")
    res = _vn().train(epoch_num=1, verbose=False, error_disc=4, error_times=2,
                      matmul_precision="highest")
    assert np.isfinite(res.losses[-1]["loss"])


def test_profile_dir_writes_a_trace(tmp_path):
    folder = str(tmp_path / "prof")
    _vn().train(epoch_num=5, save_freq=5, verbose=False, error_disc=4, error_times=2,
                profile_dir=folder, profile_steps=2)
    (name,) = os.listdir(folder)
    assert name == "trace_from_epoch_2.json"
    with open(os.path.join(folder, name)) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


@pytest.mark.parametrize("anomaly_before", [False, True])
def test_debug_nans_raises_on_a_nan_leaf(anomaly_before):
    vn = _vn()
    vn.theta[1]["b"][0] = float("nan")
    torch.autograd.set_detect_anomaly(anomaly_before)
    try:
        with pytest.raises(FloatingPointError, match="at epoch 1"):
            vn.train(epoch_num=3, save_freq=3, verbose=False, debug_nans=True)
        assert torch.is_anomaly_enabled() is anomaly_before
    finally:
        torch.autograd.set_detect_anomaly(False)
    # without the flag the NaN trains on silently, as in JAX
    res = vn.train(epoch_num=2, save_freq=2, verbose=False, error_disc=4, error_times=2)
    assert np.isnan(res.losses[-1]["loss"])


@pytest.mark.parametrize("fault", ["kernel_error", "nan_gradient"])
def test_debug_nans_in_the_backward(fault, monkeypatch):
    """Under debug_nans a NaN that only the backward makes (K1/K2's gradient here)
    raises FloatingPointError naming the epoch, from anomaly mode's report; an
    error of the kernel's own passes unchanged."""
    from varnet_tpu_torch.ops import fused_residual as fr

    plain_bwd = fr.dir_residual_bwd

    def bwd(params, data, activation, gr):
        if fault == "kernel_error":
            raise RuntimeError("vr_bwd: unspecified launch failure")
        grads = plain_bwd(params, data, activation, gr)
        grads[0]["w"] = torch.full_like(grads[0]["w"], float("nan"))
        return grads

    monkeypatch.setattr(fr, "dir_residual_bwd", bwd)
    expected = (RuntimeError, "unspecified launch failure") if fault == "kernel_error" else (
        FloatingPointError, "NaN in the backward at epoch 1")
    with pytest.raises(expected[0], match=expected[1]):
        _vn().train(epoch_num=3, save_freq=3, verbose=False, debug_nans=True)
    assert not torch.is_anomaly_enabled()
