"""SIREN (sin-activation) nets in the port against the JAX package, on the CPU.

``init_siren``'s bounds, zero biases and draws; ``VarNet(activation="sin",
omega0=)`` drawing its net from those bounds (with and without Fourier
features); and the slice on the flagship problem at a small mesh (transient
2-D AD, disc 8 / t_disc 4, w16x2) from a JAX ``init_siren`` theta carried over
by ``params_from_jax``: the loss and its gradients at that theta (rtol 1e-5 /
1e-4: f32 sums in another order), 20 Adam epochs (rtol 2e-4, the Adam band of
``__graft_entry__.py``) and 2 LM iterations (rtol 2e-2, its LM band), on the
fused path (K1/K2's plain version, LM through the value+jac Function) and the
general path; then the same with exact BC on the 1-D transient problem (K4's
plain version), with Fourier features (F 8, w16x2, the JAX B carried over by
``fourier_b=``: K2-FF's plain version, LM through K7 / K8's) and on viscous Burgers
(the 1-D traveling front, w12x2: the jacobian-panel residual K3's plain version).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.fem.assembly import PointData as JPoints
from varnet_tpu.fem.assembly import QuadData as JQuad
from varnet_tpu.fem.assembly import build_fixed_data as jax_build_fixed_data
from varnet_tpu.models import mlp as jax_mlp
from varnet_tpu.models.mlp import init_siren as jax_init_siren
from varnet_tpu.ops.pallas_residual import pallas_fused_residual
from varnet_tpu.problems import analytic as jax_analytic
from varnet_tpu.train.loss import make_loss_fn as jax_make_loss_fn
from varnet_tpu_torch import VarNet, init_siren, params_from_jax
from varnet_tpu_torch.fem.assembly import PointData, QuadData
from varnet_tpu_torch.models import mlp as port_mlp
from varnet_tpu_torch.models.mlp import init_mlp, make_input_scaling, params_to_numpy
from varnet_tpu_torch.ops.fused_residual import prepare_residual_data
from varnet_tpu_torch.problems import analytic
from varnet_tpu_torch.train.loss import make_loss_fn
from _torch_threads import _one_intra_op_thread  # noqa: F401


MESH = dict(layer_width=(16, 16), disc_num=8, b_disc_num=6, t_disc_num=4, activation="sin")
ADAM = dict(epoch_num=20, weight=(1.0, 10.0, 10.0), save_freq=1, verbose=False,
            error_disc=8, error_times=2)
LM = dict(steps=2, weight=(1.0, 10.0, 10.0), cg_iters=5, save_freq=1, verbose=False,
          error_disc=8, error_times=2)
HARD = dict(layer_width=(16, 16), disc_num=12, t_disc_num=4, activation="sin", hard_bc=True)
HARD_ADAM = dict(epoch_num=20, save_freq=1, verbose=False, error_disc=16, error_times=2)
HARD_LM = dict(steps=2, cg_iters=5, save_freq=1, verbose=False, error_disc=16, error_times=2,
               k_chunks=2)
FF = dict(MESH, fourier_features=8)
BURG = dict(layer_width=(12, 12), disc_num=12, t_disc_num=6, activation="sin")
BURG_ADAM = dict(ADAM, error_disc=32, error_times=3)
BURG_LM = dict(LM, error_disc=32, error_times=3, k_chunks=2)


def _bounds(n_in, widths, omega0):
    sizes = [n_in] + list(widths)
    return [omega0 / sizes[0]] + [np.sqrt(6.0 / a) for a in sizes[1:]]


def _assert_siren(params, n_in, widths, omega0):
    """Every weight within its SIREN bound and the draw spread over it (the
    largest |w| of a layer above 80% of its bound); biases zero."""
    for layer, bound in zip(params, _bounds(n_in, widths, omega0)):
        w = layer["w"].detach().cpu().numpy()
        assert np.abs(w).max() <= bound * (1 + 1e-6)
        assert np.abs(w).max() > 0.8 * bound
        assert not layer["b"].detach().cpu().numpy().any()


@pytest.mark.parametrize("omega0", [6.0, 30.0])
def test_init_siren_bounds_zero_biases_and_draws(omega0):
    params = init_siren(torch.Generator().manual_seed(0), 3, (16, 24), omega0=omega0)
    assert [tuple(p["w"].shape) for p in params] == [(3, 16), (16, 24), (24, 1)]
    assert all(p["w"].dtype == torch.float32 for p in params)
    _assert_siren(params, 3, (16, 24, 1), omega0)
    again = init_siren(torch.Generator().manual_seed(0), 3, (16, 24), omega0=omega0)
    other = init_siren(torch.Generator().manual_seed(1), 3, (16, 24), omega0=omega0)
    for a, b, c in zip(params, again, other):
        assert torch.equal(a["w"], b["w"]) and not torch.equal(a["w"], c["w"])


def test_varnet_sin_draws_a_siren_net():
    """``VarNet(activation="sin")`` starts from SIREN's uniform bounds (at
    ``omega0``; layer 0 at the embedding's 2F inputs with Fourier features), as
    the JAX package's ``VarNet`` does, and keeps the JAX package's config keys;
    tanh still draws ``init_mlp``'s Glorot-normal net."""
    pde = analytic.transient_ad_2d()["pde"]
    kw = {**MESH, "device": "cpu"}
    _assert_siren(VarNet(pde, **kw).theta, 3, (16, 16, 1), 6.0)
    _assert_siren(VarNet(pde, omega0=30.0, **kw).theta, 3, (16, 16, 1), 30.0)
    _assert_siren(VarNet(pde, fourier_features=4, **kw).theta, 8, (16, 16, 1), 6.0)
    assert "omega0" not in VarNet(pde, **kw).config_dict()
    tanh = VarNet(pde, **{**kw, "activation": "tanh"}).theta
    ref = init_mlp(torch.Generator().manual_seed(0), 3, (16, 16))
    for a, b in zip(tanh, ref):
        assert torch.equal(a["w"], b["w"])


def _jax_theta(n_in, widths, seed=0):
    """A JAX ``init_siren`` net (omega0 6) as host arrays."""
    theta = jax_init_siren(jax.random.PRNGKey(seed), n_in, widths, omega0=6.0)
    return jax.tree_util.tree_map(np.asarray, theta)


def _f32(t):
    return type(t)(*(np.asarray(a, np.float32) for a in t))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "general"])
def test_sin_loss_and_grads_match_jax(fused):
    fd = jax_build_fixed_data(jax_analytic.transient_ad_2d()["pde"], MESH["disc_num"],
                              b_disc_num=MESH["b_disc_num"], t_disc_num=MESH["t_disc_num"])
    st = fd.static
    raw = _jax_theta(st.n_inputs, MESH["layer_width"], seed=4)
    k = fd.quad.coords.shape[0]
    hook = (functools.partial(pallas_fused_residual, time_dependent=True, has_react=False,
                              interpret=True, tile=k) if fused else None)
    jloss = jax_make_loss_fn(st, activation="sin", fused_residual=hook)
    jpts = [None if p is None else T(*(jnp.asarray(a, jnp.float32) for a in p))
            for p, T in ((fd.quad, JQuad), (fd.bc, JPoints), (fd.ic, JPoints))]
    (jtot, jaux), jgrad = jax.value_and_grad(
        lambda th: jloss(th, *jpts, None, jnp.asarray([1.0, 10.0, 10.0, 0.0], jnp.float32)),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, raw))

    prepared = None
    if fused:
        scale, shift = make_input_scaling(st.input_lo, st.input_hi)
        prepared = prepare_residual_data(fd.quad, scale, shift, time_dependent=True,
                                         has_react=False)
    tloss = make_loss_fn(st, activation="sin", fused=fused)
    pts = [None if p is None else T(*(torch.from_numpy(a) for a in _f32(p)))
           for p, T in ((fd.quad, QuadData), (fd.bc, PointData), (fd.ic, PointData))]
    leaves = [v.requires_grad_(True) for layer in params_from_jax(raw) for v in
              (layer["w"], layer["b"])]
    theta = [{"w": leaves[i], "b": leaves[i + 1]} for i in range(0, len(leaves), 2)]
    tot, aux = tloss(theta, *pts, (1.0, 10.0, 10.0), prepared)
    grads = torch.autograd.grad(tot, leaves)
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-5)
    for key in ("loss_int", "loss_bc", "loss_ic"):
        np.testing.assert_allclose(float(aux[key].detach()), float(jaux[key]), rtol=1e-5)
    for g, gj in zip(grads, [np.asarray(lay[k2]) for lay in jgrad for k2 in ("w", "b")]):
        np.testing.assert_allclose(g.numpy(), gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())


def _jax_ff_b(n_in, n_feat=8, seed=5):
    """A seeded multiscale B [n_in, F] (scales 0.5 and 2), as host f32."""
    rng = np.random.default_rng(seed)
    return np.concatenate([0.5 * rng.standard_normal((n_in, n_feat // 2)),
                           2.0 * rng.standard_normal((n_in, n_feat - n_feat // 2))],
                          1).astype(np.float32)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "general"])
@pytest.mark.parametrize("case", ["ff", "burgers"])
def test_sin_ff_and_burgers_loss_and_grads_match_jax(case, fused):
    """The loss and its gradients at a JAX ``init_siren`` theta (rtol 1e-5 / 1e-4), on
    the fused path (K2-FF's plain version against the Pallas kernel with
    ``fourier_bt``; K3's against it with ``directional=False, nl_vec``) and the general
    path: a SIREN net behind F 8 Fourier features on the flagship problem, and one on
    the 1-D Burgers traveling front."""
    if case == "ff":
        pde = jax_analytic.transient_ad_2d()["pde"]
        fd = jax_build_fixed_data(pde, MESH["disc_num"], b_disc_num=MESH["b_disc_num"],
                                  t_disc_num=MESH["t_disc_num"])
        b = _jax_ff_b(fd.static.n_inputs)
        raw = _jax_theta(2 * b.shape[1], MESH["layer_width"], seed=6)
    else:
        pde = jax_analytic.burgers_1d_transient()["pde"]
        fd = jax_build_fixed_data(pde, BURG["disc_num"], t_disc_num=BURG["t_disc_num"])
        b = None
        raw = _jax_theta(fd.static.n_inputs, BURG["layer_width"], seed=7)
    st = fd.static
    k = fd.quad.coords.shape[0]
    nl = None if pde.nl_adv is None else tuple(float(v) for v in np.atleast_1d(pde.nl_adv))
    jkw, tkw = {"nl_vec": pde.nl_adv}, {"nl_vec": pde.nl_adv}
    if b is not None:
        jkw.update(value_and_jac=functools.partial(jax_mlp.ff_value_and_jac, jnp.asarray(b)),
                   apply_fn=functools.partial(jax_mlp.ff_apply, jnp.asarray(b)))
        tb = torch.from_numpy(b)
        tkw.update(value_and_jac=functools.partial(port_mlp.ff_value_and_jac, tb),
                   apply_fn=functools.partial(port_mlp.ff_apply, tb))
    bt = None if b is None else (2.0 * np.pi) * b.T
    hook = (functools.partial(pallas_fused_residual, time_dependent=True, has_react=False,
                              interpret=True, tile=k, directional=b is not None,
                              fourier_bt=None if bt is None else jnp.asarray(bt), nl_vec=nl)
            if fused else None)
    jloss = jax_make_loss_fn(st, activation="sin", fused_residual=hook, **jkw)
    jpts = [None if p is None else T(*(jnp.asarray(a, jnp.float32) for a in p))
            for p, T in ((fd.quad, JQuad), (fd.bc, JPoints), (fd.ic, JPoints))]
    (jtot, jaux), jgrad = jax.value_and_grad(
        lambda th: jloss(th, *jpts, None, jnp.asarray([1.0, 10.0, 10.0, 0.0], jnp.float32)),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, raw))

    prepared = None
    if fused:
        scale, shift = make_input_scaling(st.input_lo, st.input_hi)
        prepared = prepare_residual_data(fd.quad, scale, shift, time_dependent=True,
                                         has_react=False, nl_vec=pde.nl_adv,
                                         jacobian=b is None,
                                         fourier_bt=None if bt is None else bt.astype(np.float32))
    tloss = make_loss_fn(st, activation="sin", fused=fused, **tkw)
    pts = [None if p is None else T(*(torch.from_numpy(a) for a in _f32(p)))
           for p, T in ((fd.quad, QuadData), (fd.bc, PointData), (fd.ic, PointData))]
    leaves = [v.requires_grad_(True) for layer in params_from_jax(raw) for v in
              (layer["w"], layer["b"])]
    theta = [{"w": leaves[i], "b": leaves[i + 1]} for i in range(0, len(leaves), 2)]
    tot, aux = tloss(theta, *pts, (1.0, 10.0, 10.0), prepared)
    grads = torch.autograd.grad(tot, leaves)
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-5)
    for key in ("loss_int", "loss_bc", "loss_ic"):
        np.testing.assert_allclose(float(aux[key].detach()), float(jaux[key]), rtol=1e-5)
    for g, gj in zip(grads, [np.asarray(lay[k2]) for lay in jgrad for k2 in ("w", "b")]):
        np.testing.assert_allclose(g.numpy(), gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())


def _jax_run(factory, kw, adam, lm):
    """The JAX package's Adam run from its own ``init_siren`` draw, then LM from
    where Adam ended: (theta0, Adam result, theta after Adam, LM result, its Fourier
    B or None)."""
    vn = JaxVarNet(getattr(jax_analytic, factory)()["pde"], n_devices=1, **kw)
    theta0 = jax.tree_util.tree_map(np.asarray, vn.theta)
    b = None if vn.fourier_b is None else np.asarray(vn.fourier_b)
    res = vn.train(**adam)
    theta1 = jax.tree_util.tree_map(np.asarray, vn.theta)
    return theta0, res, theta1, vn.refine_lm(**lm), b


@pytest.fixture(scope="module")
def jax_penalty():
    return _jax_run("transient_ad_2d", MESH, ADAM, LM)


@pytest.fixture(scope="module")
def jax_hard():
    return _jax_run("transient_ad_1d", HARD, HARD_ADAM, HARD_LM)


@pytest.fixture(scope="module")
def jax_ff():
    return _jax_run("transient_ad_2d", FF, ADAM, LM)


@pytest.fixture(scope="module")
def jax_burgers():
    return _jax_run("burgers_1d_transient", BURG, BURG_ADAM, BURG_LM)


def _assert_trajectory(res, jres, rtol, keys):
    assert res.epochs == jres.epochs
    for key in keys:
        np.testing.assert_allclose([r[key] for r in res.losses],
                                   [r[key] for r in jres.losses], rtol=rtol, err_msg=key)
    np.testing.assert_allclose(res.errors, jres.errors, rtol=rtol)


CASES = {"penalty": ("transient_ad_2d", MESH, ADAM, LM, ("loss", "loss_int", "loss_bc",
                                                          "loss_ic")),
         "hard": ("transient_ad_1d", HARD, HARD_ADAM, HARD_LM, ("loss", "loss_int")),
         "ff": ("transient_ad_2d", FF, ADAM, LM, ("loss", "loss_int", "loss_bc", "loss_ic")),
         "burgers": ("burgers_1d_transient", BURG, BURG_ADAM, BURG_LM,
                     ("loss", "loss_int", "loss_bc", "loss_ic"))}
# the fused path's residual route: K1/K2, K4, K2-FF, K3
FUSED_KIND = {"penalty": "dir", "hard": "precoeff", "ff": "dir", "burgers": "jac"}


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "general"])
@pytest.mark.parametrize("case", list(CASES))
def test_sin_adam_and_lm_match_jax(request, case, fused):
    """20 Adam epochs from the JAX package's ``init_siren`` theta (rtol 2e-4),
    then 2 LM iterations from where its Adam ended (rtol 2e-2): the fused path
    runs K1/K2's (penalty), K4's (exact BC), K2-FF's (Fourier features, the JAX B)
    or K3's (Burgers) plain version and LM the value+jac Functions' (K7 / K8's
    with Fourier features); the general path neither."""
    factory, kw, adam, lm, keys = CASES[case]
    theta0, jres, theta1, jlm, b = request.getfixturevalue(f"jax_{case}")
    pde = getattr(analytic, factory)()["pde"]
    vn = VarNet(pde, device="cpu", use_fused_residual=fused, use_pallas=fused, fourier_b=b,
                **kw)
    assert vn._fused_kind == (FUSED_KIND[case] if fused else None)
    vn.theta = params_from_jax(theta0)
    _assert_trajectory(vn.train(**adam), jres, 2e-4, keys)
    for a, b in zip(params_to_numpy(vn.theta), theta1):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=2e-4 * np.abs(b[k]).max())
    vn.theta = params_from_jax(theta1)
    res = vn.refine_lm(**lm)
    assert res.epochs == [1, 2]
    _assert_trajectory(res, jlm, 2e-2, ("loss", "lam"))
