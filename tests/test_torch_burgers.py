"""Viscous Burgers (nonlinear advection, ``ADPDE(nl_adv=b)``) in the port against
the JAX package on the CPU: ``weak_residual(nl_vec=)``; the loss and its
gradients at a fixed theta (penalty on K3's plain version and on the general
path, exact BC on the general path with the transformed u); a 20-epoch Adam
trajectory (rtol 2e-4, the Adam band of ``test_torch_train.py``); 2 LM iterations
(rtol 2e-2, the LM band of ``test_torch_lm.py``); ``test_residuals``; the routing
of the Adam step's residual (``_fused_kind`` against ``_fused_residual_hook``);
the ``burgers_1d`` CLI.  The Burgers loss is nonconvex: both packages start
from the same theta.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.fem.assembly import build_fixed_data as jax_build_fixed_data
from varnet_tpu.fem.hardbc import HardBC as JaxHardBC
from varnet_tpu.ops.residual import weak_residual as jax_weak_residual
from varnet_tpu.problems import analytic as jax_analytic
from varnet_tpu.train.loss import make_loss_fn as jax_make_loss_fn
from varnet_tpu_torch import VarNet, params_from_jax
from varnet_tpu_torch.examples import burgers_1d
from varnet_tpu_torch.fem.hardbc import tables_to
from varnet_tpu_torch.models.mlp import make_input_scaling
from varnet_tpu_torch.ops.fused_residual import prepare_residual_data
from varnet_tpu_torch.ops.residual import weak_residual
from varnet_tpu_torch.problems import analytic
from varnet_tpu_torch.train.loss import make_loss_fn
from _torch_threads import _one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("per_node", [False, True], ids=["shared", "per-node"])
def test_weak_residual_nl_matches_jax(per_node):
    rng = np.random.default_rng(0)
    k, nq, d = 7, 9, 2
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    tshape = (k, nq) if per_node else (nq,)
    args = [f(k, nq, d), f(*tshape), f(*tshape, d), np.abs(f(*tshape)), f(k, nq),
            f(k, nq, d), f(k, nq), f(k, nq)]
    kw = dict(u=f(k, nq), react=f(k, nq), nl_vec=np.array([0.7, -1.3], np.float32))
    ref = jax_weak_residual(*map(jnp.asarray, args), **{n: jnp.asarray(v) for n, v in kw.items()})
    ours = weak_residual(*map(torch.from_numpy, args),
                         **{n: torch.from_numpy(v) for n, v in kw.items()})
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(ref)).max())


# name, assembly kwargs, time-dependent, exact BC, fused (K3; exact BC with the
# nonlinear term takes the general path only, as in the JAX package)
LOSS_CASES = [
    ("burgers_1d_transient", dict(disc_num=8, t_disc_num=4), True, False, True),
    ("burgers_1d_transient", dict(disc_num=8, t_disc_num=4), True, False, False),
    ("burgers_2d_front", dict(disc_num=4, b_disc_num=4, t_disc_num=3), True, False, True),
    ("burgers_2d_front", dict(disc_num=4, b_disc_num=4, t_disc_num=3), True, False, False),
    ("burgers_1d_steady", dict(disc_num=12), False, False, True),
    ("burgers_1d_transient", dict(disc_num=8, t_disc_num=4), True, True, False),
    ("burgers_1d_steady", dict(disc_num=12), False, True, False),
]


@pytest.mark.parametrize("name,kw,td,hard,fused", LOSS_CASES,
                         ids=[f"{c[0]}-{'hard' if c[3] else 'penalty'}-{'k3' if c[4] else 'general'}"
                              for c in LOSS_CASES])
def test_loss_and_grads_match_jax(name, kw, td, hard, fused):
    pde_j = getattr(jax_analytic, name)()["pde"]
    fd = jax_build_fixed_data(pde_j, **kw)
    st = fd.static
    hq = JaxHardBC(pde_j).tables(np.asarray(fd.quad.coords)) if hard else None
    rng = np.random.default_rng(3)
    sizes = (st.n_inputs, 10, 10, 1)
    raw = [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
            "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
           for a, b in zip(sizes[:-1], sizes[1:])]
    weights = (1.0, 10.0, 10.0) if td else (1.0, 10.0, 0.0, 0.0)

    jloss = jax_make_loss_fn(st, nl_vec=pde_j.nl_adv, hard_mode=hard)
    as_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    extra = {} if hq is None else {"hard": (jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32), hq), None, None)}
    (j_total, j_aux), j_grads = jax.value_and_grad(jloss, has_aux=True)(
        as_j(raw), as_j(fd.quad), as_j(fd.bc), None if fd.ic is None else as_j(fd.ic),
        None, jnp.asarray(weights), **extra)

    quad = type(fd.quad)(*(torch.from_numpy(np.array(a, np.float32)) for a in fd.quad))
    pts = lambda p: type(p)(*(torch.from_numpy(np.array(a, np.float32)) for a in p))  # noqa: E731
    scale, shift = make_input_scaling(st.input_lo, st.input_hi)
    prepared = (prepare_residual_data(fd.quad, scale, shift, time_dependent=td,
                                      has_react=False, nl_vec=pde_j.nl_adv,
                                      jacobian=True)
                if fused else None)
    loss = make_loss_fn(st, fused=fused, nl_vec=pde_j.nl_adv, hard_mode=hard)
    params = params_from_jax(raw)
    leaves = [layer[k] for layer in params for k in ("w", "b")]
    for v in leaves:
        v.requires_grad_(True)
    total, aux = loss(params, quad, pts(fd.bc), None if fd.ic is None else pts(fd.ic),
                      weights, prepared, None if hq is None else tables_to(hq))
    grads = torch.autograd.grad(total, leaves)

    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=2e-5)
    for key in j_aux:
        if key != "loss_obs":
            np.testing.assert_allclose(float(aux[key].detach()), float(j_aux[key]), rtol=2e-5,
                                       atol=1e-12)
    for g, gj in zip(grads, [np.asarray(lay[k]) for lay in j_grads for k in ("w", "b")]):
        np.testing.assert_allclose(g.numpy(), gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())


def test_fused_loss_refuses_data_without_the_burgers_direction():
    fd = jax_build_fixed_data(jax_analytic.burgers_1d_steady()["pde"], 8)
    scale, shift = make_input_scaling(fd.static.input_lo, fd.static.input_hi)
    data = prepare_residual_data(fd.quad, scale, shift, time_dependent=False, has_react=False)
    loss = make_loss_fn(fd.static, fused=True, nl_vec=1.0)
    with pytest.raises(ValueError, match="nl_vec"):
        loss(None, fd.quad, fd.bc, None, (1.0, 1.0), data)


MESH = dict(layer_width=(12, 12), disc_num=12, t_disc_num=6)
TRAIN = dict(epoch_num=20, weight=(1.0, 10.0, 10.0), save_freq=1, verbose=False,
             error_disc=32, error_times=3)
LM = dict(steps=2, weight=(1.0, 10.0, 10.0), cg_iters=5, save_freq=1, verbose=False,
          error_disc=32, error_times=3, k_chunks=2)


@pytest.fixture(scope="module", params=[False, True], ids=["penalty", "hard"])
def jax_run(request):
    """The JAX package's 20 Adam epochs and 2 LM iterations on the 1-D
    traveling front, penalty or exact BC."""
    hard = request.param
    vn = JaxVarNet(jax_analytic.burgers_1d_transient()["pde"], n_devices=1, hard_bc=hard, **MESH)
    theta0 = jax.tree_util.tree_map(np.asarray, vn.theta)
    adam = vn.train(**TRAIN)
    theta1 = jax.tree_util.tree_map(np.asarray, vn.theta)
    lm = vn.refine_lm(**LM)
    return hard, theta0, adam, theta1, lm


def _port(hard, theta, **kw):
    vn = VarNet(analytic.burgers_1d_transient()["pde"], device="cpu", hard_bc=hard,
                **{**MESH, **kw})
    vn.theta = params_from_jax(theta)
    return vn


@pytest.mark.parametrize("fused", [True, False], ids=["k3", "general"])
def test_adam_trajectory_matches_jax(jax_run, fused):
    hard, theta0, jres, _, _ = jax_run
    vn = _port(hard, theta0, use_fused_residual=fused)
    assert vn._fused_kind == ("jac" if fused and not hard else None)
    res = vn.train(**TRAIN)
    assert res.epochs == jres.epochs == list(range(1, 21))
    for key in ("loss", "loss_int", "loss_bc", "loss_ic"):
        np.testing.assert_allclose([r[key] for r in res.losses],
                                   [r[key] for r in jres.losses], rtol=2e-4, atol=1e-12,
                                   err_msg=key)
    np.testing.assert_allclose(res.errors, jres.errors, rtol=2e-4)
    assert res.losses[-1]["loss"] < res.losses[0]["loss"]


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel_fn", "general"])
def test_refine_lm_matches_jax(jax_run, use_pallas):
    hard, _, _, theta1, jlm = jax_run
    res = _port(hard, theta1, use_pallas=use_pallas).refine_lm(**LM)
    assert res.epochs == jlm.epochs == [1, 2]
    for key in ("loss", "lam"):
        np.testing.assert_allclose([r[key] for r in res.losses],
                                   [r[key] for r in jlm.losses], rtol=2e-2, err_msg=key)
    np.testing.assert_allclose(res.errors, jlm.errors, rtol=2e-2)


def test_test_residuals_match_jax(jax_run):
    hard, _, _, theta1, _ = jax_run
    ref = JaxVarNet(jax_analytic.burgers_1d_transient()["pde"], n_devices=1, hard_bc=hard,
                    **MESH).test_residuals(theta1, chunk=40)
    ours = _port(hard, theta1).test_residuals(theta1, chunk=40)
    np.testing.assert_allclose(ours, np.asarray(ref), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(ref)).max())


# (problem, VarNet keyword arguments): every branch of the JAX hook's gate
ROUTES = [
    ("burgers_1d_transient", {}),
    ("burgers_1d_transient", dict(fused_directional=True)),
    ("burgers_1d_transient", dict(fused_precoeff=True)),
    ("burgers_1d_transient", dict(hard_bc=True)),
    ("burgers_1d_transient", dict(fourier_features=4)),
    ("burgers_1d_transient", dict(use_fused_residual=False)),
    ("burgers_2d_front", dict(b_disc_num=4)),
    ("burgers_2d_front", dict(b_disc_num=4, test_order=2)),
    ("transient_ad_1d", {}),
    ("transient_ad_1d", dict(fused_directional=False)),
    ("transient_ad_1d", dict(hard_bc=True)),
    ("transient_ad_1d", dict(hard_bc=True, fused_directional=False)),
    ("transient_ad_1d", dict(fourier_features=4, fused_directional=False)),
    ("transient_ad_1d", dict(fourier_features=4)),
    ("transient_ad_1d", dict(test_order=2)),
    ("transient_ad_1d", dict(test_order=2, fused_directional=False)),
    ("transient_ad_1d", dict(fused_precoeff=True)),
]


def _jax_kind(hook):
    if hook is None:
        return None
    if not hook.keywords["directional"]:
        return "jac"
    return "precoeff" if hook.keywords["precoeff"] else "dir"


@pytest.mark.parametrize("name,kw", ROUTES, ids=[f"{n}-{'-'.join(k) or 'default'}"
                                                 for n, k in ROUTES])
def test_routing_matches_the_jax_hook(name, kw):
    mesh = dict(disc_num=4, t_disc_num=3)
    jvn = JaxVarNet(getattr(jax_analytic, name)()["pde"], n_devices=1, use_pallas=True,
                    **mesh, **kw)
    vn = VarNet(getattr(analytic, name)()["pde"], device="cpu", **mesh, **kw)
    assert vn.fused_directional == jvn.fused_directional
    assert vn._precoeff_selected == jvn._precoeff_selected
    assert vn._fused_kind == _jax_kind(jvn._fused_residual_hook(None))


def test_precoeff_without_directional_is_refused():
    with pytest.raises(ValueError, match="fused_directional"):
        VarNet(analytic.transient_ad_1d()["pde"], disc_num=4, t_disc_num=3, device="cpu",
               fused_precoeff=True, fused_directional=False)


@pytest.mark.parametrize("argv", [
    ["--steady", "--nu", "0.07", "--amp", "1.0"],
    ["--tdisc", "4"],
    ["--tdisc", "4", "--hard-bc"],
], ids=["steady", "transient", "transient-hard"])
def test_cli_runs_on_cpu(argv, capsys):
    vn = burgers_1d.main(argv + ["--width", "8", "--layers", "2", "--disc", "8", "--epochs", "4",
                                 "--save-freq", "2", "--lm-steps", "1", "--lm-cg", "2",
                                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert '"lm_best_rel_l2"' in out and vn.nl_vec is not None
    assert vn._fused_kind == (None if "--hard-bc" in argv else "jac")
