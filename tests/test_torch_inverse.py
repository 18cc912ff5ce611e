"""The port's inverse problems against the JAX package's: observation rows, the
trainable source (``VarNet(source_fn=, source_init=, obs_data=)``) and the trainable
diffusivity and velocity (``diff_fn`` / ``vel_fn``), in penalty and exact-BC mode.

* The inverse-source loss with the fused residual's plain version integrating a
  zeroed source plus the source contraction outside it, against JAX's loss (which
  evaluates the source on its general path): rtol 1e-5, gradients of the net and the
  source net 1e-4.
* Diffusivity and velocity (``tests/test_inverse_diff.py``'s cases): loss and
  gradients, the ``kap`` / ``vel`` leaves included, on the general path.
* Adam trajectories (rtol 2e-4), 2 LM iterations (rtol 2e-2), the 4-slot weights with
  the steady remap, batch_num 2, ``test_residuals``, ``evaluate_field``, and the
  pinned ``theta_inverse_source_wobs100.npz`` (solution < 1e-3, source < 1.2e-2).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.fem import assembly as jas
from varnet_tpu.fem.hardbc import HardBC as JaxHardBC
from varnet_tpu.models.source import make_mlp_source as jax_make_mlp_source
from varnet_tpu.problems import analytic as jax_analytic
from varnet_tpu.train.loss import make_loss_fn as jax_make_loss_fn
from varnet_tpu_torch import VarNet
from varnet_tpu_torch.fem.assembly import PointData, build_fixed_data, pad_points, pad_quad
from varnet_tpu_torch.fem.hardbc import HardBC, tables_to
from varnet_tpu_torch.models.mlp import (
    make_input_scaling,
    params_from_jax,
    tree_leaves,
)
from varnet_tpu_torch.models.source import make_mlp_source
from varnet_tpu_torch.ops.fused_residual import prepare_residual_coeffs, prepare_residual_data
from varnet_tpu_torch.problems import analytic
from varnet_tpu_torch.train.loss import make_loss_fn, obs_weight_slots
from varnet_tpu_torch.utils.helpers import rel_l2_error
from varnet_tpu_torch.utils.io import load_theta_npz
from _torch_threads import _one_intra_op_thread  # noqa: F401


RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "benchmarks",
                       "results")
KAPPA_TRUE = 0.08
SRC_W = (1.0, 10.0, 100.0)      # (w_int, w_bc, w_obs) of the inverse-source recipe


def _torch(t):
    return type(t)(*(None if a is None else torch.from_numpy(np.array(a, dtype=np.float32))
                     for a in t))


def _jnp(t):
    return type(t)(*(None if a is None else jnp.asarray(a, jnp.float32) for a in t))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _losses(res, key="loss"):
    return np.array([rec[key] for rec in res.losses])


# ---------------------------------------------------------------------------
# hooks of both packages (tests/test_inverse_diff.py's)

def _softplus_kappa(psi, x, t):
    return torch.logaddexp(psi[0], torch.zeros_like(psi[0])).expand(x.shape[0])


def _jax_softplus_kappa(psi, x, t):
    return jnp.full((x.shape[0],), jnp.logaddexp(psi[0], 0.0))


def _vel_scalar(phi, x, t):
    return phi[0].expand(x.shape[0], 1)


def _jax_vel_scalar(phi, x, t):
    return jnp.broadcast_to(phi[0], (x.shape[0], 1))


def _coeff_obs():
    case = jax_analytic.steady_ad_1d(kappa=KAPPA_TRUE)
    xs = np.linspace(0.05, 0.95, 25)[:, None]
    return (xs.astype(np.float32), case["c_ex"](xs).astype(np.float32),
            np.ones(len(xs), np.float32))


def _coeff_kwargs(which, port):
    """The hook, its initial leaf (kappa0 = 0.03, v0 = 0.5) and the observations."""
    obs = _coeff_obs()
    if which == "kappa":
        init = np.array([np.log(np.expm1(0.03))])
        kw = dict(diff_fn=_softplus_kappa if port else _jax_softplus_kappa, diff_init=init)
    else:
        kw = dict(vel_fn=_vel_scalar if port else _jax_vel_scalar, vel_init=np.array([0.5]))
    kw["obs_data"] = PointData(*obs) if port else jas.PointData(*obs)
    return kw


def _source_kwargs(port, n_obs=25, hidden=(8,)):
    """The inverse-source hook of each package with the JAX phi0, and the
    observations of inverse_source_2d."""
    case = (analytic if port else jax_analytic).inverse_source_2d(kappa=0.1, n_obs=n_obs)
    lo, hi = case["pde"].domain.bounds
    jfn, phi0 = jax_make_mlp_source(jax.random.PRNGKey(1), 2, hidden=hidden, lo=lo, hi=hi)
    if port:
        fn, _ = make_mlp_source(torch.Generator().manual_seed(1), 2, hidden=hidden, lo=lo, hi=hi)
    obs = (case["obs_x"], case["obs_u"], np.ones(case["obs_x"].shape[0]))
    return case, dict(source_fn=fn if port else jfn, source_init=_host(phi0),
                      obs_data=PointData(*obs) if port else jas.PointData(*obs))


def _pair(factory_or_case, hard, port_kw, jax_kw, **kw):
    """A JAX VarNet and a port VarNet holding its initial theta."""
    if isinstance(factory_or_case, str):
        jpde = getattr(jax_analytic, factory_or_case)(kappa=KAPPA_TRUE)["pde"]
        tpde = getattr(analytic, factory_or_case)(kappa=KAPPA_TRUE)["pde"]
    else:
        jpde, tpde = factory_or_case
    jv = JaxVarNet(jpde, n_devices=1, hard_bc=hard, **jax_kw, **kw)
    vn = VarNet(tpde, device="cpu", hard_bc=hard, **port_kw, **kw)
    vn.theta = params_from_jax(_host(jv.theta))
    return vn, jv


def _source_pair(hard, fused=True, **kw):
    case, pkw = _source_kwargs(True)
    jcase, jkw = _source_kwargs(False)
    return _pair((jcase["pde"], case["pde"]), hard, dict(pkw, use_fused_residual=fused), jkw,
                 **kw)


def _coeff_pair(which, hard, **kw):
    return _pair("steady_ad_1d", hard, _coeff_kwargs(which, True), _coeff_kwargs(which, False),
                 **kw)


# ---------------------------------------------------------------------------
# the loss at a fixed theta


def _fixed_theta_case(hard, path):
    """(port loss terms and grads, JAX's) of the inverse-source loss at the JAX
    initial {net, src} theta on a disc-8 mesh: the port's fused path integrates a
    zeroed source and subtracts the source net's term outside the kernel."""
    case, pkw = _source_kwargs(True)
    jcase, jkw = _source_kwargs(False)
    jfd = jas.build_fixed_data(jcase["pde"], 8, b_disc_num=6)
    fd = build_fixed_data(case["pde"], 8, b_disc_num=6)
    st = fd.static
    jv = JaxVarNet(jcase["pde"], layer_width=(12, 12), disc_num=4, n_devices=1, **jkw)
    theta_h = _host(jv.theta)
    w = obs_weight_slots(SRC_W, False)

    jobs = _jnp(jkw["obs_data"])
    jhard = None
    if hard:
        hb = JaxHardBC(jcase["pde"])
        jhard = (_jnp(hb.tables(jfd.quad.coords)), _jnp(hb.points(jobs.coords)), None)
    jloss = jax_make_loss_fn(jfd.static, source_fn=jkw["source_fn"], has_obs=True,
                             n_obs_real=len(jobs.values), hard_mode=hard)
    (_, jaux), jgrad = jax.value_and_grad(
        lambda th: jloss(th, _jnp(jfd.quad), _jnp(jfd.bc), None, jobs, jnp.asarray(w),
                         hard=jhard), has_aux=True)(jax.tree_util.tree_map(jnp.asarray, theta_h))

    fused = path == "fused"
    quad = pad_quad(fd.quad, 1)
    if fused:
        quad = quad._replace(src=np.zeros_like(quad.src))
    obs = _torch(pkw["obs_data"])
    hq = hard_obs = prepared = None
    if hard:
        hb = HardBC(case["pde"])
        hq, hard_obs = hb.tables(quad.coords), tables_to(hb.points(obs.coords.numpy()))
    if fused:
        scale, shift = make_input_scaling(st.input_lo, st.input_hi)
        prep = prepare_residual_coeffs if hard else prepare_residual_data
        prepared = prep(_torch(quad), scale, shift, time_dependent=False, has_react=False,
                        **({"hard": hq} if hard else {}))
    loss = make_loss_fn(st, fused=fused, hard_mode=hard, source_fn=pkw["source_fn"],
                        has_obs=True, n_obs_real=len(obs.values))
    theta = params_from_jax(theta_h)
    for leaf in tree_leaves(theta):
        leaf.requires_grad_(True)
    tot, aux = loss(theta, _torch(quad), _torch(pad_points(fd.bc, 1)), None, w, prepared,
                    hard=None if hq is None or fused else tables_to(hq), obs=obs,
                    hard_obs=hard_obs)
    grads = torch.autograd.grad(tot, tree_leaves(theta))
    return ({k: float(v.detach()) for k, v in aux.items()}, grads,
            {k: float(v) for k, v in jaux.items()}, jax.tree_util.tree_leaves(jgrad))


@pytest.mark.parametrize("path", ["fused", "general"])
@pytest.mark.parametrize("hard", [False, True], ids=["penalty", "hard"])
def test_inverse_source_loss_and_grads_match_jax(hard, path):
    aux, grads, jaux, jgrads = _fixed_theta_case(hard, path)
    assert set(aux) == set(jaux) and "loss_obs" in aux
    for key in aux:
        np.testing.assert_allclose(aux[key], jaux[key], rtol=1e-5, err_msg=key)
    assert len(grads) == len(jgrads) == 6 + 4   # the net's leaves, then the source net's
    for g, jg in zip(grads, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max())


@pytest.mark.parametrize("hard", [False, True], ids=["penalty", "hard"])
@pytest.mark.parametrize("which", ["kappa", "vel"])
def test_coefficient_loss_and_grads_match_jax(which, hard):
    """The trainable diffusivity / velocity at the JAX initial theta: the loss terms
    and every gradient, the kap / vel leaf's included, on the general path (the
    fused residual declines them)."""
    vn, jv = _coeff_pair(which, hard, layer_width=(10, 10), disc_num=12)
    assert vn._fused_kind is None
    w = obs_weight_slots((1.0, 10.0, 10.0), False)
    hooks = {k: v for k, v in _coeff_kwargs(which, True).items() if k.endswith("_fn")}
    jhooks = {k: v for k, v in _coeff_kwargs(which, False).items() if k.endswith("_fn")}

    loss = make_loss_fn(vn.static, hard_mode=hard, has_obs=True, n_obs_real=25, **hooks)
    theta = vn._params(None)
    for t in tree_leaves(theta):
        t.requires_grad_(True)
    quad_h = pad_quad(vn.fixed.quad, 1)
    hq = None if vn.hard is None else tables_to(vn._hard_tables(quad_h))
    tot, aux = loss(theta, vn._to_device(quad_h), vn._to_device(pad_points(vn.fixed.bc, 1)),
                    None, w, hard=hq, **vn._rows())
    grads = torch.autograd.grad(tot, tree_leaves(theta))

    jloss = jax_make_loss_fn(jv.static, hard_mode=hard, has_obs=True, n_obs_real=25, **jhooks)
    jquad = _jnp(jas.pad_quad(jv.fixed.quad, 1))
    jobs = _jnp(jv.obs_data)
    jhard = None
    if hard:
        jhard = (_jnp(jv.hard.tables(jquad.coords)), _jnp(jv.hard.points(jobs.coords)), None)
    (_, jaux), jgrad = jax.value_and_grad(
        lambda th: jloss(th, jquad, _jnp(jas.pad_points(jv.fixed.bc, 1)), None, jobs,
                         jnp.asarray(w), hard=jhard),
        has_aux=True)(jax.tree_util.tree_map(jnp.asarray, _host(jv.theta)))
    for key in jaux:
        np.testing.assert_allclose(float(aux[key].detach()), float(jaux[key]), rtol=1e-5,
                                   err_msg=key)
    jleaves = jax.tree_util.tree_leaves(jgrad)
    assert len(grads) == len(jleaves)
    for g, jg in zip(grads, jleaves):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max())
    # no silent gradient loss: the coefficient's leaf (kap first, vel last) has one
    assert float(torch.abs(grads[0 if which == "kappa" else -1]).max()) > 0.0


# ---------------------------------------------------------------------------
# training


ADAM = dict(epoch_num=20, save_freq=1, verbose=False, error_disc=8)


@pytest.mark.parametrize("path", ["fused", "general"])
@pytest.mark.parametrize("hard", [False, True], ids=["penalty", "hard"])
def test_inverse_source_adam_matches_jax(hard, path):
    vn, jv = _source_pair(hard, fused=path == "fused", layer_width=(12, 12), disc_num=6,
                          b_disc_num=4)
    assert vn._fused_kind == (None if path == "general" else "precoeff" if hard else "dir")
    res, jres = vn.train(weight=SRC_W, **ADAM), jv.train(weight=SRC_W, **ADAM)
    for key in ("loss", "loss_obs", "loss_int"):
        np.testing.assert_allclose(_losses(res, key), _losses(jres, key), rtol=2e-4,
                                   err_msg=key)
    # both the net and the source net moved
    start = params_from_jax(_source_kwargs(False)[1]["source_init"])
    assert max(float((a - b).abs().max())
               for a, b in zip(tree_leaves(vn.theta["src"]), tree_leaves(start))) > 0.0


@pytest.mark.parametrize("hard", [False, True], ids=["penalty", "hard"])
@pytest.mark.parametrize("which", ["kappa", "vel"])
def test_coefficient_adam_matches_jax(which, hard):
    vn, jv = _coeff_pair(which, hard, layer_width=(12, 12), disc_num=12)
    w = (1.0, 10.0, 10.0)
    res, jres = vn.train(weight=w, **ADAM), jv.train(weight=w, **ADAM)
    np.testing.assert_allclose(_losses(res), _losses(jres), rtol=2e-4)
    leaf = {"kappa": "kap", "vel": "vel"}[which]
    np.testing.assert_allclose(vn.theta[leaf].numpy(), np.asarray(jv.theta[leaf]), rtol=2e-4)
    assert abs(float(vn.theta[leaf][0]) - float(_coeff_kwargs(which, True)[
        f"{'diff' if which == 'kappa' else 'vel'}_init"][0])) > 1e-3


LM = dict(steps=2, cg_iters=20, save_freq=1, verbose=False, error_disc=8)


@pytest.mark.parametrize("case", ["source-penalty", "source-hard", "vel-penalty",
                                  "kappa-hard"])
def test_inverse_lm_matches_jax(case):
    """2 joint LM iterations (net + trainable leaf) from a 200-epoch JAX start, within
    rtol 2e-2; the loss does not rise."""
    which, mode = case.split("-")
    hard = mode == "hard"
    if which == "source":
        vn, jv = _source_pair(hard, layer_width=(12, 12), disc_num=6, b_disc_num=4)
        w = SRC_W
    else:
        vn, jv = _coeff_pair(which, hard, layer_width=(12, 12), disc_num=12)
        w = (1.0, 10.0, 10.0)
    jv.train(weight=w, **dict(ADAM, epoch_num=200, save_freq=200))
    vn.theta = params_from_jax(_host(jv.theta))
    lk, lj = _losses(vn.refine_lm(weight=w, **LM)), _losses(jv.refine_lm(weight=w, **LM))
    np.testing.assert_allclose(lk, lj, rtol=2e-2)
    assert lk[-1] <= lk[0] * (1 + 1e-6)


def test_obs_rows_with_batches_match_jax():
    """batch_num 2: the interior splits, the observation rows stay full-batch."""
    vn, jv = _source_pair(False, layer_width=(8, 8), disc_num=6, b_disc_num=4)
    kw = dict(ADAM, epoch_num=10, batch_num=2, weight=SRC_W)
    np.testing.assert_allclose(_losses(vn.train(**kw)), _losses(jv.train(**kw)), rtol=2e-4)


def test_burgers_with_observation_rows_matches_jax():
    """Nonlinear advection (K3's route) with observation rows of the exact solution."""
    jcase = jax_analytic.burgers_1d_steady()
    xs = np.linspace(0.1, 0.9, 9)[:, None]
    obs = (xs, jcase["c_ex"](xs), np.ones(9))
    vn, jv = _pair((jcase["pde"], analytic.burgers_1d_steady()["pde"]), False,
                   dict(obs_data=PointData(*obs)), dict(obs_data=jas.PointData(*obs)),
                   layer_width=(8, 8), disc_num=12)
    assert vn._fused_kind == "jac"
    kw = dict(ADAM, epoch_num=10, weight=(1.0, 10.0, 10.0))
    res, jres = vn.train(**kw), jv.train(**kw)
    np.testing.assert_allclose(_losses(res), _losses(jres), rtol=2e-4)
    np.testing.assert_allclose(_losses(res, "loss_obs"), _losses(jres, "loss_obs"), rtol=2e-4)


# ---------------------------------------------------------------------------
# the weights, the refusals, the surfaces


@pytest.mark.parametrize("td,weight,slots", [
    (False, (1.0, 10.0), [1.0, 10.0, 0.0, 0.0]),
    (False, (1.0, 10.0, 100.0), [1.0, 10.0, 0.0, 100.0]),
    (True, (1.0, 10.0, 10.0), [1.0, 10.0, 10.0, 0.0]),
    (True, (1.0, 10.0, 10.0, 30.0), [1.0, 10.0, 10.0, 30.0]),
])
def test_weight_slots_and_steady_remap(td, weight, slots):
    assert obs_weight_slots(weight, td) == slots


def test_obs_loss_refuses_a_three_weight_vector():
    """As JAX's loss: a 3-vector has no observation slot."""
    case, pkw = _source_kwargs(True)
    fd = build_fixed_data(case["pde"], 4, b_disc_num=4)
    loss = make_loss_fn(fd.static, has_obs=True, n_obs_real=25)
    net = params_from_jax(_host(JaxVarNet(jax_analytic.steady_ad_2d()["pde"], disc_num=4,
                                          layer_width=(4,), n_devices=1).theta))
    with pytest.raises(ValueError, match="4th"):
        loss(net, _torch(fd.quad), _torch(fd.bc), None, (1.0, 10.0, 100.0),
             obs=_torch(pkw["obs_data"]))
    with pytest.raises(ValueError, match="obs batch is None"):
        loss(net, _torch(fd.quad), _torch(fd.bc), None, (1.0, 10.0, 0.0, 100.0))


@pytest.mark.parametrize("kw,match", [
    (dict(source_fn=lambda p, x, t: x[:, 0]), "source_init"),
    (dict(diff_fn=_softplus_kappa), "diff_init"),
    (dict(vel_fn=_vel_scalar), "vel_init"),
])
def test_hook_without_its_init_raises(kw, match):
    with pytest.raises(ValueError, match=match):
        VarNet(analytic.steady_ad_1d()["pde"], layer_width=(4,), disc_num=4, device="cpu", **kw)


def test_fused_residual_with_a_trainable_coefficient_raises():
    st = build_fixed_data(analytic.steady_ad_1d()["pde"], 4).static
    with pytest.raises(ValueError, match="diff_fn/vel_fn"):
        make_loss_fn(st, fused=True, diff_fn=_softplus_kappa)


def test_diff_fn_loss_matches_fixed_kappa():
    """With diff_fn pinned at the assembled kappa the interior loss equals the plain
    problem's at the same net (tests/test_inverse_diff.py's keystone)."""
    obs = PointData(*_coeff_obs())
    psi0 = np.array([np.log(np.expm1(KAPPA_TRUE))], np.float64)
    pde = analytic.steady_ad_1d(kappa=KAPPA_TRUE)["pde"]
    inv = VarNet(pde, layer_width=(10,), disc_num=12, seed=2, device="cpu",
                 diff_fn=_softplus_kappa, diff_init=psi0, obs_data=obs)
    fix = VarNet(pde, layer_width=(10,), disc_num=12, seed=2, device="cpu")
    r1 = inv.train(epoch_num=1, weight=(1.0, 10.0, 0.0), save_freq=1, verbose=False)
    r2 = fix.train(epoch_num=1, weight=(1.0, 10.0), save_freq=1, verbose=False)
    np.testing.assert_allclose(r1.losses[0]["loss_int"], r2.losses[0]["loss_int"], rtol=1e-5)


def test_evaluate_field_surface():
    case, pkw = _source_kwargs(True)
    jcase, jkw = _source_kwargs(False)
    vn = VarNet(case["pde"], layer_width=(6,), disc_num=4, device="cpu", **pkw)
    jv = JaxVarNet(jcase["pde"], layer_width=(6,), disc_num=4, n_devices=1, **jkw)
    pts = np.random.default_rng(0).uniform(0, 1, (7, 2))
    np.testing.assert_allclose(vn.evaluate_field("source", pts),
                               np.asarray(jv.evaluate_field("source", pts)), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="requires"):
        vn.evaluate_field("kappa", pts)
    kv = VarNet(analytic.steady_ad_1d()["pde"], layer_width=(8,), disc_num=8, device="cpu",
                diff_fn=_softplus_kappa, diff_init=np.array([np.log(np.expm1(0.05))]),
                vel_fn=_vel_scalar, vel_init=np.array([0.7]))
    x = np.linspace(0, 1, 7)[:, None]
    np.testing.assert_allclose(kv.evaluate_field("kappa", x), 0.05, rtol=1e-6)
    assert kv.evaluate_field("vel", x).shape == (7, 1)
    np.testing.assert_allclose(kv.evaluate_field("vel", x), 0.7, rtol=1e-6)


def test_test_residuals_with_source_match_jax():
    """test_residuals evaluates the trainable source, as JAX's does."""
    vn, jv = _source_pair(False, layer_width=(8, 8), disc_num=6, b_disc_num=4)
    np.testing.assert_allclose(vn.test_residuals(), np.asarray(jv.test_residuals()),
                               rtol=1e-4, atol=1e-5 * np.abs(jv.test_residuals()).max())


def test_inverse_source_pin():
    """The pinned joint {net, src} theta re-scores under the bounds of
    tests/test_accuracy_pin.py: solution < 1e-3, recovered source < 1.2e-2."""
    theta = load_theta_npz(os.path.join(RESULTS, "theta_inverse_source_wobs100.npz"))
    case = analytic.inverse_source_2d(kappa=0.1, n_obs=400)
    pde = case["pde"]
    lo, hi = pde.domain.bounds
    fn, _ = make_mlp_source(torch.Generator().manual_seed(1), pde.dim, hidden=(16, 16),
                            lo=lo, hi=hi)
    vn = VarNet(pde, layer_width=(32, 32), disc_num=8, device="cpu", source_fn=fn,
                source_init=theta["src"])
    vn.theta = params_from_jax(theta)
    pts, mask = pde.domain.grid_in_domain((97, 97))
    pts = pts[mask]
    u_err = rel_l2_error(vn.evaluate(pts), case["c_ex"](pts))
    s_err = rel_l2_error(vn.evaluate_field("source", pts), case["s_true"](pts))
    assert u_err < 1e-3, f"solution {u_err:.3e}"
    assert s_err < 1.2e-2, f"source {s_err:.3e}"
