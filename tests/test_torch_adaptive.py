"""Adaptive refinement of the hat test space in the port (``fem/adaptive.py``,
``VarNet.test_residuals`` / ``refine_tests`` / ``train_adaptive`` /
``residual_adequacy``) against the JAX package on the CPU: ``refine_fixed`` and
``refine_tests`` give bit-equal fixed data, the residual densities agree to f32
accuracy (rtol 1e-4 of their max), and training after a refinement (the
per-node tables through K4's plain version) follows JAX's within rtol 2e-4."""

import jax
import numpy as np
import pytest

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.fem.adaptive import hat_geometry as jax_hat_geometry
from varnet_tpu.fem.adaptive import refine_fixed as jax_refine_fixed
from varnet_tpu.fem.assembly import build_fixed_data as jax_build_fixed_data
from varnet_tpu.problems import analytic as jax_analytic
from varnet_tpu_torch import VarNet, params_from_jax
from varnet_tpu_torch.fem.adaptive import hat_geometry, refine_fixed
from varnet_tpu_torch.fem.assembly import build_fixed_data
from varnet_tpu_torch.problems import analytic


def _assert_fixed_equal(ours, ref):
    for a, b in zip(vars(ours.static).values(), vars(ref.static).values()):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ours.quad, ref.quad):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name,kw,factor", [
    ("steady_ad_2d", dict(disc_num=6, b_disc_num=4), 2),
    ("transient_ad_2d", dict(disc_num=5, b_disc_num=4, t_disc_num=3), 2),
    ("steady_ad_1d", dict(disc_num=8), 3)], ids=["2d", "2dt", "1d-f3"])
def test_refine_fixed_bit_equal_to_jax(name, kw, factor):
    ref = jax_build_fixed_data(getattr(jax_analytic, name)()["pde"], **kw)
    ours = build_fixed_data(getattr(analytic, name)()["pde"], **kw)
    flags = np.random.default_rng(1).uniform(size=ref.static.n_test) < 0.3
    for a, b in zip(hat_geometry(np.asarray(ours.quad.coords), 2),
                    jax_hat_geometry(np.asarray(ref.quad.coords), 2)):
        np.testing.assert_array_equal(a, b)
    fd1, info = refine_fixed(getattr(analytic, name)()["pde"], ours, flags, 2, factor=factor)
    fd1_ref, info_ref = jax_refine_fixed(getattr(jax_analytic, name)()["pde"], ref, flags, 2,
                                         factor=factor)
    assert info == info_ref and info["n_added"] > 0
    _assert_fixed_equal(fd1, fd1_ref)
    # a second round refines the refined rows, recovering their spacing from the coords
    flags2 = np.random.default_rng(2).uniform(size=fd1.static.n_test) < 0.2
    _assert_fixed_equal(
        refine_fixed(getattr(analytic, name)()["pde"], fd1, flags2, 2, factor=factor)[0],
        jax_refine_fixed(getattr(jax_analytic, name)()["pde"], fd1_ref, flags2, 2,
                         factor=factor)[0])


MESH = dict(layer_width=(10, 10), disc_num=6, b_disc_num=4)
TRAIN = dict(epoch_num=10, weight=(1.0, 10.0), save_freq=1, verbose=False, error_disc=8)


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port's VarNet from the same theta, 10 Adam epochs in."""
    jvn = JaxVarNet(jax_analytic.steady_ad_2d()["pde"], n_devices=1, **MESH)
    theta0 = jax.tree_util.tree_map(np.asarray, jvn.theta)
    jvn.train(**TRAIN)
    vn = VarNet(analytic.steady_ad_2d()["pde"], device="cpu", **MESH)
    vn.theta = params_from_jax(theta0)
    vn.train(**TRAIN)
    return jvn, vn


@pytest.mark.parametrize("hard", [False, True], ids=["penalty", "hard"])
def test_residual_densities_match_jax(pair, hard):
    jvn, _ = pair
    theta = jax.tree_util.tree_map(np.asarray, jvn.theta)
    kw = dict(MESH, hard_bc=hard)
    ref = JaxVarNet(jax_analytic.steady_ad_2d()["pde"], n_devices=1, **kw).test_residuals(
        theta, chunk=16)
    ours = VarNet(analytic.steady_ad_2d()["pde"], device="cpu", **kw).test_residuals(
        theta, chunk=16)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


def test_refine_tests_then_train_matches_jax(pair):
    jvn, vn = pair
    vn.theta = params_from_jax(jax.tree_util.tree_map(np.asarray, jvn.theta))
    jinfo = jvn.refine_tests(frac=0.2, verbose=False)
    info = vn.refine_tests(frac=0.2, verbose=False)
    assert info["n_added"] == jinfo["n_added"] > 0
    np.testing.assert_allclose(info["threshold"], jinfo["threshold"], rtol=1e-4)
    _assert_fixed_equal(vn.fixed, jvn.fixed)
    assert vn._fused_kind == "precoeff"   # per-node tables: K4 from here on
    jres, res = jvn.train(**TRAIN), vn.train(**TRAIN)
    np.testing.assert_allclose([r["loss"] for r in res.losses],
                               [r["loss"] for r in jres.losses], rtol=2e-4)


def test_train_adaptive_and_adequacy_match_jax():
    jvn = JaxVarNet(jax_analytic.steady_ad_2d()["pde"], n_devices=1, **MESH)
    theta0 = jax.tree_util.tree_map(np.asarray, jvn.theta)
    vn = VarNet(analytic.steady_ad_2d()["pde"], device="cpu", **MESH)
    vn.theta = params_from_jax(theta0)
    kw = dict(epoch_num=12, rounds=1, frac=0.25, weight=(1.0, 10.0), verbose=False,
              save_freq=6, error_disc=8)
    jres, res = jvn.train_adaptive(**kw), vn.train_adaptive(**kw)
    assert res.epochs == jres.epochs == [6, 12]
    assert res.losses[0]["n_test"] == jres.losses[0]["n_test"] == vn.static.n_test
    np.testing.assert_allclose([r["loss"] for r in res.losses],
                               [r["loss"] for r in jres.losses], rtol=2e-4)
    theta = jax.tree_util.tree_map(np.asarray, jvn.theta)  # the same theta for both
    ours = vn.residual_adequacy(theta, verbose=False, chunk=64)
    ref = jvn.residual_adequacy(theta, verbose=False, chunk=64)
    assert ours["probe_mesh"] == ref["probe_mesh"] and ours["flagged"] == ref["flagged"]
    for key in ("train_rms", "probe_rms", "ratio"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-4, err_msg=key)
