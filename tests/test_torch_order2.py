"""The order-2 (quadratic Lagrange) test space in the port against the JAX
package on the CPU: ``build_fixed_data(test_order=2)`` bit-equal, the per-node
[K, nQ] ``weak_residual``, the loss and its gradients at a fixed theta (fused:
K4's plain version; general path), and 20 Adam epochs of ``VarNet(test_order=2)``
(rtol 2e-4, the Adam band of ``__graft_entry__.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.fem.assembly import build_fixed_data as jax_build_fixed_data
from varnet_tpu.ops.residual import weak_residual as jax_weak_residual
from varnet_tpu.problems import analytic as jax_analytic
from varnet_tpu.train.loss import make_loss_fn as jax_make_loss_fn
from varnet_tpu_torch import VarNet, params_from_jax
from varnet_tpu_torch.fem.assembly import build_fixed_data
from varnet_tpu_torch.models.mlp import make_input_scaling
from varnet_tpu_torch.ops.fused_residual import prepare_residual_coeffs
from varnet_tpu_torch.ops.residual import weak_residual
from varnet_tpu_torch.problems import analytic
from varnet_tpu_torch.train.loss import make_loss_fn
from _torch_threads import _one_intra_op_thread  # noqa: F401


MESHES = [
    ("transient_ad_2d", dict(disc_num=6, b_disc_num=4, t_disc_num=4)),
    ("steady_ad_2d", dict(disc_num=48, b_disc_num=48, integ_p_num=3)),  # hardbc_2d_o2's mesh
    ("steady_adr_1d", dict(disc_num=10)),
]


@pytest.mark.parametrize("name,kw", MESHES, ids=[m[0] for m in MESHES])
def test_order2_fixed_data_bit_equal(name, kw):
    ref = jax_build_fixed_data(getattr(jax_analytic, name)()["pde"], test_order=2, **kw)
    ours = build_fixed_data(getattr(analytic, name)()["pde"], test_order=2, **kw)
    assert ours.quad.tables_per_node
    for a, b in zip(vars(ours.static).values(), vars(ref.static).values()):
        np.testing.assert_array_equal(a, b)
    for part in ("quad", "bc"):
        for a, b in zip(getattr(ours, part), getattr(ref, part)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_per_node_weak_residual_matches_jax():
    rng = np.random.default_rng(0)
    k, nq, d = 7, 9, 2
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((k, nq, d), (k, nq), (k, nq, d), (k, nq), (k, nq), (k, nq, d), (k, nq),
             (k, nq), (k, nq), (k, nq))]
    ref = jax_weak_residual(*map(jnp.asarray, arrs[:8]), u=jnp.asarray(arrs[8]),
                            react=jnp.asarray(arrs[9]))
    ours = weak_residual(*map(torch.from_numpy, arrs[:8]), u=torch.from_numpy(arrs[8]),
                         react=torch.from_numpy(arrs[9]))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "general"])
@pytest.mark.parametrize("name,kw,td,react", [
    ("transient_ad_2d", dict(disc_num=6, b_disc_num=4, t_disc_num=4), True, False),
    ("steady_adr_1d", dict(disc_num=10), False, True)], ids=["2dt", "adr1d"])
def test_order2_loss_and_grads_match_jax(name, kw, td, react, fused):
    fd = jax_build_fixed_data(getattr(jax_analytic, name)()["pde"], test_order=2, **kw)
    st = fd.static
    rng = np.random.default_rng(5)
    sizes = (st.n_inputs, 10, 10, 1)
    raw = [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
            "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
           for a, b in zip(sizes[:-1], sizes[1:])]
    weights = (1.0, 10.0, 10.0) if td else (1.0, 10.0, 0.0, 0.0)
    as_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    (j_total, _), j_grads = jax.value_and_grad(
        jax_make_loss_fn(st, has_react=react), has_aux=True)(
        as_j(raw), as_j(fd.quad), as_j(fd.bc), None if fd.ic is None else as_j(fd.ic), None,
        jnp.asarray(weights))

    tens = lambda p: type(p)(*(torch.from_numpy(np.array(a, np.float32)) for a in p))  # noqa: E731
    scale, shift = make_input_scaling(st.input_lo, st.input_hi)
    prepared = (prepare_residual_coeffs(fd.quad, scale, shift, time_dependent=td,
                                        has_react=react) if fused else None)
    params = params_from_jax(raw)
    leaves = [layer[k] for layer in params for k in ("w", "b")]
    for v in leaves:
        v.requires_grad_(True)
    total, _ = make_loss_fn(st, has_react=react, fused=fused)(
        params, tens(fd.quad), tens(fd.bc), None if fd.ic is None else tens(fd.ic), weights,
        prepared)
    grads = torch.autograd.grad(total, leaves)
    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=2e-5)
    for g, gj in zip(grads, [np.asarray(lay[k]) for lay in j_grads for k in ("w", "b")]):
        np.testing.assert_allclose(g.numpy(), gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())


MESH = dict(layer_width=(10, 10), disc_num=6, b_disc_num=4, t_disc_num=4, test_order=2)
TRAIN = dict(epoch_num=20, weight=(1.0, 10.0, 10.0), save_freq=1, verbose=False,
             error_disc=8, error_times=2)


@pytest.fixture(scope="module")
def jax_adam():
    jvn = JaxVarNet(jax_analytic.transient_ad_2d()["pde"], n_devices=1, **MESH)
    theta0 = jax.tree_util.tree_map(np.asarray, jvn.theta)
    return theta0, jvn.train(**TRAIN)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "general"])
def test_order2_adam_trajectory_matches_jax(jax_adam, fused):
    theta0, jres = jax_adam
    vn = VarNet(analytic.transient_ad_2d()["pde"], device="cpu", use_fused_residual=fused,
                **MESH)
    assert vn._fused_kind == ("precoeff" if fused else None)
    vn.theta = params_from_jax(theta0)
    res = vn.train(**TRAIN)
    for key in ("loss", "loss_int", "loss_bc", "loss_ic"):
        np.testing.assert_allclose([r[key] for r in res.losses],
                                   [r[key] for r in jres.losses], rtol=2e-4, err_msg=key)
    np.testing.assert_allclose(res.errors, jres.errors, rtol=2e-4)


def test_order2_minibatches_split_the_per_node_tables():
    vn = VarNet(analytic.transient_ad_2d()["pde"], device="cpu", **MESH)
    res = vn.train(epoch_num=2, weight=(1.0, 10.0, 10.0), batch_num=3, save_freq=1,
                   verbose=False, error_disc=8, error_times=2)
    assert res.total_steps == 3 and all(np.isfinite(r["loss"]) for r in res.losses)
