"""Exact BC/IC imposition in the port (``varnet_tpu_torch/fem/hardbc.py``, the
loss's ``hard_mode``, ``VarNet(hard_bc=True)``) against the JAX package on the
CPU: the transform tables bit-equal on interval, box (2-D, 3-D x time) and
polygon-with-holes domains; ``hard_transform``; the hard-mode loss and its
gradients at a fixed theta; 20 Adam epochs (rtol 2e-4, the Adam band of
``__graft_entry__.py``) and 2 LM iterations (rtol 2e-2, its LM band) against
``VarNet(hard_bc=True)``.

The JAX package trains hard BC on the CPU through its general path; the port
runs both its fused path (K4's plain version, the ansatz folded into the
coefficients) and its general path (``hard_transform`` before the weak form).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.fem.assembly import build_fixed_data as jax_build_fixed_data
from varnet_tpu.fem.hardbc import HardBC as JaxHardBC
from varnet_tpu.fem.hardbc import hard_transform as jax_hard_transform
from varnet_tpu.problems import analytic as jax_analytic
from varnet_tpu.train.loss import make_loss_fn as jax_make_loss_fn
from varnet_tpu_torch import VarNet, api, params_from_jax
from varnet_tpu_torch.fem.assembly import build_fixed_data
from varnet_tpu_torch.fem.hardbc import HardBC, hard_transform, tables_to
from varnet_tpu_torch.models.mlp import make_input_scaling
from varnet_tpu_torch.ops.fused_residual import prepare_residual_coeffs
from varnet_tpu_torch.problems import analytic
from varnet_tpu_torch.train.loss import make_loss_fn

DOMAINS = [  # factory name, assembly kwargs: interval, box 2-D / 3-D x time, polygon + holes
    ("steady_ad_2d", dict(disc_num=6, b_disc_num=4)),
    ("transient_ad_3d", dict(disc_num=3, b_disc_num=3, t_disc_num=2)),
    ("transient_ad_1d", dict(disc_num=12, t_disc_num=4)),
    ("obstacle_manufactured_2d", dict(disc_num=8, b_disc_num=4)),
]


@pytest.mark.parametrize("name,kw", DOMAINS, ids=[d[0] for d in DOMAINS])
def test_tables_bit_equal_to_jax(name, kw):
    pde_j = getattr(jax_analytic, name)()["pde"]
    pde_t = getattr(analytic, name)()["pde"]
    coords = np.asarray(jax_build_fixed_data(pde_j, **kw).quad.coords)
    ref, ours = JaxHardBC(pde_j).tables(coords), HardBC(pde_t).tables(coords)
    for a, b in zip(ours, ref):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    pts = coords.reshape(-1, coords.shape[-1])[::7]
    for a, b in zip(HardBC(pde_t).value_AB(pts), JaxHardBC(pde_j).value_AB(pts)):
        np.testing.assert_array_equal(a, b)


def test_chunked_cached_tables_equal_one_build(monkeypatch):
    """``VarNet._hard_tables`` builds the real rows in chunks, once, and pads
    them as pad_quad pads: bit-equal to one build at the padded coords."""
    from varnet_tpu_torch.fem.assembly import pad_quad

    monkeypatch.setattr(api, "HARD_TABLE_CHUNK", 100)
    vn = VarNet(analytic.transient_ad_2d()["pde"], layer_width=(8,), disc_num=6,
                b_disc_num=4, t_disc_num=3, device="cpu", hard_bc=True)
    quad_h = pad_quad(vn.fixed.quad, 7)
    for a, b in zip(vn._hard_tables(quad_h), vn.hard.tables(quad_h.coords)):
        np.testing.assert_array_equal(a, b)
    cached = vn._hard_cache[1]
    vn._hard_tables(pad_quad(vn.fixed.quad, 3))
    assert vn._hard_cache[1] is cached and vn.hard_table_seconds > 0


def test_hard_transform_matches_jax():
    rng = np.random.default_rng(0)
    k, nq, d = 5, 4, 2
    hq = JaxHardBC(jax_analytic.transient_ad_2d()["pde"]).tables(
        rng.uniform(0.1, 0.4, (k, nq, 3)))
    u, g, ut = (rng.standard_normal(s).astype(np.float32) for s in ((k, nq), (k, nq, d),
                                                                    (k, nq)))
    ref = jax_hard_transform(jnp.asarray(u), jnp.asarray(g), jnp.asarray(ut),
                             jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float32), hq))
    ours = hard_transform(torch.from_numpy(u), torch.from_numpy(g), torch.from_numpy(ut),
                          tables_to(hq))
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


LOSS_CASES = [("steady_ad_2d", dict(disc_num=6, b_disc_num=4), False, False),
              ("transient_ad_1d", dict(disc_num=12, t_disc_num=4), True, False),
              ("steady_adr_1d", dict(disc_num=12), False, True)]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "general"])
@pytest.mark.parametrize("name,kw,td,react", LOSS_CASES, ids=[c[0] for c in LOSS_CASES])
def test_hard_loss_and_grads_match_jax(name, kw, td, react, fused):
    pde_j = getattr(jax_analytic, name)()["pde"]
    fd = jax_build_fixed_data(pde_j, **kw)
    st = fd.static
    hq = JaxHardBC(pde_j).tables(np.asarray(fd.quad.coords))
    rng = np.random.default_rng(3)
    sizes = (st.n_inputs, 10, 10, 1)
    raw = [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
            "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
           for a, b in zip(sizes[:-1], sizes[1:])]
    weights = (1.0, 10.0, 10.0) if td else (1.0, 10.0, 0.0, 0.0)

    jloss = jax_make_loss_fn(st, has_react=react, hard_mode=True)
    as_j = lambda t: jax.tree_util.tree_map(jnp.asarray, t)  # noqa: E731
    (j_total, j_aux), j_grads = jax.value_and_grad(jloss, has_aux=True)(
        as_j(raw), as_j(fd.quad), as_j(fd.bc), None if fd.ic is None else as_j(fd.ic),
        None, jnp.asarray(weights), hard=(jax.tree_util.tree_map(
            lambda a: jnp.asarray(a, jnp.float32), hq), None, None))

    quad = type(fd.quad)(*(torch.from_numpy(np.array(a, np.float32)) for a in fd.quad))
    pts = lambda p: type(p)(*(torch.from_numpy(np.array(a, np.float32)) for a in p))  # noqa: E731
    scale, shift = make_input_scaling(st.input_lo, st.input_hi)
    prepared = (prepare_residual_coeffs(fd.quad, scale, shift, time_dependent=td,
                                        has_react=react, hard=hq) if fused else None)
    loss = make_loss_fn(st, has_react=react, fused=fused, hard_mode=True)
    params = params_from_jax(raw)
    leaves = [layer[k] for layer in params for k in ("w", "b")]
    for v in leaves:
        v.requires_grad_(True)
    total, aux = loss(params, quad, pts(fd.bc), None if fd.ic is None else pts(fd.ic),
                      weights, prepared, None if fused else tables_to(hq))
    grads = torch.autograd.grad(total, leaves)

    np.testing.assert_allclose(float(total.detach()), float(j_total), rtol=2e-5)
    for key in j_aux:
        if key != "loss_obs":
            np.testing.assert_allclose(float(aux[key].detach()), float(j_aux[key]), rtol=2e-5,
                                       atol=0)
    assert float(aux["loss_bc"]) == 0.0
    for g, gj in zip(grads, [np.asarray(lay[k]) for lay in j_grads for k in ("w", "b")]):
        np.testing.assert_allclose(g.numpy(), gj, rtol=1e-4, atol=1e-4 * np.abs(gj).max())


def test_hard_loss_refuses_unfolded_fused_data():
    fd = build_fixed_data(analytic.steady_ad_2d()["pde"], 4, b_disc_num=4)
    loss = make_loss_fn(fd.static, fused=True, hard_mode=True)
    with pytest.raises(ValueError, match="prepare_residual_coeffs"):
        loss(None, fd.quad, fd.bc, None, (1.0, 1.0), None)


MESH = dict(layer_width=(12, 12), disc_num=8, b_disc_num=6)
TRAIN = dict(epoch_num=20, save_freq=1, verbose=False, error_disc=16)


@pytest.fixture(scope="module")
def jax_adam():
    vn = JaxVarNet(jax_analytic.steady_ad_2d()["pde"], n_devices=1, hard_bc=True, **MESH)
    theta0 = jax.tree_util.tree_map(np.asarray, vn.theta)
    res = vn.train(**TRAIN)
    return theta0, res, jax.tree_util.tree_map(np.asarray, vn.theta)


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "general"])
def test_hard_adam_trajectory_matches_jax(jax_adam, fused):
    theta0, jres, jtheta = jax_adam
    vn = VarNet(analytic.steady_ad_2d()["pde"], device="cpu", hard_bc=True,
                use_fused_residual=fused, **MESH)
    assert vn._fused_kind == ("precoeff" if fused else None)
    vn.theta = params_from_jax(theta0)
    res = vn.train(**TRAIN)
    assert res.epochs == jres.epochs == list(range(1, 21))
    for key in ("loss", "loss_int"):
        np.testing.assert_allclose([r[key] for r in res.losses],
                                   [r[key] for r in jres.losses], rtol=2e-4, err_msg=key)
    assert all(r["loss_bc"] == 0.0 for r in res.losses)
    np.testing.assert_allclose(res.errors, jres.errors, rtol=2e-4)
    for a, b in zip(vn.theta, jtheta):
        for k in ("w", "b"):
            np.testing.assert_allclose(a[k].numpy(), b[k], rtol=2e-4,
                                       atol=2e-4 * np.abs(b[k]).max())


LM = dict(steps=2, cg_iters=5, save_freq=1, verbose=False, error_disc=16, k_chunks=2)


@pytest.fixture(scope="module")
def jax_lm(jax_adam):
    vn = JaxVarNet(jax_analytic.steady_ad_2d()["pde"], n_devices=1, hard_bc=True, **MESH)
    vn.theta = jax_adam[2]
    return vn.refine_lm(**LM)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel_fn", "general"])
def test_hard_refine_lm_matches_jax(jax_adam, jax_lm, use_pallas):
    vn = VarNet(analytic.steady_ad_2d()["pde"], device="cpu", hard_bc=True,
                use_pallas=use_pallas, **MESH)
    vn.theta = params_from_jax(jax_adam[2])
    res = vn.refine_lm(**LM)
    assert res.epochs == jax_lm.epochs == [1, 2]
    for key in ("loss", "lam"):
        np.testing.assert_allclose([r[key] for r in res.losses],
                                   [r[key] for r in jax_lm.losses], rtol=2e-2, err_msg=key)
    np.testing.assert_allclose(res.errors, jax_lm.errors, rtol=2e-2)
