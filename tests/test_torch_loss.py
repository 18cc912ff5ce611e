"""The port's weak-form loss (varnet_tpu_torch.train.loss.make_loss_fn) against
the JAX package's at a fixed theta: total, aux terms and parameter gradients,
through the fused-residual branch and through the general branch.
Tolerances: rtol 1e-5 on the loss terms, 1e-4 on the gradients (f32 sums in
another order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from varnet_tpu.fem.assembly import PointData as JPoints
from varnet_tpu.fem.assembly import QuadData as JQuad
from varnet_tpu.fem.assembly import build_fixed_data
from varnet_tpu.ops.pallas_residual import pallas_fused_residual
from varnet_tpu.problems.analytic import steady_adr_1d, transient_ad_2d
from varnet_tpu.train.loss import make_loss_fn as jax_make_loss_fn
from varnet_tpu_torch.fem.assembly import PointData, QuadData
from varnet_tpu_torch.models.mlp import make_input_scaling, params_from_jax
from varnet_tpu_torch.ops.fused_residual import prepare_residual_data
from varnet_tpu_torch.train.loss import make_loss_fn

CASES = [  # name, factory, assembly kwargs, weights, widths
    ("2dt", transient_ad_2d, dict(disc_num=8, b_disc_num=6, t_disc_num=4), (1.0, 10.0, 10.0),
     (20, 20)),
    ("adr1d", steady_adr_1d, dict(disc_num=16), (1.0, 10.0), (8, 8, 8)),
]


def _theta(n_in, widths, seed=0):
    rng = np.random.default_rng(seed)
    sizes = (n_in,) + widths + (1,)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b))).astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _f32(t):
    return type(t)(*(np.asarray(a, np.float32) for a in t))


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "general"])
@pytest.mark.parametrize("name,factory,kw,weights,widths", CASES, ids=[c[0] for c in CASES])
def test_loss_and_grads_match_jax(name, factory, kw, weights, widths, fused):
    fd = build_fixed_data(factory()["pde"], **kw)
    st = fd.static
    td, react = st.time_dependent, name == "adr1d"
    raw = _theta(st.n_inputs, widths)
    k = fd.quad.coords.shape[0]

    # JAX reference (fused branch: the G=1 Pallas kernel in interpret mode)
    hook = (functools.partial(pallas_fused_residual, time_dependent=td, has_react=react,
                              interpret=True, tile=k) if fused else None)
    jloss = jax_make_loss_fn(st, has_react=react, fused_residual=hook)
    jquad = JQuad(*(jnp.asarray(a, jnp.float32) for a in fd.quad))
    jbc = JPoints(*(jnp.asarray(a, jnp.float32) for a in fd.bc))
    jic = None if fd.ic is None else JPoints(*(jnp.asarray(a, jnp.float32) for a in fd.ic))
    w4 = list(weights) + [0.0] * (3 - len(weights)) + [0.0]
    (jtot, jaux), jgrad = jax.value_and_grad(
        lambda th: jloss(th, jquad, jbc, jic, None, jnp.asarray(w4, jnp.float32)),
        has_aux=True)([{k2: jnp.asarray(v) for k2, v in layer.items()} for layer in raw])

    # port
    prepared = None
    if fused:
        scale, shift = make_input_scaling(st.input_lo, st.input_hi)
        prepared = prepare_residual_data(fd.quad, scale, shift, time_dependent=td,
                                         has_react=react)
    tloss = make_loss_fn(st, has_react=react, fused=fused)
    quad = QuadData(*(torch.from_numpy(a) for a in _f32(fd.quad)))
    bc = PointData(*(torch.from_numpy(a) for a in _f32(fd.bc)))
    ic = None if fd.ic is None else PointData(*(torch.from_numpy(a) for a in _f32(fd.ic)))
    theta = params_from_jax(raw)
    leaves = [layer[k2] for layer in theta for k2 in ("w", "b")]
    for v in leaves:
        v.requires_grad_(True)
    tot, aux = tloss(theta, quad, bc, ic, tuple(weights) + (0.0,) * (3 - len(weights)),
                     prepared)
    grads = torch.autograd.grad(tot, leaves)

    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-5)
    assert set(aux) == set(jaux)
    for key in aux:
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]), rtol=1e-5, err_msg=key)
    jleaves = [np.asarray(layer[k2]) for layer in jgrad for k2 in ("w", "b")]
    for g, jg in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max())


def test_unported_options_raise():
    st = build_fixed_data(steady_adr_1d()["pde"], 8).static
    with pytest.raises(TypeError, match="bogus"):
        make_loss_fn(st, bogus=1)
