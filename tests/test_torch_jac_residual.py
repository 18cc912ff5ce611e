"""K3, the port's jacobian-panel residual (``jac_residual_*_plain`` on the
``prepare_residual_data(nl_vec=..., jacobian=True)`` layout, in
varnet_tpu_torch.ops.fused_residual), on the CPU against the JAX package's
``pallas_fused_residual(..., directional=False, nl_vec=...)`` in interpret mode:
the viscous-Burgers term u (b . grad u) in 1-D steady (n_in 1), 1-D transient and
2-D (a vector b), reaction with and without it, a linear problem (nl off), a MOR
input, raw coordinates (``input_scaling=False``), the sigmoid and sin.

Tolerances: r at rtol 1e-5 relative to max |r| and the gradients of a seeded
cotangent . r at rtol 1e-4 of each leaf's max (those of the other residual
tests), because the f32 sums over points and panels run in another order.
Meshes are tiny (interpret mode runs the Pallas grid in Python).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from varnet_tpu.fem.assembly import build_fixed_data
from varnet_tpu.models.mlp import make_input_scaling
from varnet_tpu.ops.pallas_residual import pallas_fused_residual
from varnet_tpu.problems import analytic
from varnet_tpu_torch.models.mlp import params_from_jax
from varnet_tpu_torch.ops import fused_residual as fr
from _torch_threads import _one_intra_op_thread  # noqa: F401


def _burgers_react():
    pde = analytic.burgers_1d_steady()["pde"]
    return {"pde": dataclasses.replace(pde, react=1.5)}


# name, factory, assembly kwargs, time-dependent, reaction, input scaling, activation
CASES = [
    ("steady1d", analytic.burgers_1d_steady, dict(disc_num=8), False, False, True, "tanh"),
    ("transient1d", analytic.burgers_1d_transient, dict(disc_num=6, t_disc_num=4), True, False,
     True, "tanh"),
    ("front2d", analytic.burgers_2d_front, dict(disc_num=4, b_disc_num=4, t_disc_num=3), True,
     False, True, "tanh"),
    ("react-nl", _burgers_react, dict(disc_num=8), False, True, True, "sigmoid"),
    ("react-linear", analytic.steady_adr_1d, dict(disc_num=8), False, True, True, "tanh"),
    ("linear2dt", analytic.transient_ad_2d, dict(disc_num=4, b_disc_num=4, t_disc_num=3), True,
     False, True, "sigmoid"),
    ("mor2d", analytic.mor_steady_ad_2d, dict(disc_num=4, b_disc_num=4), False, False, True,
     "tanh"),
    ("raw-inputs", analytic.burgers_1d_transient, dict(disc_num=6, t_disc_num=4), True, False,
     False, "tanh"),
    # sin (SIREN nets' activation; the seeded nets are the others')
    ("front2d-sin", analytic.burgers_2d_front, dict(disc_num=4, b_disc_num=4, t_disc_num=3),
     True, False, True, "sin"),
    ("react-nl-sin", _burgers_react, dict(disc_num=8), False, True, True, "sin"),
    ("transient1d-sin", analytic.burgers_1d_transient, dict(disc_num=6, t_disc_num=4), True,
     False, True, "sin"),
]
IDS = [c[0] for c in CASES]


def _setup(factory, kw, scaled, widths=(16, 16), seed=0):
    pde = factory()["pde"]
    fd = build_fixed_data(pde, **kw)
    st = fd.static
    rng = np.random.default_rng(seed)
    sizes = (st.n_inputs,) + widths + (1,)
    raw = [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
            "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
           for a, b in zip(sizes[:-1], sizes[1:])]
    cw = rng.standard_normal(fd.quad.coords.shape[0]).astype(np.float32)
    scale = shift = None
    if scaled:
        scale, shift = (np.asarray(a) for a in make_input_scaling(st.input_lo, st.input_hi))
    return pde, fd, raw, cw, scale, shift


def _port_data(pde, fd, td, react, scale, shift):
    return fr.prepare_residual_data(fd.quad, scale, shift, time_dependent=td, has_react=react,
                                    nl_vec=pde.nl_adv, jacobian=True)


def _port(pde, fd, raw, cw, td, react, scale, shift, activation):
    """r and the gradients of sum(r * cw) through DirResidualFn (K3's plain
    version on the CPU)."""
    data = _port_data(pde, fd, td, react, scale, shift)
    assert data.jac and (data.nl is None) == (pde.nl_adv is None)
    params = params_from_jax(raw)
    leaves = [layer[k] for layer in params for k in ("w", "b")]
    for v in leaves:
        v.requires_grad_(True)
    r = fr.fused_residual(params, data, activation)
    grads = torch.autograd.grad((r * torch.from_numpy(cw)).sum(), leaves)
    return r.detach().numpy(), [g.numpy() for g in grads]


def _jax(pde, fd, raw, cw, td, react, scale, shift, activation):
    quad = jax.tree_util.tree_map(jnp.asarray, fd.quad)
    k = quad.coords.shape[0]
    nl = None if pde.nl_adv is None else tuple(float(v) for v in np.atleast_1d(pde.nl_adv))
    sc = None if scale is None else jnp.asarray(scale)
    sh = None if shift is None else jnp.asarray(shift)

    def loss(p):
        r = pallas_fused_residual(p, quad, activation, sc, sh, time_dependent=td,
                                  has_react=react, tile=k, interpret=True, directional=False,
                                  nl_vec=nl)
        return jnp.sum(r * cw), r

    (_, r), g = jax.value_and_grad(loss, has_aux=True)(
        [{k2: jnp.asarray(v) for k2, v in layer.items()} for layer in raw])
    return np.asarray(r), [np.asarray(layer[k2]) for layer in g for k2 in ("w", "b")]


@pytest.mark.parametrize("name,factory,kw,td,react,scaled,activation", CASES, ids=IDS)
def test_plain_version_matches_jax_kernel(name, factory, kw, td, react, scaled, activation):
    pde, fd, raw, cw, scale, shift = _setup(factory, kw, scaled)
    r, grads = _port(pde, fd, raw, cw, td, react, scale, shift, activation)
    r_ref, g_ref = _jax(pde, fd, raw, cw, td, react, scale, shift, activation)
    np.testing.assert_allclose(r, r_ref, rtol=1e-5, atol=1e-5 * np.abs(r_ref).max())
    for g, gr in zip(grads, g_ref):
        np.testing.assert_allclose(g, gr, rtol=1e-4, atol=1e-4 * np.abs(gr).max())


def test_width_256_matches_jax_kernel():
    """At the widest hidden width csrc/ff_mlp.cu takes (HP 256, warp groups of four on
    the card): the 2-D Burgers front, tolerances as above."""
    _, factory, kw, td, react, scaled, activation = CASES[IDS.index("front2d")]
    pde, fd, raw, cw, scale, shift = _setup(factory, kw, scaled, widths=(256,), seed=2)
    r, grads = _port(pde, fd, raw, cw, td, react, scale, shift, activation)
    r_ref, g_ref = _jax(pde, fd, raw, cw, td, react, scale, shift, activation)
    np.testing.assert_allclose(r, r_ref, rtol=1e-5, atol=1e-5 * np.abs(r_ref).max())
    for g, gr in zip(grads, g_ref):
        np.testing.assert_allclose(g, gr, rtol=1e-4, atol=1e-4 * np.abs(gr).max())


@pytest.mark.parametrize("activation", ["tanh", "sigmoid", "sin"])
@pytest.mark.parametrize("case", [c for c in CASES if c[0] in ("front2d", "react-nl", "mor2d")],
                         ids=["front2d", "react-nl", "mor2d"])
def test_closed_form_backward_matches_autograd(case, activation):
    """K3's plain closed-form backward (the kernel's point cotangents handed to
    the plain K5 backward) against torch.autograd through its plain forward."""
    _, factory, kw, td, react, scaled, _ = case
    pde, fd, raw, cw, scale, shift = _setup(factory, kw, scaled, widths=(12, 9, 12), seed=1)
    data = _port_data(pde, fd, td, react, scale, shift)
    params = params_from_jax(raw)
    leaves = [layer[k] for layer in params for k in ("w", "b")]
    for v in leaves:
        v.requires_grad_(True)
    gr = torch.from_numpy(cw)
    r = fr.jac_residual_fwd_plain(params, data, activation)
    auto = torch.autograd.grad((r * gr).sum(), leaves)
    closed = fr.jac_residual_bwd_plain(params, data, activation, gr)
    for a, c in zip(auto, [g[k] for g in closed for k in ("w", "b")]):
        np.testing.assert_allclose(c.detach().numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(a.abs().max()))


def test_linear_jacobian_layout_equals_the_directional_residual():
    """Without the nonlinear term the jacobian-panel residual is the
    directional one, computed through all n_in panels."""
    pde, fd, raw, _, scale, shift = _setup(analytic.transient_ad_2d,
                                           dict(disc_num=4, b_disc_num=4, t_disc_num=3), True)
    params = params_from_jax(raw)
    jac = fr.prepare_residual_data(fd.quad, scale, shift, time_dependent=True,
                                   has_react=False, jacobian=True)
    dirn = fr.prepare_residual_data(fd.quad, scale, shift, time_dependent=True,
                                    has_react=False)
    assert fr._residual_fns(params, jac)[0] is fr.jac_residual_fwd
    assert fr._residual_fns(params, dirn)[0] is fr.dir_residual_fwd
    a, b = fr.fused_residual(params, jac), fr.fused_residual(params, dirn)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                               atol=1e-5 * float(b.abs().max()))


def test_cpu_dispatch_takes_plain_version_and_counts_nothing():
    pde, fd, raw, cw, scale, shift = _setup(*CASES[2][1:3], True)
    data = _port_data(pde, fd, True, False, scale, shift)
    params = params_from_jax(raw)
    before = (fr.jac_residual_fwd.launches, fr.jac_residual_bwd.launches)
    r = fr.jac_residual_fwd(params, data)
    np.testing.assert_array_equal(r.numpy(), fr.jac_residual_fwd_plain(params, data).numpy())
    fr.jac_residual_bwd(params, data, "tanh", torch.from_numpy(cw))
    assert (fr.jac_residual_fwd.launches, fr.jac_residual_bwd.launches) == before


def test_kernel_refuses_what_it_does_not_take():
    """The argument checks of K3's wrappers (run before any launch on CUDA) and
    of the layout: no embedding, a [d] Burgers direction, widths up to 256."""
    pde, fd, raw, _, scale, shift = _setup(*CASES[2][1:3], True)
    data = _port_data(pde, fd, True, False, scale, shift)
    fr._check_jac_data(params_from_jax(raw), data, "tanh")
    for widths in ((128, 128), (256,)):
        wide = params_from_jax(_setup(*CASES[2][1:3], True, widths=widths)[2])
        fr._check_jac_data(wide, data, "tanh")
    with pytest.raises(ValueError, match="hidden width 264"):
        fr._check_jac_data(params_from_jax(_setup(*CASES[2][1:3], True, widths=(264,))[2]),
                           data, "tanh")
    fr._check_jac_data(params_from_jax(raw), data, "sin")
    with pytest.raises(ValueError, match="unknown activation"):
        fr._check_jac_data(params_from_jax(raw), data, "relu")
    with pytest.raises(ValueError, match="nl vector"):
        fr._check_jac_data(params_from_jax(raw), data._replace(nl=data.nl[:1]), "tanh")
    with pytest.raises(ValueError, match="entries"):
        fr.prepare_residual_data(fd.quad, scale, shift, time_dependent=True, has_react=False,
                                 nl_vec=(1.0, 1.0, 1.0), jacobian=True)
    with pytest.raises(ValueError, match="Fourier"):
        fr.prepare_residual_data(fd.quad, scale, shift, time_dependent=True, has_react=False,
                                 nl_vec=pde.nl_adv, jacobian=True,
                                 fourier_bt=np.ones((4, 3), np.float32))
    with pytest.raises(ValueError, match="jacobian=True"):
        fr.prepare_residual_data(fd.quad, scale, shift, time_dependent=True, has_react=False,
                                 nl_vec=pde.nl_adv)
