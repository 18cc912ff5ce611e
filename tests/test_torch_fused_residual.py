"""The port's fused weak residual (varnet_tpu_torch.ops.fused_residual) on the
CPU, where it runs its plain PyTorch version, against the JAX package:
``pallas_fused_residual`` in interpret mode at q_block=1 (the G=1 kernel
``_fused_residual_fn(directional=True)``) and q_block=2 (the q-blocked
``_dirq_residual_fn``), and the general path (value + jacobian, then the
weak-form contraction).  Residual and parameter gradients.

Tolerances: r at rtol 1e-5 relative to max|r|, gradients at rtol 1e-4 of each
leaf's max, because the f32 sums run in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from varnet_tpu.fem.assembly import build_fixed_data
from varnet_tpu.models.mlp import make_input_scaling, mlp_value_and_jac
from varnet_tpu.ops.pallas_residual import pallas_fused_residual
from varnet_tpu.ops.residual import weak_residual
from varnet_tpu.problems.analytic import steady_ad_1d, steady_adr_1d, transient_ad_2d
from varnet_tpu_torch.models.mlp import params_from_jax
from varnet_tpu_torch.ops import fused_residual as fr

CASES = [  # name, factory, assembly kwargs, time-dependent, reaction, widths
    ("2dt", transient_ad_2d, dict(disc_num=8, b_disc_num=6, t_disc_num=4), True, False,
     (20, 20)),
    ("1d", steady_ad_1d, dict(disc_num=16), False, False, (8, 8, 8)),
    ("adr1d", steady_adr_1d, dict(disc_num=16), False, True, (8, 8, 8)),
]
IDS = [c[0] for c in CASES]


def _setup(factory, kw, widths, seed=0):
    fd = build_fixed_data(factory()["pde"], **kw)
    st = fd.static
    rng = np.random.default_rng(seed)
    sizes = (st.n_inputs,) + widths + (1,)
    raw = [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b))).astype(np.float32),
            "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
           for a, b in zip(sizes[:-1], sizes[1:])]
    cw = rng.standard_normal(fd.quad.coords.shape[0]).astype(np.float32)
    return fd, st, raw, cw


def _data(fd, st, td=True, react=False):
    scale, shift = make_input_scaling(st.input_lo, st.input_hi)
    return fr.prepare_residual_data(fd.quad, np.asarray(scale), np.asarray(shift),
                                    time_dependent=td, has_react=react)


def _port(fd, st, raw, cw, td, react):
    """Port residual and gradients of sum(r * cw) through DirResidualFn."""
    data = _data(fd, st, td, react)
    params = params_from_jax(raw)
    for layer in params:
        for v in layer.values():
            v.requires_grad_(True)
    r = fr.fused_residual(params, data, "tanh")
    grads = torch.autograd.grad((r * torch.from_numpy(cw)).sum(),
                                [layer[k] for layer in params for k in ("w", "b")])
    return r.detach().numpy(), [g.numpy() for g in grads]


def _jax(fd, st, raw, cw, td, react, q_block):
    quad = jax.tree_util.tree_map(jnp.asarray, fd.quad)
    scale, shift = make_input_scaling(st.input_lo, st.input_hi)
    k = quad.coords.shape[0]

    def loss(p):
        if q_block is None:  # the general path
            nq = quad.coords.shape[1]
            u, du = mlp_value_and_jac(p, quad.coords.reshape(k * nq, -1), "tanh",
                                      scale, shift)
            d = st.n_space
            r = weak_residual(du[:, :d].reshape(k, nq, d), quad.N, quad.dN, quad.w,
                              quad.kappa, quad.vel, quad.src,
                              du[:, d].reshape(k, nq) if td else None,
                              u=u.reshape(k, nq) if react else None,
                              react=quad.react if react else None)
        else:
            r = pallas_fused_residual(p, quad, "tanh", scale, shift, time_dependent=td,
                                      has_react=react, tile=k, interpret=True,
                                      q_block=q_block)
        return jnp.sum(r * cw), r

    (_, r), g = jax.value_and_grad(loss, has_aux=True)(
        [{k2: jnp.asarray(v) for k2, v in layer.items()} for layer in raw])
    return np.asarray(r), [np.asarray(layer[k2]) for layer in g for k2 in ("w", "b")]


def _assert_match(r, grads, r_ref, g_ref):
    np.testing.assert_allclose(r, r_ref, rtol=1e-5, atol=1e-5 * np.abs(r_ref).max())
    for g, gr in zip(grads, g_ref):
        np.testing.assert_allclose(g, gr, rtol=1e-4, atol=1e-4 * np.abs(gr).max())


@pytest.mark.parametrize("q_block", [1, 2, None], ids=["K2_G1", "K1_G2", "general"])
@pytest.mark.parametrize("name,factory,kw,td,react,widths", CASES, ids=IDS)
def test_matches_jax(name, factory, kw, td, react, widths, q_block):
    fd, st, raw, cw = _setup(factory, kw, widths)
    r, grads = _port(fd, st, raw, cw, td, react)
    r_ref, g_ref = _jax(fd, st, raw, cw, td, react, q_block)
    _assert_match(r, grads, r_ref, g_ref)


@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
@pytest.mark.parametrize("name,factory,kw,td,react,widths", CASES, ids=IDS)
def test_closed_form_backward_matches_autograd(name, factory, kw, td, react, widths,
                                               activation):
    """The plain closed-form backward (the kernel's algorithm) against
    torch.autograd through the plain forward."""
    fd, st, raw, cw = _setup(factory, kw, widths, seed=1)
    data = _data(fd, st, td, react)
    params = params_from_jax(raw)
    leaves = [layer[k] for layer in params for k in ("w", "b")]
    for v in leaves:
        v.requires_grad_(True)
    gr = torch.from_numpy(cw)
    r = fr.dir_residual_fwd_plain(params, data, activation)
    auto = torch.autograd.grad((r * gr).sum(), leaves, allow_unused=True)
    closed = fr.dir_residual_bwd_plain(params, data, activation, gr)
    for leaf, a, c in zip(leaves, auto, [g[k] for g in closed for k in ("w", "b")]):
        a = torch.zeros_like(leaf) if a is None else a  # b_out without reaction
        assert a.shape == c.shape
        np.testing.assert_allclose(c.detach().numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(a.abs().max()))


def test_cpu_dispatch_takes_plain_version_and_counts_nothing():
    fd, st, raw, cw = _setup(*CASES[0][1:3], CASES[0][5])
    data = _data(fd, st)
    params = params_from_jax(raw)
    before = (fr.dir_residual_fwd.launches, fr.dir_residual_bwd.launches)
    r = fr.dir_residual_fwd(params, data)
    np.testing.assert_array_equal(r.numpy(), fr.dir_residual_fwd_plain(params, data).numpy())
    fr.dir_residual_bwd(params, data, "tanh", torch.from_numpy(cw))
    assert (fr.dir_residual_fwd.launches, fr.dir_residual_bwd.launches) == before


def test_unsupported_inputs_raise():
    fd, st, raw, cw = _setup(*CASES[0][1:3], CASES[0][5])
    data = _data(fd, st)
    params = params_from_jax(raw)
    with pytest.raises(ValueError, match="sin"):
        fr.dir_residual_fwd(params, data, "sin")
    with pytest.raises(ValueError, match="hidden width"):
        fr._check_kernel_args(params_from_jax(_setup(*CASES[0][1:3], (72, 8))[2]), data,
                              "tanh")
    wide = data._replace(xs=torch.zeros(4, data.xs.shape[1]))
    with pytest.raises(ValueError, match="n_in"):
        fr._check_kernel_args(params, wide, "tanh")


def test_pack_unpack_round_trip():
    """The kernel's packed, zero-padded parameter layout round-trips."""
    raw = _setup(*CASES[0][1:3], (13, 20, 7))[2]
    params = params_from_jax(raw)
    hp = fr.padded_width(params)
    assert hp == 24
    back = fr.unpack_grads(fr.pack_params(params, hp), params, hp)
    for a, b in zip(params, back):
        for k in ("w", "b"):
            assert torch.equal(a[k], b[k])
