"""The port's Fourier-feature value + jacobian (``ops/value_and_jac.py``: K7
forward and backward, K8, run as their plain versions on the CPU) against the JAX
package's ``pallas_ff_value_and_jac`` (custom-VJP backward) and
``pallas_ff_value_and_jac_jvp`` in interpret mode, and ``FfValueAndJacFn``'s two
rules against autograd / ``torch.func.jvp`` of the plain forward.

Tolerances as in tests/test_torch_value_and_jac.py: rtol 2e-5 for values and
5e-4 for gradients and tangents (f32 sums in another order, one more layer of
chain rule), each with an atol of the same fraction of the largest entry (the
angles of the embedding reach tens of radians at raw inputs)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from varnet_tpu.models.mlp import make_input_scaling as jax_scaling
from varnet_tpu.ops.pallas_mlp import pallas_ff_value_and_jac, pallas_ff_value_and_jac_jvp
from varnet_tpu_torch.models.mlp import make_input_scaling, params_from_jax
from varnet_tpu_torch.ops import value_and_jac as vj

LO, HI = np.array([0.0, 0.0, 0.0, -1.0]), np.array([2.0, 1.0, 1.0, 1.0])


def _close(got, ref, rtol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=rtol * float(np.abs(ref).max()))


def _case(n_in=3, n_feat=8, widths=(16, 16), p=300, seed=0):
    rng = np.random.default_rng(seed)
    b = np.concatenate([0.5 * rng.standard_normal((n_in, n_feat // 2)),
                        2.0 * rng.standard_normal((n_in, n_feat - n_feat // 2))], 1)
    sizes = (2 * n_feat,) + tuple(widths) + (1,)
    theta = [{"w": (rng.standard_normal((a, c)) * np.sqrt(2.0 / (a + c))).astype(np.float32),
              "b": (0.1 * rng.standard_normal(c)).astype(np.float32)}
             for a, c in zip(sizes[:-1], sizes[1:])]
    tangent = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in layer.items()}
               for layer in theta]
    x = (LO[:n_in] + (HI - LO)[:n_in] * rng.random((p, n_in))).astype(np.float32)
    cu = rng.standard_normal(p).astype(np.float32)
    cd = rng.standard_normal((p, n_in)).astype(np.float32)
    return b.astype(np.float32), theta, tangent, x, cu, cd


def _leaves(params):
    return [layer[k] for layer in params for k in ("w", "b")]


@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "raw"])
@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
def test_port_matches_pallas_ff_interpret(activation, scaled):
    b, theta, tangent, x, cu, cd = _case()
    jscale = jshift = scale = shift = None
    if scaled:
        jscale, jshift = jax_scaling(LO[:3], HI[:3])
        scale, shift = make_input_scaling(LO[:3], HI[:3])
    pvj = functools.partial(pallas_ff_value_and_jac, jnp.asarray(b), tile=128, interpret=True)
    pjvp = functools.partial(pallas_ff_value_and_jac_jvp, jnp.asarray(b), tile=128,
                             interpret=True)
    jraw = jax.tree_util.tree_map(jnp.asarray, theta)

    def jloss(prm):
        u, du = pvj(prm, jnp.asarray(x), activation, jscale, jshift)
        return jnp.sum(u * cu) + jnp.sum(du * cd)

    ju, jdu = pvj(jraw, jnp.asarray(x), activation, jscale, jshift)
    jgrad = jax.grad(jloss)(jraw)
    _, (jtu, jtdu) = jax.jvp(lambda prm: pjvp(prm, jnp.asarray(x), activation, jscale, jshift),
                             (jraw,), (jax.tree_util.tree_map(jnp.asarray, tangent),))

    tb = torch.from_numpy(b)
    leaves = [t.requires_grad_(True) for t in _leaves(params_from_jax(theta))]
    prm = vj._as_params(leaves)
    before = (vj.ff_vj_fwd.launches, vj.ff_vj_bwd.launches, vj.ff_vj_jvp.launches)
    u, du = vj.ff_value_and_jac(tb, prm, torch.from_numpy(x), activation, scale, shift)
    _close(u.detach(), ju, 2e-5)
    _close(du.detach(), jdu, 2e-5)
    loss = (u * torch.from_numpy(cu)).sum() + (du * torch.from_numpy(cd)).sum()
    for g, ref in zip(torch.autograd.grad(loss, leaves), _leaves(jgrad)):
        _close(g, ref, 5e-4)
    with torch.no_grad(), fwAD.dual_level():
        duals = vj._as_params([fwAD.make_dual(a.detach(), t)
                               for a, t in zip(leaves, _leaves(params_from_jax(tangent)))])
        u2, du2 = vj.ff_value_and_jac(tb, duals, torch.from_numpy(x), activation, scale, shift)
        tu, tdu = fwAD.unpack_dual(u2).tangent, fwAD.unpack_dual(du2).tangent
    _close(tu, jtu, 5e-4)
    _close(tdu, jtdu, 5e-4)
    assert (vj.ff_vj_fwd.launches, vj.ff_vj_bwd.launches, vj.ff_vj_jvp.launches) == before


@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
@pytest.mark.parametrize("n_in,widths", [(1, (8,)), (3, (13, 20, 7)), (4, (16, 16))])
def test_ff_function_rules_match_autograd(n_in, widths, activation):
    """FfValueAndJacFn's backward (K7's closed form) and jvp (K8) equal autograd
    and torch.func.jvp of the plain K7 forward, in float64 to isolate the math."""
    b, theta, tangent, x, _, _ = _case(n_in=n_in, widths=widths, p=77, seed=3)
    params = params_from_jax(theta, dtype=torch.float64)
    tan = params_from_jax(tangent, dtype=torch.float64)
    bt = ((2.0 * np.pi) * torch.from_numpy(b).double().T).contiguous()
    xs_t = torch.from_numpy(x).double().T.contiguous()
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((1 + n_in, 77)))
    leaves = [t.clone().requires_grad_(True) for t in _leaves(params)]
    ref = torch.autograd.grad((vj.ff_vj_fwd_plain(vj._as_params(leaves), xs_t, bt, activation)
                               * g).sum(), leaves)
    got = torch.autograd.grad(vj.FfValueAndJacFn.apply(xs_t, bt, activation, *leaves), leaves, g)
    for a, c in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-10, atol=1e-12)
    _, jref = torch.func.jvp(
        lambda *fl: vj.ff_vj_fwd_plain(vj._as_params(fl), xs_t, bt, activation),
        tuple(_leaves(params)), tuple(_leaves(tan)))
    _, jgot = torch.func.jvp(lambda *fl: vj.FfValueAndJacFn.apply(xs_t, bt, activation, *fl),
                             tuple(_leaves(params)), tuple(_leaves(tan)))
    np.testing.assert_allclose(jgot.numpy(), jref.numpy(), rtol=1e-10, atol=1e-12)


def test_ff_value_and_jac_matches_the_model_function():
    """The drop-in keeps ``models.mlp.ff_value_and_jac``'s contract: du with
    respect to the ORIGINAL coordinates, no gradient to x."""
    from varnet_tpu_torch.models.mlp import ff_value_and_jac

    b, theta, _, x, _, _ = _case(p=50)
    params = params_from_jax(theta)
    scale, shift = make_input_scaling(LO[:3], HI[:3])
    xt = torch.from_numpy(x).requires_grad_(True)
    u, du = vj.ff_value_and_jac(torch.from_numpy(b), params, xt, "tanh", scale, shift)
    ur, dur = ff_value_and_jac(torch.from_numpy(b), params, xt, "tanh", scale, shift)
    _close(u.detach(), ur.detach(), 2e-5)
    _close(du.detach(), dur.detach(), 2e-5)
    assert not u.requires_grad


@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
@pytest.mark.parametrize("widths", [(72, 40), (128,)])
def test_no_embedding_matches_pallas_value_and_jac(widths, activation):
    """With bt None the K7 / K8 plain versions (and FfValueAndJacFn's rules) are
    the plain net's value + jacobian: held to K5 / K6 in interpret mode at widths
    above K5's 64, which the port runs on K7 / K8 on CUDA."""
    from varnet_tpu.ops.pallas_mlp import pallas_value_and_jac, pallas_value_and_jac_jvp

    _, theta, tangent, x, cu, cd = _case(widths=widths, p=200, seed=4)
    rng = np.random.default_rng(6)
    theta[0]["w"] = (rng.standard_normal((3, widths[0])) / np.sqrt(3.0)).astype(np.float32)
    tangent[0]["w"] = rng.standard_normal((3, widths[0])).astype(np.float32)
    jscale, jshift = jax_scaling(LO[:3], HI[:3])
    jraw = jax.tree_util.tree_map(jnp.asarray, theta)
    pvj = functools.partial(pallas_value_and_jac, tile=128, interpret=True)
    pjvp = functools.partial(pallas_value_and_jac_jvp, tile=128, interpret=True)

    def jloss(prm):
        u, du = pvj(prm, jnp.asarray(x), activation, jscale, jshift)
        return jnp.sum(u * cu) + jnp.sum(du * cd)

    ju, jdu = pvj(jraw, jnp.asarray(x), activation, jscale, jshift)
    jgrad = jax.grad(jloss)(jraw)
    _, (jtu, jtdu) = jax.jvp(lambda prm: pjvp(prm, jnp.asarray(x), activation, jscale, jshift),
                             (jraw,), (jax.tree_util.tree_map(jnp.asarray, tangent),))

    scale, shift = make_input_scaling(LO[:3], HI[:3])
    xs_t = ((torch.from_numpy(x) - shift) * scale).T.contiguous()
    leaves = [t.requires_grad_(True) for t in _leaves(params_from_jax(theta))]
    out = vj.FfValueAndJacFn.apply(xs_t, None, activation, *leaves)
    _close(out[0].detach(), ju, 2e-5)
    _close((out[1:] * scale[:, None]).T.detach(), jdu, 2e-5)
    g = torch.cat([torch.from_numpy(cu)[None], (torch.from_numpy(cd) * scale).T])
    for a, ref in zip(torch.autograd.grad(out, leaves, g), _leaves(jgrad)):
        _close(a, ref, 5e-4)
    with torch.no_grad(), fwAD.dual_level():
        duals = [fwAD.make_dual(a.detach(), t)
                 for a, t in zip(leaves, _leaves(params_from_jax(tangent)))]
        dout = fwAD.unpack_dual(vj.FfValueAndJacFn.apply(xs_t, None, activation, *duals)).tangent
    _close(dout[0], jtu, 5e-4)
    _close((dout[1:] * scale[:, None]).T, jtdu, 5e-4)
