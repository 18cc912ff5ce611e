"""The port's value + jacobian evaluation (varnet_tpu_torch.ops.value_and_jac) on
the CPU, where it runs its plain PyTorch versions, against the JAX package's
Pallas kernels K5 (``pallas_value_and_jac``: forward and custom-VJP backward)
and K6 (``pallas_value_and_jac_jvp``) in interpret mode, and the autograd
Function's two rules against autograd / ``torch.func.jvp`` of
``mlp_value_and_jac``.

Tolerances are those of tests/test_pallas_mlp.py: rtol 2e-5 / atol 2e-6 for
values, rtol 5e-4 / atol 5e-5 for gradients and tangents (f32 sums in another
order, through one more layer of chain rule).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from varnet_tpu.models.mlp import make_input_scaling as jax_scaling
from varnet_tpu.ops.pallas_mlp import pallas_value_and_jac, pallas_value_and_jac_jvp
from varnet_tpu_torch.models.mlp import (
    leaf_segments,
    make_input_scaling,
    mlp_value_and_jac,
    params_from_jax,
    ravel_params,
)
from varnet_tpu_torch.ops import value_and_jac as vj

VAL = dict(rtol=2e-5, atol=2e-6)
GRAD = dict(rtol=5e-4, atol=5e-5)
LO, HI = np.array([0.0, -1.0, 2.0]), np.array([2.0, 3.0, 7.0])


def _theta(n_in, widths, seed=0):
    rng = np.random.default_rng(seed)
    sizes = (n_in,) + tuple(widths) + (1,)
    return [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b))).astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _inputs(p, seed=1):
    """Points inside [LO, HI] (scaled onto [-1, 1]), a cotangent pair (cu, cd)
    and a parameter tangent seed."""
    rng = np.random.default_rng(seed)
    x = (LO + (HI - LO) * rng.random((p, 3))).astype(np.float32)
    cu = rng.standard_normal(p).astype(np.float32)
    cd = rng.standard_normal((p, 3)).astype(np.float32)
    return x, cu, cd


def _tangent_like(raw, seed=2):
    rng = np.random.default_rng(seed)
    return [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in layer.items()}
            for layer in raw]


def _leaves(params):
    return [layer[k] for layer in params for k in ("w", "b")]


@pytest.mark.parametrize("activation", ["tanh", "sigmoid", "sin"])
@pytest.mark.parametrize("widths", [(8, 8), (16, 16, 16)])
def test_port_matches_pallas_interpret(widths, activation):
    """u, du (scaled inputs, P = 300: not a tile multiple), the parameter
    gradient of sum(u cu + du cd) and the JVP along a parameter tangent,
    against K5 / K6 in interpret mode at tile 128."""
    p = 300
    raw = _theta(3, widths)
    tan = _tangent_like(raw)
    x, cu, cd = _inputs(p)
    jscale, jshift = jax_scaling(LO, HI)
    pvj = functools.partial(pallas_value_and_jac, tile=128, interpret=True)
    pjvp = functools.partial(pallas_value_and_jac_jvp, tile=128, interpret=True)
    jraw = jax.tree_util.tree_map(jnp.asarray, raw)

    def jloss(prm):
        u, du = pvj(prm, jnp.asarray(x), activation, jscale, jshift)
        return jnp.sum(u * cu) + jnp.sum(du * cd)

    ju, jdu = pvj(jraw, jnp.asarray(x), activation, jscale, jshift)
    jgrad = jax.grad(jloss)(jraw)
    _, (jdu_t, jddu_t) = jax.jvp(lambda prm: pjvp(prm, jnp.asarray(x), activation, jscale,
                                                  jshift),
                                 (jraw,), (jax.tree_util.tree_map(jnp.asarray, tan),))

    scale, shift = make_input_scaling(LO, HI)
    leaves = [t.requires_grad_(True) for t in _leaves(params_from_jax(raw))]
    prm = vj._as_params(leaves)
    u, du = vj.value_and_jac(prm, torch.from_numpy(x), activation, scale, shift)
    np.testing.assert_allclose(u.detach().numpy(), np.asarray(ju), **VAL)
    np.testing.assert_allclose(du.detach().numpy(), np.asarray(jdu), **VAL)
    loss = (u * torch.from_numpy(cu)).sum() + (du * torch.from_numpy(cd)).sum()
    grads = torch.autograd.grad(loss, leaves)
    for g, ref in zip(grads, _leaves(jgrad)):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), **GRAD)

    import torch.autograd.forward_ad as fwAD

    with torch.no_grad(), fwAD.dual_level():
        duals = vj._as_params([fwAD.make_dual(a.detach(), t)
                               for a, t in zip(leaves, _leaves(params_from_jax(tan)))])
        u2, du2 = vj.value_and_jac(duals, torch.from_numpy(x), activation, scale, shift)
        tu, tdu = fwAD.unpack_dual(u2).tangent, fwAD.unpack_dual(du2).tangent
    np.testing.assert_allclose(tu.numpy(), np.asarray(jdu_t), **GRAD)
    np.testing.assert_allclose(tdu.numpy(), np.asarray(jddu_t), **GRAD)


@pytest.mark.parametrize("activation", ["tanh", "sigmoid", "sin"])
@pytest.mark.parametrize("n_in,widths", [(1, (8,)), (2, (13, 20, 7)), (3, (20, 20)),
                                         (4, (16, 16, 16))])
def test_function_rules_match_autograd(n_in, widths, activation):
    """ValueAndJacFn's backward (K5's closed form) and jvp (K6) equal autograd
    and torch.func.jvp of the plain forward, in float64 to isolate the math."""
    raw = _theta(n_in, widths, seed=3)
    params = params_from_jax(raw, dtype=torch.float64)
    tangent = params_from_jax(_tangent_like(raw), dtype=torch.float64)
    xs_t = torch.from_numpy(np.random.default_rng(4).uniform(-1, 1, (n_in, 77)))
    g = torch.from_numpy(np.random.default_rng(5).standard_normal((1 + n_in, 77)))
    leaves = [t.clone().requires_grad_(True) for t in _leaves(params)]
    ref = torch.autograd.grad((vj.vj_fwd_plain(vj._as_params(leaves), xs_t, activation)
                               * g).sum(), leaves)
    out = vj.ValueAndJacFn.apply(xs_t, activation, None, *leaves)
    got = torch.autograd.grad(out, leaves, g)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-12)
    _, jref = torch.func.jvp(lambda *fl: vj.vj_fwd_plain(vj._as_params(fl), xs_t, activation),
                             tuple(_leaves(params)), tuple(_leaves(tangent)))
    _, jgot = torch.func.jvp(lambda *fl: vj.ValueAndJacFn.apply(xs_t, activation, None, *fl),
                             tuple(_leaves(params)), tuple(_leaves(tangent)))
    np.testing.assert_allclose(jgot.numpy(), jref.numpy(), rtol=1e-10, atol=1e-12)


def test_value_and_jac_matches_mlp_value_and_jac():
    """The drop-in keeps mlp_value_and_jac's contract: du w.r.t. the ORIGINAL
    coordinates, and no gradient reaches x."""
    raw = _theta(3, (20, 20))
    params = params_from_jax(raw)
    scale, shift = make_input_scaling(LO, HI)
    x = torch.from_numpy(_inputs(50)[0]).requires_grad_(True)
    u, du = vj.value_and_jac(params, x, "tanh", scale, shift)
    ur, dur = mlp_value_and_jac(params, x, "tanh", scale, shift)
    np.testing.assert_allclose(u.detach().numpy(), ur.detach().numpy(), **VAL)
    np.testing.assert_allclose(du.detach().numpy(), dur.detach().numpy(), **VAL)
    assert not u.requires_grad


def test_cpu_wrappers_launch_nothing_and_refuse_sin():
    """The CPU route takes the plain versions and counts no launch, for sin too,
    also where the card takes csrc/ff_mlp.cu (a hidden width above 64, K7 / K8):
    there the K7 plain version equals K5's; an unknown activation is refused."""
    params = params_from_jax(_theta(3, (8, 8)))
    xs_t = torch.from_numpy(_inputs(10)[0]).T.contiguous()
    before = (vj.vj_fwd.launches, vj.vj_bwd.launches, vj.vj_jvp.launches,
              vj.ff_vj_fwd.launches)
    for act in ("tanh", "sin"):
        vj.vj_fwd(params, xs_t, act)
        vj.vj_bwd(params, xs_t, act, torch.ones(4, 10))
        vj.vj_jvp(params, xs_t, act, params)
    wide = params_from_jax(_theta(3, (72, 8)))
    torch.testing.assert_close(vj.ff_vj_fwd(wide, xs_t, None, "sin"),
                               vj.vj_fwd(wide, xs_t, "sin"), rtol=2e-5, atol=2e-5)
    assert (vj.vj_fwd.launches, vj.vj_bwd.launches, vj.vj_jvp.launches,
            vj.ff_vj_fwd.launches) == before
    with pytest.raises(ValueError, match="unknown activation"):
        vj.ff_vj_fwd(params, xs_t, None, "relu")


@pytest.mark.parametrize("widths", [(20, 20), (48, 48, 48)])
def test_ravel_params_matches_ravel_pytree(widths):
    raw = _theta(3, widths)
    jflat, jun = ravel_pytree(jax.tree_util.tree_map(jnp.asarray, raw))
    flat, unravel = ravel_params(params_from_jax(raw))
    np.testing.assert_array_equal(flat.numpy(), np.asarray(jflat))
    sizes = [int(np.size(leaf)) for leaf in jax.tree_util.tree_leaves(raw)]
    np.testing.assert_array_equal(leaf_segments(params_from_jax(raw)),
                                  np.repeat(np.arange(len(sizes)), sizes))
    for a, b in zip(unravel(flat), jun(jflat)):
        for k in ("w", "b"):
            np.testing.assert_array_equal(a[k].numpy(), np.asarray(b[k]))
    assert unravel(flat)[0]["w"].data_ptr() == flat[widths[0]:].data_ptr()  # views
