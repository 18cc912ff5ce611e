"""The port's Fourier-feature model functions (varnet_tpu_torch.models.mlp:
``make_fourier_features``, ``ff_apply``, ``ff_value_and_jac``) against the JAX
package's, on the same B and theta made with numpy, single- and multi-scale, with
and without input scaling.  rtol 1e-5: f32 products in another summation order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from varnet_tpu.models import mlp as jmlp
from varnet_tpu_torch.models import mlp

LO, HI = np.array([0.0, 0.0, 0.0]), np.array([2.0, 1.0, 1.0])


@pytest.mark.parametrize("n_feat,scale,counts", [
    (8, 0.7, [8]), (128, (0.5, 2.0), [64, 64]), (7, "0.5,2.0,1.0", [3, 2, 2]),
    (9, "1.5", [9])])
def test_make_fourier_features_split_and_shape(n_feat, scale, counts):
    """Shape [n_in, F]; several scales split F evenly, remainder to the first
    block, each block drawn at its own std; the string form parses like the
    list; the draw is the generator's."""
    gen = torch.Generator().manual_seed(0)
    b = mlp.make_fourier_features(gen, 3, n_feat, scale)
    assert b.shape == (3, n_feat) and b.dtype == torch.float32
    scales = ([float(s) for s in scale.split(",")] if isinstance(scale, str)
              else list(np.atleast_1d(scale)))
    ref_gen = torch.Generator().manual_seed(0)
    blocks = [s * torch.randn((3, n), generator=ref_gen) for s, n in zip(scales, counts)]
    torch.testing.assert_close(b, torch.cat(blocks, dim=1), rtol=0, atol=0)
    jb = jmlp.make_fourier_features(__import__("jax").random.PRNGKey(0), 3, n_feat, scale)
    assert tuple(jb.shape) == tuple(b.shape)


def _case(multiscale, seed=0, n_feat=8, widths=(16, 16), p=200):
    rng = np.random.default_rng(seed)
    if multiscale:
        b = np.concatenate([0.5 * rng.standard_normal((3, n_feat // 2)),
                            2.0 * rng.standard_normal((3, n_feat - n_feat // 2))], axis=1)
    else:
        b = 0.7 * rng.standard_normal((3, n_feat))
    sizes = (2 * n_feat,) + widths + (1,)
    theta = [{"w": (rng.standard_normal((a, c)) * np.sqrt(2.0 / (a + c))).astype(np.float32),
              "b": (0.1 * rng.standard_normal(c)).astype(np.float32)}
             for a, c in zip(sizes[:-1], sizes[1:])]
    x = (LO + (HI - LO) * rng.random((p, 3))).astype(np.float32)
    return b.astype(np.float32), theta, x


@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "raw"])
@pytest.mark.parametrize("multiscale", [False, True], ids=["single", "multi"])
def test_ff_apply_and_value_and_jac_match_jax(multiscale, scaled):
    b, theta, x = _case(multiscale)
    jscale = jshift = scale = shift = None
    if scaled:
        jscale, jshift = jmlp.make_input_scaling(LO, HI)
        scale, shift = mlp.make_input_scaling(LO, HI)
    jtheta = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in theta]
    ju = jmlp.ff_apply(jnp.asarray(b), jtheta, jnp.asarray(x), "tanh", jscale, jshift)
    jv, jdu = jmlp.ff_value_and_jac(jnp.asarray(b), jtheta, jnp.asarray(x), "tanh",
                                    jscale, jshift)
    params = mlp.params_from_jax(theta)
    tb, tx = torch.from_numpy(b), torch.from_numpy(x)
    u = mlp.ff_apply(tb, params, tx, "tanh", scale, shift)
    v, du = mlp.ff_value_and_jac(tb, params, tx, "tanh", scale, shift)
    for got, ref in ((u, ju), (v, jv), (du, jdu)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(ref).max()))


def test_ff_value_and_jac_is_the_jacobian_of_ff_apply():
    """du equals autograd's input gradient of ff_apply (float64)."""
    b, theta, x = _case(True, seed=1, p=40)
    params = mlp.params_from_jax(theta, dtype=torch.float64)
    tb = torch.from_numpy(b).double()
    scale, shift = mlp.make_input_scaling(LO, HI, dtype=torch.float64)
    xt = torch.from_numpy(x).double().requires_grad_(True)
    u = mlp.ff_apply(tb, params, xt, "sigmoid", scale, shift)
    (g,) = torch.autograd.grad(u.sum(), xt)
    _, du = mlp.ff_value_and_jac(tb, params, xt.detach(), "sigmoid", scale, shift)
    np.testing.assert_allclose(du.numpy(), g.numpy(), rtol=1e-10, atol=1e-12)
