"""The PyTorch port's MLP (varnet_tpu_torch.models.mlp) against the JAX
package's, on seeded inputs, plus the weight carry-over helpers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from varnet_tpu.models import mlp as jmlp
from varnet_tpu.utils import io as jio
from varnet_tpu_torch.models import mlp as tmlp
from varnet_tpu_torch.utils import io as tio

RTOL = ATOL = 1e-6   # f32, matmuls summed in another order


def _params(rng, sizes):
    return [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
             "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
            for a, b in zip(sizes[:-1], sizes[1:])]


def _scaling():
    lo, hi = np.array([0.0, -1.0, 0.0]), np.array([1.0, 2.0, 0.5])
    return jmlp.make_input_scaling(lo, hi), tmlp.make_input_scaling(lo, hi)


def test_input_scaling_bit_equal():
    (js, jsh), (ts, tsh) = _scaling()
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tsh.numpy(), np.asarray(jsh))


@pytest.mark.parametrize("activation", ["tanh", "sigmoid", "sin"])
@pytest.mark.parametrize("widths", [(20, 20), (8, 8, 8)], ids=["w20x2", "w8x3"])
def test_apply_and_value_and_jac_match_jax(widths, activation):
    rng = np.random.default_rng(0)
    raw = _params(rng, (3,) + widths + (1,))
    x = rng.uniform(-0.2, 1.2, (257, 3)).astype(np.float32)
    (js, jsh), (ts, tsh) = _scaling()
    jp = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in raw]
    tp = tmlp.params_from_jax(raw)

    u_ref = np.asarray(jmlp.mlp_apply(jp, jnp.asarray(x), activation, js, jsh))
    u = tmlp.mlp_apply(tp, torch.from_numpy(x), activation, ts, tsh).numpy()
    np.testing.assert_allclose(u, u_ref, rtol=RTOL, atol=ATOL)

    v_ref, du_ref = jmlp.mlp_value_and_jac(jp, jnp.asarray(x), activation, js, jsh)
    v, du = tmlp.mlp_value_and_jac(tp, torch.from_numpy(x), activation, ts, tsh)
    np.testing.assert_allclose(v.numpy(), np.asarray(v_ref), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(du.numpy(), np.asarray(du_ref), rtol=RTOL, atol=ATOL)


def test_value_and_jac_matches_autograd():
    rng = np.random.default_rng(1)
    tp = tmlp.params_from_jax(_params(rng, (3, 8, 8, 8, 1)))
    x = torch.from_numpy(rng.uniform(0, 1, (33, 3)).astype(np.float32)).requires_grad_(True)
    _, (ts, tsh) = _scaling()
    u, du = tmlp.mlp_value_and_jac(tp, x, "tanh", ts, tsh)
    u_ad = tmlp.mlp_apply(tp, x, "tanh", ts, tsh)
    (du_ad,) = torch.autograd.grad(u_ad.sum(), x)
    np.testing.assert_allclose(u.detach().numpy(), u_ad.detach().numpy(), rtol=1e-6)
    np.testing.assert_allclose(du.detach().numpy(), du_ad.numpy(), rtol=1e-5, atol=1e-6)


def test_params_round_trip():
    raw = _params(np.random.default_rng(2), (3, 20, 20, 1))
    back = tmlp.params_to_numpy(tmlp.params_from_jax(raw))
    for a, b in zip(raw, back):
        for k in ("w", "b"):
            np.testing.assert_array_equal(a[k], b[k])
            assert b[k].dtype == np.float32


def test_init_mlp_is_seeded_glorot():
    p1 = tmlp.init_mlp(torch.Generator().manual_seed(3), 3, (48, 48))
    p2 = tmlp.init_mlp(torch.Generator().manual_seed(3), 3, (48, 48))
    assert [tuple(l["w"].shape) for l in p1] == [(3, 48), (48, 48), (48, 1)]
    for a, b in zip(p1, p2):
        assert torch.equal(a["w"], b["w"]) and not a["b"].any()
    std = float(p1[1]["w"].std())
    assert abs(std - np.sqrt(2.0 / 96)) < 0.02


def test_theta_npz_interchange(tmp_path):
    """A theta saved by either package loads bit-equal in the other."""
    raw = _params(np.random.default_rng(4), (3, 8, 8, 1))
    tio.save_theta_npz(tmp_path / "port.npz", tmlp.params_from_jax(raw), prefix="net_")
    jio.save_theta_npz(str(tmp_path / "jax.npz"), raw)
    from_port = jio.load_theta_npz(str(tmp_path / "port.npz"), prefix="net_")
    from_jax = tio.load_theta_npz(str(tmp_path / "jax.npz"))
    for a, b, c in zip(raw, from_port, from_jax):
        for k in ("w", "b"):
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(a[k], c[k])
