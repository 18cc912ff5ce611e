"""The port's Fourier-feature fused residual (K2-FF's plain version, reached
through ``ops/fused_residual.py`` on CPU tensors) against the JAX package: the
forward against ``pallas_fused_residual(..., fourier_bt=bt)`` in interpret mode
(the case of tests/test_pallas_residual.py:455-481: disc 8, t_disc 4, F 8, width
16 x 2; rtol 1e-5), the closed-form backward against ``jax.grad`` of the JAX
package's plain reference (ff_value_and_jac + weak_residual; rtol 1e-4: f32 sums
over all points in another order), with and without input scaling.  The same B
and theta, made with numpy, go into both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from varnet_tpu.fem.assembly import build_fixed_data as jax_build_fixed_data
from varnet_tpu.models.mlp import ff_value_and_jac as jax_ff_value_and_jac
from varnet_tpu.models.mlp import make_input_scaling as jax_scaling
from varnet_tpu.ops.pallas_residual import pallas_fused_residual
from varnet_tpu.ops.residual import weak_residual
from varnet_tpu.problems.analytic import transient_ad_2d as jax_transient_ad_2d
from varnet_tpu_torch.fem.assembly import build_fixed_data
from varnet_tpu_torch.models.mlp import make_input_scaling, params_from_jax
from varnet_tpu_torch.ops import fused_residual as fr
from varnet_tpu_torch.problems.analytic import transient_ad_2d


def _theta(n_feat=8, widths=(16, 16), seed=0):
    rng = np.random.default_rng(seed)
    sizes = (2 * n_feat,) + widths + (1,)
    return [{"w": (rng.standard_normal((a, c)) * np.sqrt(2.0 / (a + c))).astype(np.float32),
             "b": (0.1 * rng.standard_normal(c)).astype(np.float32)}
            for a, c in zip(sizes[:-1], sizes[1:])]


def _b(multiscale, n_feat=8, seed=3):
    rng = np.random.default_rng(seed)
    if multiscale:
        return np.concatenate([0.5 * rng.standard_normal((3, n_feat // 2)),
                               2.0 * rng.standard_normal((3, n_feat // 2))], 1).astype(np.float32)
    return (0.7 * rng.standard_normal((3, n_feat))).astype(np.float32)


@pytest.fixture(scope="module")
def mesh():
    jfd = jax_build_fixed_data(jax_transient_ad_2d()["pde"], 8, t_disc_num=4, b_disc_num=4)
    fd = build_fixed_data(transient_ad_2d()["pde"], 8, t_disc_num=4, b_disc_num=4)
    return jfd, fd


def _port_data(fd, b, scaled):
    st = fd.static
    scale, shift = make_input_scaling(st.input_lo, st.input_hi) if scaled else (None, None)
    bt = ((2.0 * np.pi) * torch.from_numpy(b).T).contiguous()
    return fr.prepare_residual_data(fd.quad, scale, shift, time_dependent=True,
                                    has_react=False, fourier_bt=bt)


def _jax_args(jfd, b, scaled):
    st = jfd.static
    quad = jax.tree_util.tree_map(jnp.asarray, jfd.quad)
    scale, shift = jax_scaling(st.input_lo, st.input_hi) if scaled else (None, None)
    return quad, scale, shift, (2.0 * jnp.pi) * jnp.transpose(jnp.asarray(b))


@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "raw"])
@pytest.mark.parametrize("multiscale", [False, True], ids=["single", "multi"])
def test_forward_matches_pallas_interpret(mesh, multiscale, scaled):
    jfd, fd = mesh
    b, theta = _b(multiscale), _theta()
    quad, scale, shift, bt = _jax_args(jfd, b, scaled)
    jtheta = jax.tree_util.tree_map(jnp.asarray, theta)
    r_ref = pallas_fused_residual(jtheta, quad, "tanh", scale, shift, time_dependent=True,
                                  tile=49, interpret=True, fourier_bt=bt)
    data = _port_data(fd, b, scaled)
    before = fr.dir_residual_ff_fwd.launches
    r = fr.dir_residual_ff_fwd(params_from_jax(theta), data, "tanh")
    assert fr.dir_residual_ff_fwd.launches == before  # CPU tensors: the plain version
    np.testing.assert_allclose(r.numpy(), np.asarray(r_ref), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(r_ref)).max()))


@pytest.mark.parametrize("scaled", [True, False], ids=["scaled", "raw"])
@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
def test_backward_matches_jax_grad_of_the_plain_reference(mesh, activation, scaled):
    jfd, fd = mesh
    b, theta = _b(True), _theta(seed=1)
    quad, scale, shift, _ = _jax_args(jfd, b, scaled)
    st = jfd.static
    k, nq, _ = quad.coords.shape
    gr = np.random.default_rng(5).standard_normal(k).astype(np.float32)

    def loss(prm):
        u, du = jax_ff_value_and_jac(jnp.asarray(b), prm,
                                     quad.coords.reshape(k * nq, st.n_inputs), activation,
                                     scale, shift)
        r = weak_residual(du[:, :2].reshape(k, nq, 2), quad.N, quad.dN, quad.w, quad.kappa,
                          quad.vel, quad.src, du[:, 2].reshape(k, nq))
        return jnp.sum(r * gr)

    jgrad = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, theta))
    data = _port_data(fd, b, scaled)
    params = params_from_jax(theta)
    grads = fr.dir_residual_ff_bwd(params, data, activation, torch.from_numpy(gr))
    for g, ref in zip(grads, jgrad):
        for key in ("w", "b"):
            ref_k = np.asarray(ref[key])
            np.testing.assert_allclose(g[key].numpy(), ref_k, rtol=1e-4,
                                       atol=1e-4 * float(np.abs(ref_k).max()))
    # the autograd Function carries the same closed form
    leaves = [layer[key].clone().requires_grad_(True) for layer in params for key in ("w", "b")]
    r = fr.DirResidualFn.apply(data, activation, *leaves)
    auto = torch.autograd.grad(r, leaves, torch.from_numpy(gr))
    flat = [g[key] for g in grads for key in ("w", "b")]
    for a, c in zip(auto, flat):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_ff_data_layout_and_kernel_limits(mesh):
    """Raw inputs keep the coordinates and a unit scale column; the packed
    layout puts every leaf where csrc/ff_mlp.cu reads it; the kernel refuses
    what it does not take."""
    _, fd = mesh
    data = _port_data(fd, _b(False), scaled=False)
    k, nq, n_in = fd.quad.coords.shape
    np.testing.assert_array_equal(data.xs.numpy(),
                                  np.asarray(fd.quad.coords, np.float32).reshape(-1, n_in).T)
    assert torch.equal(data.scale, torch.ones(3)) and data.bt.shape == (8, 3)
    params = params_from_jax(_theta(n_feat=8, widths=(16, 40)))
    hp, fp = fr.ff_dims(params)
    assert (hp, fp) == (64, 16)
    buf = fr.ff_pack(params, hp, fp)
    ke = 2 * fp
    w0 = buf[:ke * hp].view(ke, hp)
    torch.testing.assert_close(w0[:8, :16], params[0]["w"][:8])       # sin rows
    torch.testing.assert_close(w0[fp:fp + 8, :16], params[0]["w"][8:])  # cos rows
    assert float(w0[8:fp].abs().sum()) == 0.0 and float(w0[:, 16:].abs().sum()) == 0.0
    back = fr.ff_unpack(buf, params, hp, fp)
    for a, c in zip(back, params):
        torch.testing.assert_close(a["w"], c["w"], rtol=0, atol=0)
        torch.testing.assert_close(a["b"], c["b"], rtol=0, atol=0)
    bt = data.bt
    with pytest.raises(ValueError, match="hidden width"):
        fr.check_ff_args(params_from_jax(_theta(widths=(130, 8))), bt, (data.xs,), "tanh")
    with pytest.raises(ValueError, match="Fourier features"):
        fr.check_ff_args(params, torch.zeros(129, 3), (data.xs,), "tanh")
    with pytest.raises(ValueError):
        fr.check_ff_args(params, bt, (data.xs,), "sin")


def test_no_embedding_layout_and_routing(mesh):
    """Without an embedding (``bt`` None) csrc/ff_mlp.cu's layer 0 is one 32-row
    K-slice holding the coordinates; a plain net wider than dir_residual.cu takes
    goes to those kernels on CUDA only, and its plain version is K1/K2's."""
    _, fd = mesh
    params = params_from_jax(
        [{"w": np.asarray(t["w"])[:3] if i == 0 else t["w"], "b": t["b"]}
         for i, t in enumerate(_theta(widths=(72, 40), seed=2))])
    hp, fp = fr.ff_dims(params, embedded=False)
    assert (hp, fp, fr.ff_ke(fp)) == (96, 0, 32)
    buf = fr.ff_pack(params, hp, fp)
    w0 = buf[:32 * hp].view(32, hp)
    torch.testing.assert_close(w0[:3, :72], params[0]["w"], rtol=0, atol=0)
    assert float(w0[3:].abs().sum()) == 0.0 and float(w0[:, 72:].abs().sum()) == 0.0
    for a, c in zip(fr.ff_unpack(buf, params, hp, fp), params):
        torch.testing.assert_close(a["w"], c["w"], rtol=0, atol=0)
    assert fr.ff_bt(None, fp) is None
    fr.check_ff_args(params, None, (torch.zeros(3, 5),), "tanh")
    with pytest.raises(ValueError, match="layer 0"):
        fr.check_ff_args(params, None, (torch.zeros(2, 5),), "tanh")
    assert fr.uses_ff_kernels(params, on_cuda=True, embedded=False)
    assert not fr.uses_ff_kernels(params, on_cuda=False, embedded=False)
    narrow = [{"w": torch.zeros(3, 64), "b": torch.zeros(64)},
              {"w": torch.zeros(64, 1), "b": torch.zeros(1)}]
    assert not fr.uses_ff_kernels(narrow, on_cuda=True, embedded=False)
    st = fd.static
    scale, shift = make_input_scaling(st.input_lo, st.input_hi)
    data = fr.prepare_residual_data(fd.quad, scale, shift, time_dependent=True,
                                    has_react=False)
    gr = torch.from_numpy(np.random.default_rng(4).standard_normal(data.k).astype(np.float32))
    torch.testing.assert_close(fr.dir_residual_ff_fwd(params, data, "tanh"),
                               fr.dir_residual_fwd_plain(params, data, "tanh"), rtol=0, atol=0)
    for a, c in zip(fr.dir_residual_ff_bwd(params, data, "tanh", gr),
                    fr.dir_residual_bwd_plain(params, data, "tanh", gr)):
        torch.testing.assert_close(a["w"], c["w"], rtol=0, atol=0)
