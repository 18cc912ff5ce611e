"""The CUDA kernels (fused residual; value + jacobian K5/K6) against their plain
PyTorch versions on the card.

These tests need an NVIDIA GPU and nvcc; without them they skip.  The CUDA
machine has no JAX, and tests/conftest.py imports it, so run them with
``python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

from varnet_tpu_torch import VarNet
from varnet_tpu_torch.fem.assembly import build_fixed_data
from varnet_tpu_torch.models.mlp import init_mlp, make_input_scaling
from varnet_tpu_torch.ops import fused_residual as fr
from varnet_tpu_torch.ops import value_and_jac as vj
from varnet_tpu_torch.problems.analytic import steady_adr_1d, transient_ad_2d

pytestmark = pytest.mark.gpu

CASES = [
    ("2dt", transient_ad_2d, dict(disc_num=8, b_disc_num=6, t_disc_num=4), True, False),
    ("adr1d", steady_adr_1d, dict(disc_num=16), False, True),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
@pytest.mark.parametrize("widths", [(20, 20), (8, 8, 8), (13, 48, 7), (64, 64)])
@pytest.mark.parametrize("name,factory,kw,td,react", CASES, ids=[c[0] for c in CASES])
def test_kernel_matches_plain(cuda, name, factory, kw, td, react, widths, activation):
    fd = build_fixed_data(factory()["pde"], **kw)
    st = fd.static
    scale, shift = make_input_scaling(st.input_lo, st.input_hi)
    data = fr.prepare_residual_data(fd.quad, scale, shift, time_dependent=td,
                                    has_react=react, device=cuda)
    gen = torch.Generator().manual_seed(0)
    params = init_mlp(gen, st.n_inputs, widths, device=cuda)
    for layer in params:
        layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=gen).to(cuda)
    gr = torch.randn(data.k, generator=gen).to(cuda)
    launches = (fr.dir_residual_fwd.launches, fr.dir_residual_bwd.launches)
    r = fr.dir_residual_fwd(params, data, activation)
    grads = fr.dir_residual_bwd(params, data, activation, gr)
    torch.cuda.synchronize()
    assert (fr.dir_residual_fwd.launches, fr.dir_residual_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    assert _rel(r, fr.dir_residual_fwd_plain(params, data, activation)) < 1e-5
    for g, p in zip(grads, fr.dir_residual_bwd_plain(params, data, activation, gr)):
        for k in ("w", "b"):
            assert g[k].shape == p[k].shape
            if p[k].abs().max() > 0:
                assert _rel(g[k], p[k]) < 1e-4, (k, _rel(g[k], p[k]))


def test_backward_is_deterministic(cuda):
    fd = build_fixed_data(transient_ad_2d()["pde"], 8, b_disc_num=6, t_disc_num=4)
    scale, shift = make_input_scaling(fd.static.input_lo, fd.static.input_hi)
    data = fr.prepare_residual_data(fd.quad, scale, shift, time_dependent=True,
                                    has_react=False, device=cuda)
    params = init_mlp(torch.Generator().manual_seed(1), 3, (20, 20), device=cuda)
    gr = torch.linspace(-1.0, 1.0, data.k, device=cuda)
    g1 = fr.dir_residual_bwd(params, data, "tanh", gr)
    g2 = fr.dir_residual_bwd(params, data, "tanh", gr)
    for a, b in zip(g1, g2):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


def test_training_on_cuda_goes_through_the_kernel(cuda):
    vn = VarNet(transient_ad_2d()["pde"], layer_width=(20, 20), disc_num=8, b_disc_num=6,
                t_disc_num=4, device=cuda)
    before = (fr.dir_residual_fwd.launches, fr.dir_residual_bwd.launches)
    res = vn.train(epoch_num=5, weight=(1.0, 10.0, 10.0), save_freq=5, verbose=False,
                   error_disc=8, error_times=2)
    assert fr.dir_residual_fwd.launches - before[0] == 5
    assert fr.dir_residual_bwd.launches - before[1] == 5
    assert np.isfinite(res.losses[-1]["loss"])


# ---------------------------------------------------------------------------
# value + jacobian kernels (K5 forward / backward, K6 JVP) against their plain versions

VJ_WIDTHS = [(20, 20), (48, 48, 48), (13, 48, 7), (64, 64), (8,)]


def _vj_case(n_in, widths, p=1000, seed=0, device="cuda"):
    gen = torch.Generator().manual_seed(seed)
    params = init_mlp(gen, n_in, widths, device=device)
    for layer in params:
        layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=gen).to(device)
    xs_t = (2 * torch.rand((n_in, p), generator=gen) - 1).to(device)
    g = torch.randn((1 + n_in, p), generator=gen).to(device)
    tangent = [{k: torch.randn(v.shape, generator=gen).to(device) for k, v in layer.items()}
               for layer in params]
    return params, xs_t, g, tangent


@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
@pytest.mark.parametrize("widths", VJ_WIDTHS)
@pytest.mark.parametrize("n_in", [1, 3, 4])
def test_value_and_jac_kernels_match_plain(cuda, n_in, widths, activation):
    params, xs_t, g, tangent = _vj_case(n_in, widths)
    before = (vj.vj_fwd.launches, vj.vj_bwd.launches, vj.vj_jvp.launches)
    out = vj.vj_fwd(params, xs_t, activation)
    grads = vj.vj_bwd(params, xs_t, activation, g)
    dout = vj.vj_jvp(params, xs_t, activation, tangent)
    torch.cuda.synchronize()
    assert (vj.vj_fwd.launches, vj.vj_bwd.launches, vj.vj_jvp.launches) == tuple(
        b + 1 for b in before)
    assert _rel(out, vj.vj_fwd_plain(params, xs_t, activation)) < 1e-5
    assert _rel(dout, vj.vj_jvp_plain(params, xs_t, activation, tangent)) < 1e-4
    for a, b in zip(grads, vj.vj_bwd_plain(params, xs_t, activation, g)):
        for k in ("w", "b"):
            assert a[k].shape == b[k].shape
            assert _rel(a[k], b[k]) < 1e-4, (k, _rel(a[k], b[k]))


def test_value_and_jac_backward_is_deterministic(cuda):
    params, xs_t, g, _ = _vj_case(3, (48, 48, 48), p=20000)
    g1 = vj.vj_bwd(params, xs_t, "tanh", g)
    g2 = vj.vj_bwd(params, xs_t, "tanh", g)
    for a, b in zip(g1, g2):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


def test_value_and_jac_function_rules_on_cuda(cuda):
    """ValueAndJacFn's backward and jvp rules launch K5 bwd / K6 and agree with
    the plain versions."""
    params, xs_t, g, tangent = _vj_case(3, (20, 20))
    leaves = [layer[k].clone().requires_grad_(True) for layer in params for k in ("w", "b")]
    before = (vj.vj_bwd.launches, vj.vj_jvp.launches)
    out = vj.ValueAndJacFn.apply(xs_t, "tanh", *leaves)
    got = torch.autograd.grad(out, leaves, g)
    # forward-mode through dual tensors: torch.func.jvp's wrapped tensors have
    # no storage that a ctypes launch could read
    with torch.no_grad(), fwAD.dual_level():
        duals = [fwAD.make_dual(p, t) for p, t in zip(vj._leaves(params), vj._leaves(tangent))]
        dout = fwAD.unpack_dual(vj.ValueAndJacFn.apply(xs_t, "tanh", *duals)).tangent
    assert (vj.vj_bwd.launches, vj.vj_jvp.launches) == (before[0] + 1, before[1] + 1)
    ref = vj._leaves(vj.vj_bwd_plain(params, xs_t, "tanh", g))
    assert max(_rel(a, b) for a, b in zip(got, ref)) < 1e-4
    assert _rel(dout, vj.vj_jvp_plain(params, xs_t, "tanh", tangent)) < 1e-4


def test_value_and_jac_kernels_refuse_what_they_do_not_take(cuda):
    params, xs_t, _, _ = _vj_case(3, (20, 20))
    with pytest.raises(ValueError):
        vj.vj_fwd(params, xs_t, "sin")
    wide, xs_w, _, _ = _vj_case(3, (72, 72))
    with pytest.raises(ValueError):
        vj.vj_fwd(wide, xs_w, "tanh")


def test_refine_lm_on_cuda_goes_through_the_kernels(cuda):
    """LM J v runs K6 and J^T w K5's backward: each launches at least once per
    CG iteration; the kernel path and the plain path take the same steps."""
    kw = dict(layer_width=(20, 20), disc_num=8, b_disc_num=6, t_disc_num=4, device=cuda)
    lm = dict(steps=2, weight=(1.0, 10.0, 10.0), cg_iters=5, k_chunks=2, save_freq=1,
              verbose=False, error_disc=8, error_times=2)
    vn = VarNet(transient_ad_2d()["pde"], **kw)
    assert vn.use_pallas
    before = (vj.vj_fwd.launches, vj.vj_bwd.launches, vj.vj_jvp.launches)
    res = vn.refine_lm(**lm)
    counts = [a - b for a, b in zip((vj.vj_fwd.launches, vj.vj_bwd.launches,
                                     vj.vj_jvp.launches), before)]
    assert min(counts) >= 2 * 5, counts
    plain = VarNet(transient_ad_2d()["pde"], use_pallas=False, **kw).refine_lm(**lm)
    np.testing.assert_allclose([r["loss"] for r in res.losses],
                               [r["loss"] for r in plain.losses], rtol=2e-2)
