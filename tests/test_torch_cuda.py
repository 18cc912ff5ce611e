"""The CUDA kernels (fused residual K1/K2 and K2-FF; value + jacobian K5/K6 and
K7/K8) against their plain PyTorch versions on the card.

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


# ---------------------------------------------------------------------------
# Fourier-feature kernels (K2-FF, K7 forward / backward, K8) against their plain versions

FF_WIDTHS = [((16, 16), 8), ((96, 96, 96), 128), ((13, 70, 7), 20), ((128,), 16)]


def _ff_params(n_feat, widths, seed=0, device="cuda"):
    gen = torch.Generator().manual_seed(seed)
    params = init_mlp(gen, 2 * n_feat, widths, device=device)
    for layer in params:
        layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=gen).to(device)
    b_mat = torch.cat([0.5 * torch.randn(3, n_feat - n_feat // 2, generator=gen),
                       2.0 * torch.randn(3, n_feat // 2, generator=gen)], dim=1)
    return params, ((2 * np.pi) * b_mat.T).contiguous().to(device), gen


def _ff_data(cuda, bt, scaled=False):
    from varnet_tpu_torch.problems.analytic import contaminant_transport_2d

    fd = build_fixed_data(contaminant_transport_2d()["pde"], 8, b_disc_num=4, t_disc_num=4)
    scale, shift = (make_input_scaling(fd.static.input_lo, fd.static.input_hi) if scaled
                    else (None, None))
    return fr.prepare_residual_data(fd.quad, scale, shift, time_dependent=True,
                                    has_react=False, device=cuda, fourier_bt=bt)


@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
@pytest.mark.parametrize("widths,n_feat", FF_WIDTHS)
def test_ff_residual_kernel_matches_plain(cuda, widths, n_feat, activation):
    """K2-FF: r within 1e-5 of the plain version relative to max |r| (angles up
    to tens of radians round differently in the two sums), gradients 1e-4."""
    params, bt, gen = _ff_params(n_feat, widths)
    data = _ff_data(cuda, bt)
    gr = torch.randn(data.k, generator=gen).to(cuda)
    before = (fr.dir_residual_ff_fwd.launches, fr.dir_residual_ff_bwd.launches)
    r = fr.dir_residual_ff_fwd(params, data, activation)
    grads = fr.dir_residual_ff_bwd(params, data, activation, gr)
    torch.cuda.synchronize()
    assert (fr.dir_residual_ff_fwd.launches, fr.dir_residual_ff_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert _rel(r, fr.dir_residual_fwd_plain(params, data, activation)) < 1e-5
    for g, p in zip(grads, fr.dir_residual_bwd_plain(params, data, activation, gr)):
        for k in ("w", "b"):
            assert g[k].shape == p[k].shape
            assert _rel(g[k], p[k]) < 1e-4, (k, _rel(g[k], p[k]))


@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
@pytest.mark.parametrize("widths,n_feat", FF_WIDTHS)
@pytest.mark.parametrize("n_in", [1, 3, 4])
def test_ff_value_and_jac_kernels_match_plain(cuda, n_in, widths, n_feat, activation):
    params, bt, gen = _ff_params(n_feat, widths)
    bt = torch.cat([bt, bt[:, :1]], dim=1)[:, :n_in].contiguous()
    xs_t = torch.rand((n_in, 1000), generator=gen).to(cuda)
    g = torch.randn((1 + n_in, 1000), generator=gen).to(cuda)
    tangent = [{k: torch.randn(v.shape, generator=gen).to(cuda) for k, v in layer.items()}
               for layer in params]
    before = (vj.ff_vj_fwd.launches, vj.ff_vj_bwd.launches, vj.ff_vj_jvp.launches)
    out = vj.ff_vj_fwd(params, xs_t, bt, activation)
    grads = vj.ff_vj_bwd(params, xs_t, bt, activation, g)
    dout = vj.ff_vj_jvp(params, xs_t, bt, activation, tangent)
    torch.cuda.synchronize()
    assert (vj.ff_vj_fwd.launches, vj.ff_vj_bwd.launches, vj.ff_vj_jvp.launches) == tuple(
        b + 1 for b in before)
    ref = vj.ff_vj_fwd_plain(params, xs_t, bt, activation)
    assert max(_rel(a, b) for a, b in zip(out, ref)) < 1e-5
    dref = vj.ff_vj_jvp_plain(params, xs_t, bt, activation, tangent)
    assert max(_rel(a, b) for a, b in zip(dout, dref)) < 1e-4
    for a, b in zip(grads, vj.ff_vj_bwd_plain(params, xs_t, bt, activation, g)):
        for k in ("w", "b"):
            assert _rel(a[k], b[k]) < 1e-4, (k, _rel(a[k], b[k]))


def test_ff_backwards_are_deterministic(cuda):
    params, bt, gen = _ff_params(128, (96, 96, 96))
    data = _ff_data(cuda, bt)
    gr = torch.randn(data.k, generator=gen).to(cuda)
    g1 = fr.dir_residual_ff_bwd(params, data, "tanh", gr)
    g2 = fr.dir_residual_ff_bwd(params, data, "tanh", gr)
    g = torch.randn((4, data.xs.shape[1]), generator=gen).to(cuda)
    v1 = vj.ff_vj_bwd(params, data.xs, bt, "tanh", g)
    v2 = vj.ff_vj_bwd(params, data.xs, bt, "tanh", g)
    for a, b in list(zip(g1, g2)) + list(zip(v1, v2)):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


def test_ff_kernels_refuse_what_they_do_not_take(cuda):
    params, bt, _ = _ff_params(8, (16, 16))
    xs_t = torch.rand(3, 100, device=cuda)
    with pytest.raises(ValueError):
        vj.ff_vj_fwd(params, xs_t, bt, "sin")
    wide, wbt, _ = _ff_params(8, (130,))
    with pytest.raises(ValueError, match="hidden width"):
        vj.ff_vj_fwd(wide, xs_t, wbt, "tanh")


@pytest.mark.parametrize("ff", [False, True], ids=["mlp", "ff"])
def test_general_path_on_cuda_goes_through_the_value_and_jac_kernels(cuda, ff):
    """use_fused_residual=False with use_pallas: every Adam epoch launches the
    value+jac forward and backward (K5, or K7 for a Fourier-feature net)."""
    kw = dict(fourier_features=8, input_scaling=False) if ff else {}
    vn = VarNet(transient_ad_2d()["pde"], layer_width=(20, 20), disc_num=8, b_disc_num=6,
                t_disc_num=4, device=cuda, use_fused_residual=False, **kw)
    fwd, bwd = (vj.ff_vj_fwd, vj.ff_vj_bwd) if ff else (vj.vj_fwd, vj.vj_bwd)
    before = (fwd.launches, bwd.launches)
    res = vn.train(epoch_num=4, weight=(1.0, 10.0, 10.0), save_freq=4, verbose=False,
                   error_disc=8, error_times=2)
    assert fwd.launches - before[0] >= 4 and bwd.launches - before[1] == 4
    assert np.isfinite(res.losses[-1]["loss"])


def test_ff_training_and_lm_on_cuda_go_through_the_ff_kernels(cuda):
    kw = dict(layer_width=(32, 32), disc_num=8, b_disc_num=6, t_disc_num=4, device=cuda,
              fourier_features=16, fourier_scale="0.5,2.0", input_scaling=False)
    vn = VarNet(transient_ad_2d()["pde"], **kw)
    before = (fr.dir_residual_ff_fwd.launches, fr.dir_residual_ff_bwd.launches)
    vn.train(epoch_num=3, weight=(1.0, 10.0, 10.0), save_freq=3, verbose=False,
             error_disc=8, error_times=2)
    assert (fr.dir_residual_ff_fwd.launches - before[0],
            fr.dir_residual_ff_bwd.launches - before[1]) == (3, 3)
    theta = vn.theta
    lm = dict(steps=2, weight=(1.0, 10.0, 10.0), cg_iters=5, k_chunks=2, save_freq=1,
              verbose=False, error_disc=8, error_times=2)
    before = (vj.ff_vj_fwd.launches, vj.ff_vj_bwd.launches, vj.ff_vj_jvp.launches)
    res = vn.refine_lm(**lm)
    counts = [a - b for a, b in zip((vj.ff_vj_fwd.launches, vj.ff_vj_bwd.launches,
                                     vj.ff_vj_jvp.launches), before)]
    assert min(counts) >= 2 * 5, counts
    kw = {k: v for k, v in kw.items() if k not in ("fourier_features", "fourier_scale")}
    plain = VarNet(transient_ad_2d()["pde"], use_pallas=False, fourier_b=vn.fourier_b.cpu(), **kw)
    plain.theta = theta
    np.testing.assert_allclose([r["loss"] for r in res.losses],
                               [r["loss"] for r in plain.refine_lm(**lm).losses], rtol=2e-2)


@pytest.mark.parametrize("widths", [(72, 72), (128,), (13, 100, 7)])
@pytest.mark.parametrize("n_in", [1, 3, 4])
def test_no_embedding_kernels_match_plain(cuda, n_in, widths):
    """csrc/ff_mlp.cu without an embedding (bt None) runs a plain net wider than
    K5 / K6 take: K7 forward / backward and K8 against K5 / K6's plain versions."""
    params, xs_t, g, tangent = _vj_case(n_in, widths)
    before = (vj.ff_vj_fwd.launches, vj.ff_vj_bwd.launches, vj.ff_vj_jvp.launches)
    out = vj.ff_vj_fwd(params, xs_t, None, "tanh")
    grads = vj.ff_vj_bwd(params, xs_t, None, "tanh", g)
    dout = vj.ff_vj_jvp(params, xs_t, None, "tanh", tangent)
    torch.cuda.synchronize()
    assert (vj.ff_vj_fwd.launches, vj.ff_vj_bwd.launches, vj.ff_vj_jvp.launches) == tuple(
        b + 1 for b in before)
    assert max(_rel(a, b) for a, b in zip(out, vj.vj_fwd_plain(params, xs_t, "tanh"))) < 1e-5
    dref = vj.vj_jvp_plain(params, xs_t, "tanh", tangent)
    assert max(_rel(a, b) for a, b in zip(dout, dref)) < 1e-4
    for a, b in zip(grads, vj.vj_bwd_plain(params, xs_t, "tanh", g)):
        for k in ("w", "b"):
            assert _rel(a[k], b[k]) < 1e-4, (k, _rel(a[k], b[k]))


@pytest.mark.parametrize("widths", [(72, 72), (128,)])
@pytest.mark.parametrize("name,factory,kw,td,react", CASES, ids=[c[0] for c in CASES])
def test_no_embedding_residual_kernel_matches_plain(cuda, name, factory, kw, td, react, widths):
    """A plain net wider than K1/K2 take goes through K2-FF's kernels without an
    embedding: r and gradients against K1/K2's plain version."""
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
    before = (fr.dir_residual_ff_fwd.launches, fr.dir_residual_ff_bwd.launches)
    leaves = [layer[k].clone().requires_grad_(True) for layer in params for k in ("w", "b")]
    r = fr.DirResidualFn.apply(data, "tanh", *leaves)
    grads = torch.autograd.grad(r, leaves, gr)
    torch.cuda.synchronize()
    assert (fr.dir_residual_ff_fwd.launches, fr.dir_residual_ff_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert _rel(r.detach(), fr.dir_residual_fwd_plain(params, data, "tanh")) < 1e-5
    ref = [p[k] for p in fr.dir_residual_bwd_plain(params, data, "tanh", gr) for k in ("w", "b")]
    for a, b in zip(grads, ref):
        if b.abs().max() > 0:
            assert _rel(a, b) < 1e-4


@pytest.mark.parametrize("fused", [False, True], ids=["general", "fused"])
def test_wide_plain_net_runs_on_the_ff_kernels(cuda, fused):
    """A plain net wider than 64 trains on the card through csrc/ff_mlp.cu without
    an embedding (K7 on the general path, K2-FF's kernels on the fused one) and
    takes the plain path's steps; LM runs on K7 / K8."""
    kw = dict(layer_width=(72, 72), disc_num=8, b_disc_num=6, t_disc_num=4, device=cuda)
    train = dict(epoch_num=4, weight=(1.0, 10.0, 10.0), save_freq=1, verbose=False,
                 error_disc=8, error_times=2)
    counters = ((fr.dir_residual_ff_fwd, fr.dir_residual_ff_bwd) if fused
                else (vj.ff_vj_fwd, vj.ff_vj_bwd))
    before = [c.launches for c in counters]
    res = VarNet(transient_ad_2d()["pde"], use_fused_residual=fused, **kw).train(**train)
    assert min(c.launches - b for c, b in zip(counters, before)) >= 4
    plain = VarNet(transient_ad_2d()["pde"], use_pallas=False, use_fused_residual=False,
                   **kw).train(**train)
    np.testing.assert_allclose([r["loss"] for r in res.losses],
                               [r["loss"] for r in plain.losses], rtol=2e-4)
    if fused:
        return
    lm = dict(steps=1, weight=(1.0, 10.0, 10.0), cg_iters=3, k_chunks=2, save_freq=1,
              verbose=False, error_disc=8, error_times=2)
    before = vj.ff_vj_jvp.launches
    VarNet(transient_ad_2d()["pde"], **kw).refine_lm(**lm)
    assert vj.ff_vj_jvp.launches - before >= 3
