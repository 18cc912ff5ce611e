"""The CUDA kernels (fused residual K1/K2, K2-FF, the precoeff residual K4 and
the jacobian-panel residual K3; value + jacobian K5/K6 and K7/K8) against their
plain PyTorch versions on the card.

These tests need an NVIDIA GPU and nvcc; without them they skip.  The CUDA
machine has no JAX, and tests/conftest.py imports it, so run them with
``python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py``.
"""

import json

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


def _check_fwd(params, xs_t, activation):
    """K5 forward (tensor cores, 3xTF32) against its plain version evaluated in f64,
    per output row: within 1e-5 of the row's max.  On a row where the f32 plain version
    is itself more than half of that from f64 (some deep sigmoid nets and the deepest
    n_in 1 tanh net: a cancellation of the row's terms that no f32 evaluation avoids),
    within 3x the f32 plain version's own distance instead."""
    before = vj.vj_fwd.launches
    out = vj.vj_fwd(params, xs_t, activation)
    torch.cuda.synchronize()
    assert vj.vj_fwd.launches == before + 1
    ref = vj.vj_fwd_plain(_f64(params), xs_t.double(), activation)
    plain = vj.vj_fwd_plain(params, xs_t, activation)
    for row, (a, b, c) in enumerate(zip(out, ref, plain)):
        own = _rel(c.double(), b)
        assert _rel(a.double(), b) < (1e-5 if own <= 5e-6 else 3 * own), (
            row, _rel(a.double(), b), own)


def _check_bwd_jvp(params, xs_t, g, tangent, activation):
    """K5 backward and K6 (tensor cores, 3xTF32) against their plain versions
    evaluated in f64: each gradient leaf and each output row within 1e-4 of its
    max.  (On a row that cancels -- a deep sigmoid net's value row can be ~1%
    of its terms -- the f32 plain version is itself up to 1e-4 from f64 as its
    summation order changes, so it is no yardstick there.)"""
    before = (vj.vj_bwd.launches, vj.vj_jvp.launches)
    grads = vj.vj_bwd(params, xs_t, activation, g)
    dout = vj.vj_jvp(params, xs_t, activation, tangent)
    torch.cuda.synchronize()
    assert (vj.vj_bwd.launches, vj.vj_jvp.launches) == (before[0] + 1, before[1] + 1)
    dref = vj.vj_jvp_plain(_f64(params), xs_t.double(), activation, _f64(tangent))
    assert max(_rel(a.double(), b) for a, b in zip(dout, dref)) < 1e-4
    for a, b in zip(grads, vj.vj_bwd_plain(_f64(params), xs_t.double(), activation, g.double())):
        for k in ("w", "b"):
            assert a[k].shape == b[k].shape
            assert _rel(a[k], b[k]) < 1e-4, (k, _rel(a[k], b[k]))


@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
@pytest.mark.parametrize("layers", [1, 2, 3, 4])
@pytest.mark.parametrize("n_in", [1, 2, 3, 4])
@pytest.mark.parametrize("hp", [8, 16, 24, 32, 40, 48, 56, 64])
def test_tensor_core_kernels_match_plain_at_every_width(cuda, hp, n_in, layers, activation):
    params, xs_t, g, tangent = _vj_case(n_in, (hp,) * layers, p=777, seed=hp + n_in + layers)
    _check_fwd(params, xs_t, activation)
    _check_bwd_jvp(params, xs_t, g, tangent, activation)
    # the K1/K4 forward: table mode with and without reaction, precoeff mode
    for mode in DIR_MODES:
        params, data, _ = _dir_synth(mode, n_in, (hp,) * layers, seed=hp + n_in + layers)
        _check_dir_fwd(mode, params, data, activation)


@pytest.mark.parametrize("p", [1, 15, 17, 63, 65, 1001])
@pytest.mark.parametrize("widths", [(48, 48, 48), (20, 20)])
def test_tensor_core_kernels_take_ragged_point_counts(cuda, widths, p):
    """P not a multiple of the tile, and P smaller than one tile."""
    params, xs_t, g, tangent = _vj_case(3, widths, p=p)
    _check_fwd(params, xs_t, "tanh")
    _check_bwd_jvp(params, xs_t, g, tangent, "tanh")


def test_tensor_core_kernels_take_no_points(cuda):
    params, xs_t, g, tangent = _vj_case(3, (48, 48, 48), p=0)
    out = vj.vj_fwd(params, xs_t, "tanh")
    grads = vj.vj_bwd(params, xs_t, "tanh", g)
    dout = vj.vj_jvp(params, xs_t, "tanh", tangent)
    torch.cuda.synchronize()
    assert out.shape == dout.shape == (4, 0)
    for a, b in zip(grads, params):
        for k in ("w", "b"):
            assert a[k].shape == b[k].shape and float(a[k].abs().max()) == 0.0


@pytest.mark.parametrize("widths", [(48, 48), (48, 48, 48)])
def test_tensor_core_kernels_at_the_lm_chunk_shape(cuda, widths):
    """One LM chunk of the d48/t32 mesh: 4,382,656 points / k_chunks 16."""
    params, xs_t, g, tangent = _vj_case(3, widths, p=273_916, seed=5)
    _check_fwd(params, xs_t, "tanh")
    _check_bwd_jvp(params, xs_t, g, tangent, "tanh")


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


@pytest.mark.parametrize("mode", ["dir", "unit", "pre", "jac"])
def test_ff_backwards_are_deterministic(cuda, mode):
    """Fixed-order sums, no atomics: every mode's gradient is bit-identical across
    calls, which CG needs (K2-FF and K7 at the contaminant's w96x3 behind 128
    features; wide K4 and K3 at w96x3)."""
    if mode in ("dir", "unit"):
        params, bt, gen = _ff_params(128, (96, 96, 96))
        data = _ff_data(cuda, bt)
        if mode == "dir":
            gr = torch.randn(data.k, generator=gen).to(cuda)
            run = lambda: fr.dir_residual_ff_bwd(params, data, "tanh", gr)         # noqa: E731
        else:
            g = torch.randn((4, data.xs.shape[1]), generator=gen).to(cuda)
            run = lambda: vj.ff_vj_bwd(params, data.xs, bt, "tanh", g)            # noqa: E731
    else:
        params, _, data, gr = _ff_sweep_case(mode, None, 96, 3, 64, seed=5)
        fn = fr.dirp_residual_ff_bwd if mode == "pre" else fr.jac_residual_bwd
        run = lambda: fn(params, data, "tanh", gr)                                # noqa: E731
    for a, b in zip(run(), run()):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


def test_ff_kernels_refuse_what_they_do_not_take(cuda):
    """An activation they do not have, a net wider than 256, and a 256-wide net too deep
    for the backward's stacked slots (ValueErrors naming them, before any launch)."""
    params, bt, _ = _ff_params(8, (16, 16))
    xs_t = torch.rand(3, 100, device=cuda)
    with pytest.raises(ValueError):
        vj.ff_vj_fwd(params, xs_t, bt, "sin")
    wide, wbt, _ = _ff_params(8, (257,))
    with pytest.raises(ValueError, match="hidden width 257"):
        vj.ff_vj_fwd(wide, xs_t, wbt, "tanh")
    deep, dbt, gen = _ff_params(8, (256,) * 6)
    g = torch.randn((4, 100), generator=gen).to(cuda)
    with pytest.raises(ValueError, match="hidden width 256 at depth 6"):
        vj.ff_vj_bwd(deep, xs_t, dbt, "tanh", g)
    assert torch.isfinite(vj.ff_vj_fwd(deep, xs_t, dbt, "tanh")).all()


@pytest.mark.parametrize("n_feat,hp", [(128, 96), (None, 256)], ids=["F128-w96x3", "F0-w251x3"])
def test_ff_jvp_is_deterministic(cuda, n_feat, hp):
    """K8 writes each point's tangent once, no atomics: bit-identical across calls."""
    params, bt, xs, _ = _ff_sweep_case("unit", n_feat, hp, 3, 64, seed=7)
    gen = torch.Generator().manual_seed(8)
    tangent = [{k: torch.randn(v.shape, generator=gen).to(cuda) for k, v in layer.items()}
               for layer in params]
    assert torch.equal(vj.ff_vj_jvp(params, xs, bt, "tanh", tangent),
                       vj.ff_vj_jvp(params, xs, bt, "tanh", tangent))


def test_net_wider_than_128_trains_and_refines_on_the_ff_kernels(cuda):
    """A plain net of width (192, 192) runs on csrc/ff_mlp.cu at HP 192 (warp groups of
    four): 20 Adam epochs through K2-FF's kernels without an embedding and 2 LM
    iterations through K7 / K8 take the plain path's steps (rtol 2e-4 / 2e-2)."""
    kw = dict(layer_width=(192, 192), disc_num=8, b_disc_num=6, t_disc_num=4, device=cuda)
    train = dict(epoch_num=20, weight=(1.0, 10.0, 10.0), save_freq=1, verbose=False,
                 error_disc=8, error_times=2)
    counters = (fr.dir_residual_ff_fwd, fr.dir_residual_ff_bwd)
    before = [c.launches for c in counters]
    vn = VarNet(transient_ad_2d()["pde"], **kw)
    theta = [{k: v.clone() for k, v in layer.items()} for layer in vn.theta]
    res = vn.train(**train)
    assert [c.launches - b for c, b in zip(counters, before)] == [20, 20]
    plain = VarNet(transient_ad_2d()["pde"], use_pallas=False, use_fused_residual=False, **kw)
    plain.theta = theta
    np.testing.assert_allclose([r["loss"] for r in res.losses],
                               [r["loss"] for r in plain.train(**train).losses], rtol=2e-4)
    lm = dict(steps=2, weight=(1.0, 10.0, 10.0), cg_iters=5, k_chunks=2, save_freq=1,
              verbose=False, error_disc=8, error_times=2)
    theta = [{k: v.clone() for k, v in layer.items()} for layer in vn.theta]
    before = (vj.ff_vj_fwd.launches, vj.ff_vj_bwd.launches, vj.ff_vj_jvp.launches)
    res = vn.refine_lm(**lm)
    counts = [a - b for a, b in zip((vj.ff_vj_fwd.launches, vj.ff_vj_bwd.launches,
                                     vj.ff_vj_jvp.launches), before)]
    assert min(counts) >= 2 * 5, counts
    plain.theta = theta
    np.testing.assert_allclose([r["loss"] for r in res.losses],
                               [r["loss"] for r in plain.refine_lm(**lm).losses], rtol=2e-2)


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


# ---------------------------------------------------------------------------
# K4, the precoeff residual (exact BC, per-node test tables), and K1 at n_in = 4

# name, factory name, assembly kwargs, time-dependent, reaction, hard
DIRP_CASES = [
    ("3dt-hard", "transient_ad_3d", dict(disc_num=3, b_disc_num=3, t_disc_num=2), True,
     False, True),                                             # n_in 4, nq 256
    ("3dt", "transient_ad_3d", dict(disc_num=3, b_disc_num=3, t_disc_num=2), True, False,
     False),
    ("2d-o2-hard", "steady_ad_2d", dict(disc_num=8, b_disc_num=4, test_order=2,
                                        integ_p_num=3), False, False, True),  # per node, nq 36
    ("2dt-o2", "transient_ad_2d", dict(disc_num=6, b_disc_num=4, t_disc_num=4,
                                       test_order=2), True, False, False),
    ("adr1d-hard", "steady_adr_1d", dict(disc_num=16), False, True, True),
    ("mor2d", "mor_steady_ad_2d", dict(disc_num=6, b_disc_num=4), False, False, False),
]


def _dirp_case(cuda, factory, kw, td, react, hard, widths, seed=0):
    from varnet_tpu_torch.fem.hardbc import HardBC
    from varnet_tpu_torch.problems import analytic

    pde = getattr(analytic, factory)()["pde"]
    fd = build_fixed_data(pde, **kw)
    st = fd.static
    scale, shift = make_input_scaling(st.input_lo, st.input_hi)
    hq = HardBC(pde).tables(fd.quad.coords) if hard else None
    data = fr.prepare_residual_coeffs(fd.quad, scale, shift, time_dependent=td,
                                      has_react=react, hard=hq, device=cuda)
    gen = torch.Generator().manual_seed(seed)
    params = init_mlp(gen, st.n_inputs, widths, device=cuda)
    for layer in params:
        layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=gen).to(cuda)
    return data, params, torch.randn(data.k, generator=gen).to(cuda)


@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
@pytest.mark.parametrize("widths", [(20, 20), (64, 64), (13, 48, 7), (32, 32, 32)])
@pytest.mark.parametrize("name,factory,kw,td,react,hard", DIRP_CASES,
                         ids=[c[0] for c in DIRP_CASES])
def test_dirp_kernel_matches_plain(cuda, name, factory, kw, td, react, hard, widths,
                                   activation):
    data, params, gr = _dirp_case(cuda, factory, kw, td, react, hard, widths)
    before = (fr.dirp_residual_fwd.launches, fr.dirp_residual_bwd.launches)
    r = fr.dirp_residual_fwd(params, data, activation)
    grads = fr.dirp_residual_bwd(params, data, activation, gr)
    torch.cuda.synchronize()
    assert (fr.dirp_residual_fwd.launches, fr.dirp_residual_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert _rel(r, fr.dir_residual_fwd_plain(params, data, activation)) < 1e-5
    for g, p in zip(grads, fr.dir_residual_bwd_plain(params, data, activation, gr)):
        for k in ("w", "b"):
            assert g[k].shape == p[k].shape
            if p[k].abs().max() > 0:
                assert _rel(g[k], p[k]) < 1e-4, (k, _rel(g[k], p[k]))


def test_dirp_backward_is_deterministic(cuda):
    data, params, gr = _dirp_case(cuda, *DIRP_CASES[0][1:], (64, 64), seed=1)
    g1 = fr.dirp_residual_bwd(params, data, "tanh", gr)
    g2 = fr.dirp_residual_bwd(params, data, "tanh", gr)
    for a, b in zip(g1, g2):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


# ---------------------------------------------------------------------------
# The K1/K4 forward and backward on the tensor cores (3xTF32 mma.sync; the backward's dW
# summed in registers or, for the deepest nets, a shared-memory partial): every padded
# width, input count, depth and activation, in table mode with and without reaction and
# in precoeff mode; any number of points per test function

DIR_MODES = ["table", "table-react", "precoeff"]


def _dir_synth(mode, n_in, widths, k=50, nq=9, seed=0, device="cuda"):
    """A seeded net, seeded residual data and a cotangent gr [k].  Table mode: d = n_in
    - 1 space dimensions and time (d = 1, steady, at n_in = 1), a random [nq, 2 + d]
    table and field rows, reaction on or off; precoeff mode: random directions, source
    and u coefficient."""
    gen = torch.Generator().manual_seed(seed)
    params = init_mlp(gen, n_in, widths, device=device)
    for layer in params:
        layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=gen).to(device)
    p = k * nq

    def rand(*shape):
        return torch.randn(*shape, generator=gen)

    xs = (2 * torch.rand((n_in, p), generator=gen) - 1).to(device)
    if mode == "precoeff":
        data = fr.CoeffData(xs=xs, cdir=(0.3 * rand(n_in, p)).to(device),
                            csrc=(0.1 * rand(p)).to(device), cu=rand(p).to(device), k=k, nq=nq)
    else:
        td, react = n_in > 1, mode == "table-react"
        d = n_in - 1 if td else 1
        flds = torch.cat([1.0 + torch.rand((1, p), generator=gen), rand(d + 1, p)]
                         + ([rand(1, p)] if react else []))
        tab = torch.cat([torch.rand((nq, 2), generator=gen), rand(nq, d)], dim=1)
        data = fr.ResidualData(xs=xs, flds=flds.to(device), tab=tab.to(device),
                               scale=(1.0 + torch.rand(n_in, generator=gen)).to(device), k=k,
                               nq=nq, d=d, td=td, has_react=react)
    return params, data, rand(k).to(device)


def _dir_f64(data):
    if isinstance(data, fr.CoeffData):
        return data._replace(xs=data.xs.double(), cdir=data.cdir.double(),
                             csrc=data.csrc.double(), cu=data.cu.double())
    return _f64_data(data)


def _check_dir_bwd(mode, params, data, gr, activation):
    """The K1 (table mode) or K4 (precoeff mode) backward against its plain version
    evaluated in f64: each gradient leaf within 1e-4 of its max.  On a leaf where the
    f32 plain version is itself more than half of that from f64 (a sum that cancels,
    such as a seeded reaction case's output bias sum_p gr cu), within 3x the f32 plain
    version's own distance."""
    fn = fr.dirp_residual_bwd if mode == "precoeff" else fr.dir_residual_bwd
    before = fn.launches
    grads = fn(params, data, activation, gr)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    ref = fr.dir_residual_bwd_plain(_f64(params), _dir_f64(data), activation, gr.double())
    plain = fr.dir_residual_bwd_plain(params, data, activation, gr)
    for g, p, q in zip(grads, ref, plain):
        for k in ("w", "b"):
            assert g[k].shape == p[k].shape
            if p[k].abs().max() > 0:
                own = _rel(q[k].double(), p[k])
                err = _rel(g[k].double(), p[k])
                assert err < (1e-4 if own <= 5e-5 else 3 * own), (k, err, own)


def _check_dir_fwd(mode, params, data, activation):
    """The K1 (table mode) or K4 (precoeff mode) forward against its plain version
    evaluated in f64: r within 1e-5 of max |r|, or within 3x the f32 plain version's own
    distance from f64 where that exceeds half the gate (a q-sum that cancels).
    Returns r."""
    fn = fr.dirp_residual_fwd if mode == "precoeff" else fr.dir_residual_fwd
    before = fn.launches
    r = fn(params, data, activation)
    torch.cuda.synchronize()
    assert fn.launches == before + 1 and r.shape == (data.k,)
    ref = fr.dir_residual_fwd_plain(_f64(params), _dir_f64(data), activation)
    own = _rel(fr.dir_residual_fwd_plain(params, data, activation).double(), ref)
    err = _rel(r.double(), ref)
    assert err < (1e-5 if own <= 5e-6 else 3 * own), (err, own)
    return r


@pytest.mark.parametrize("k", [0, 1, 7])
@pytest.mark.parametrize("nq", [1, 3, 16, 62, 64, 216, 257, 1296])
@pytest.mark.parametrize("mode", DIR_MODES)
def test_dir_forward_takes_any_point_count_per_test_function(cuda, mode, nq, k):
    """The repair of the forward's nq limit (it refused nq > 1024, and fewer points at
    the wider nets): any nq, including nq above and not a multiple of the 16-point
    group or the 32-lane sum; forward and backward against the plain versions in f64."""
    params, data, gr = _dir_synth(mode, 3, (48, 48), k=k, nq=nq, seed=nq + k)
    if k:
        _check_dir_fwd(mode, params, data, "tanh")
        _check_dir_bwd(mode, params, data, gr, "tanh")
        return
    fn = fr.dirp_residual_fwd if mode == "precoeff" else fr.dir_residual_fwd
    r = fn(params, data, "tanh")
    torch.cuda.synchronize()
    assert r.shape == (0,)


@pytest.mark.parametrize("mode", DIR_MODES)
def test_dir_forward_is_deterministic(cuda, mode):
    """r is bit-identical across calls: fixed-order sums, no atomics."""
    params, data, _ = _dir_synth(mode, 4, (64, 64), k=37, nq=1296, seed=3)
    fn = fr.dirp_residual_fwd if mode == "precoeff" else fr.dir_residual_fwd
    assert torch.equal(fn(params, data, "sigmoid"), fn(params, data, "sigmoid"))


@pytest.mark.parametrize("kind", ["penalty", "hard-order2"])
def test_training_at_1296_points_per_test_function(cuda, kind):
    """``transient_ad_3d`` with integ_p_num 3 (nq 1296), which raised in the forward of
    the first Adam step: order 1 with penalty BCs through K1, order 2 with exact BC
    through K4; the launch counters rise every epoch and the losses follow the plain
    path's."""
    from varnet_tpu_torch.problems.analytic import transient_ad_3d

    hard = kind != "penalty"
    kw = dict(layer_width=(16, 16), disc_num=3, b_disc_num=3, t_disc_num=3, integ_p_num=3,
              device=cuda, hard_bc=hard, test_order=2 if hard else 1)
    train = dict(epoch_num=3, save_freq=1, verbose=False, error_disc=8, error_times=2)
    vns = [VarNet(transient_ad_3d()["pde"], **kw),
           VarNet(transient_ad_3d()["pde"], use_pallas=False, use_fused_residual=False, **kw)]
    assert vns[0].static.n_quad_per_test == 1296
    fwd, bwd = ((fr.dirp_residual_fwd, fr.dirp_residual_bwd) if hard
                else (fr.dir_residual_fwd, fr.dir_residual_bwd))
    before = (fwd.launches, bwd.launches)
    res = vns[0].train(**train)
    assert (fwd.launches - before[0], bwd.launches - before[1]) == (3, 3)
    np.testing.assert_allclose([r["loss"] for r in res.losses],
                               [r["loss"] for r in vns[1].train(**train).losses], rtol=2e-4)


@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
@pytest.mark.parametrize("layers", [1, 2, 3, 4])
@pytest.mark.parametrize("n_in", [1, 2, 3, 4])
@pytest.mark.parametrize("hp", [8, 16, 24, 32, 40, 48, 56, 64])
@pytest.mark.parametrize("mode", DIR_MODES)
def test_dir_backward_matches_plain_at_every_width(cuda, mode, hp, n_in, layers, activation):
    params, data, gr = _dir_synth(mode, n_in, (hp,) * layers, seed=hp + n_in + layers)
    _check_dir_bwd(mode, params, data, gr, activation)


@pytest.mark.parametrize("k", [0, 1, 3, 7, 111])
@pytest.mark.parametrize("widths", [(20, 20), (48, 48, 48), (64, 64), (64,) * 6])
@pytest.mark.parametrize("mode", DIR_MODES)
def test_dir_backward_takes_ragged_and_empty_point_counts(cuda, mode, widths, k):
    """P = k nq (nq 9): none, less than one tile, not a multiple of the tile; (64,) * 6
    has more dW row blocks than 2 per warp, so it sums dW in the shared partial."""
    params, data, gr = _dir_synth(mode, 3, widths, k=k)
    if k:
        _check_dir_bwd(mode, params, data, gr, "tanh")
        return
    fwd, bwd = ((fr.dirp_residual_fwd, fr.dirp_residual_bwd) if mode == "precoeff"
                else (fr.dir_residual_fwd, fr.dir_residual_bwd))
    r = fwd(params, data, "tanh")
    grads = bwd(params, data, "tanh", gr)
    torch.cuda.synchronize()
    assert r.shape == (0,)
    for a, b in zip(grads, params):
        for key in ("w", "b"):
            assert a[key].shape == b[key].shape and float(a[key].abs().max()) == 0.0


def test_dirp_refuses_nets_wider_than_64(cuda):
    """dir_residual.cu's precoeff mode takes widths <= 64; the routing sends a
    wider net to ff_mlp.cu's (``_residual_fns``)."""
    data, params, _ = _dirp_case(cuda, *DIRP_CASES[0][1:], (72, 72))
    with pytest.raises(ValueError, match="dirp_residual_ff_fwd"):
        fr.dirp_residual_fwd(params, data, "tanh")
    assert fr._residual_fns(params, data) == (fr.dirp_residual_ff_fwd, fr.dirp_residual_ff_bwd)


@pytest.mark.parametrize("widths", [(20, 20), (64, 64)])
def test_k1_takes_four_inputs(cuda, widths):
    """The repair of the n_in <= 3 limit: K1/K2 on the 3-D transient penalty
    problem (n_in 4, nq 256) against their plain version."""
    from varnet_tpu_torch.problems.analytic import transient_ad_3d

    fd = build_fixed_data(transient_ad_3d()["pde"], 3, b_disc_num=3, t_disc_num=2)
    scale, shift = make_input_scaling(fd.static.input_lo, fd.static.input_hi)
    data = fr.prepare_residual_data(fd.quad, scale, shift, time_dependent=True,
                                    has_react=False, device=cuda)
    assert data.xs.shape[0] == 4 and data.nq == 256
    gen = torch.Generator().manual_seed(2)
    params = init_mlp(gen, 4, widths, device=cuda)
    gr = torch.randn(data.k, generator=gen).to(cuda)
    r = fr.dir_residual_fwd(params, data, "tanh")
    grads = fr.dir_residual_bwd(params, data, "tanh", gr)
    assert _rel(r, fr.dir_residual_fwd_plain(params, data, "tanh")) < 1e-5
    for g, p in zip(grads, fr.dir_residual_bwd_plain(params, data, "tanh", gr)):
        for k in ("w", "b"):
            if p[k].abs().max() > 0:
                assert _rel(g[k], p[k]) < 1e-4


@pytest.mark.parametrize("kind", ["hard", "order2", "refined"])
def test_training_on_cuda_goes_through_k4(cuda, kind):
    """VarNet(hard_bc=True), VarNet(test_order=2) and a refined test space train
    through K4 (its launch counters rise every epoch) and take the plain path's
    steps; the hard LM runs on K5 / K6."""
    from varnet_tpu_torch.problems.analytic import steady_ad_2d

    kw = dict(layer_width=(16, 16), disc_num=8, b_disc_num=6, device=cuda,
              hard_bc=kind == "hard", test_order=2 if kind == "order2" else 1)
    train = dict(epoch_num=4, weight=(1.0, 10.0), save_freq=1, verbose=False, error_disc=8)
    vns = [VarNet(steady_ad_2d()["pde"], **kw),
           VarNet(steady_ad_2d()["pde"], use_pallas=False, use_fused_residual=False, **kw)]
    if kind == "refined":
        for v in vns:
            v.refine_tests(frac=0.3, verbose=False)
    before = (fr.dirp_residual_fwd.launches, fr.dirp_residual_bwd.launches)
    res = vns[0].train(**train)
    assert fr.dirp_residual_fwd.launches - before[0] == 4
    assert fr.dirp_residual_bwd.launches - before[1] == 4
    np.testing.assert_allclose([r["loss"] for r in res.losses],
                               [r["loss"] for r in vns[1].train(**train).losses], rtol=2e-4)
    if kind == "hard":
        before = vj.vj_jvp.launches
        vns[0].refine_lm(steps=1, cg_iters=3, k_chunks=2, verbose=False, error_disc=8)
        assert vj.vj_jvp.launches - before >= 3


# ---------------------------------------------------------------------------
# K4 for nets wider than 64 (ff_mlp.cu, precoeff mode)


@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
@pytest.mark.parametrize("widths", [(65, 65), (72, 72), (96, 96, 96), (128, 128), (20, 100)])
@pytest.mark.parametrize("name,factory,kw,td,react,hard", DIRP_CASES,
                         ids=[c[0] for c in DIRP_CASES])
def test_dirp_wide_kernel_matches_plain(cuda, name, factory, kw, td, react, hard, widths,
                                        activation):
    data, params, gr = _dirp_case(cuda, factory, kw, td, react, hard, widths)
    fwd, bwd = fr._residual_fns(params, data)
    assert (fwd, bwd) == (fr.dirp_residual_ff_fwd, fr.dirp_residual_ff_bwd)
    before = (fwd.launches, bwd.launches)
    r = fwd(params, data, activation)
    grads = bwd(params, data, activation, gr)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    assert _rel(r, fr.dir_residual_fwd_plain(params, data, activation)) < 1e-5
    for g, p in zip(grads, fr.dir_residual_bwd_plain(params, data, activation, gr)):
        for k in ("w", "b"):
            assert g[k].shape == p[k].shape
            if p[k].abs().max() > 0:
                assert _rel(g[k], p[k]) < 1e-4, (k, _rel(g[k], p[k]))


def test_wide_hard_training_goes_through_k4_on_ff_mlp(cuda):
    """A hard-BC net of width 72 trains on the card through ff_mlp.cu's
    precoeff mode, every epoch, and takes the plain path's steps."""
    from varnet_tpu_torch.problems.analytic import steady_ad_2d

    kw = dict(layer_width=(72, 72), disc_num=6, b_disc_num=4, device=cuda, hard_bc=True)
    train = dict(epoch_num=4, save_freq=1, verbose=False, error_disc=8)
    before = (fr.dirp_residual_ff_fwd.launches, fr.dirp_residual_ff_bwd.launches)
    res = VarNet(steady_ad_2d()["pde"], **kw).train(**train)
    assert fr.dirp_residual_ff_fwd.launches - before[0] == 4
    assert fr.dirp_residual_ff_bwd.launches - before[1] == 4
    plain = VarNet(steady_ad_2d()["pde"], use_pallas=False, use_fused_residual=False,
                   **kw).train(**train)
    np.testing.assert_allclose([r["loss"] for r in res.losses],
                               [r["loss"] for r in plain.losses], rtol=2e-4)


# ---------------------------------------------------------------------------
# K3, the jacobian-panel residual (ff_mlp.cu, jacobian mode): viscous Burgers


def _burgers_react():
    import dataclasses

    from varnet_tpu_torch.problems.analytic import burgers_1d_steady

    return {"pde": dataclasses.replace(burgers_1d_steady()["pde"], react=1.5)}


def _f64(params):
    return [{k: v.double() for k, v in layer.items()} for layer in params]


def _f64_data(data):
    return data._replace(xs=data.xs.double(), flds=data.flds.double(), tab=data.tab.double(),
                         scale=data.scale.double(),
                         nl=None if data.nl is None else data.nl.double())


def _jac_case(cuda, factory, kw, td, react, widths, seed=0):
    from varnet_tpu_torch.problems import analytic

    pde = (factory if callable(factory) else getattr(analytic, factory))()["pde"]
    fd = build_fixed_data(pde, **kw)
    st = fd.static
    scale, shift = make_input_scaling(st.input_lo, st.input_hi)
    data = fr.prepare_residual_data(fd.quad, scale, shift, time_dependent=td, has_react=react,
                                    device=cuda, nl_vec=pde.nl_adv, jacobian=True)
    gen = torch.Generator().manual_seed(seed)
    params = init_mlp(gen, st.n_inputs, widths, device=cuda)
    for layer in params:
        layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=gen).to(cuda)
    return data, params, torch.randn(data.k, generator=gen).to(cuda)


# name, factory, assembly kwargs, time-dependent, reaction
JAC_CASES = [
    ("steady1d", "burgers_1d_steady", dict(disc_num=16), False, False),          # n_in 1
    ("transient1d", "burgers_1d_transient", dict(disc_num=12, t_disc_num=6), True, False),
    ("front2d", "burgers_2d_front", dict(disc_num=6, b_disc_num=4, t_disc_num=4), True,
     False),                                                                   # n_in 3, b 2-D
    ("react-nl", _burgers_react, dict(disc_num=16), False, True),
    ("adr1d", "steady_adr_1d", dict(disc_num=16), False, True),                # nl off
    ("3dt", "transient_ad_3d", dict(disc_num=3, b_disc_num=3, t_disc_num=2), True, False),
    ("mor2d", "mor_steady_ad_2d", dict(disc_num=6, b_disc_num=4), False, False),
]


@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
@pytest.mark.parametrize("widths", [(8, 8), (32, 32, 32), (13, 48, 7), (96, 96), (128, 128)])
@pytest.mark.parametrize("name,factory,kw,td,react", JAC_CASES, ids=[c[0] for c in JAC_CASES])
def test_jac_kernel_matches_plain(cuda, name, factory, kw, td, react, widths, activation):
    data, params, gr = _jac_case(cuda, factory, kw, td, react, widths)
    assert fr._residual_fns(params, data) == (fr.jac_residual_fwd, fr.jac_residual_bwd)
    before = (fr.jac_residual_fwd.launches, fr.jac_residual_bwd.launches)
    r = fr.jac_residual_fwd(params, data, activation)
    grads = fr.jac_residual_bwd(params, data, activation, gr)
    torch.cuda.synchronize()
    assert (fr.jac_residual_fwd.launches, fr.jac_residual_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    # r against an f64 evaluation of the plain version: on the tiny 1-D meshes r
    # cancels its terms, and the f32 plain version itself is up to 1.2e-5 of
    # max |r| from f64 (steady1d, w96x2); the kernel may round as much, within 3x
    r64 = fr.jac_residual_fwd_plain(_f64(params), _f64_data(data), activation)
    plain_err = _rel(fr.jac_residual_fwd_plain(params, data, activation).double(), r64)
    assert _rel(r.double(), r64) < max(1e-5, 3 * plain_err), (_rel(r.double(), r64), plain_err)
    for g, p in zip(grads, fr.jac_residual_bwd_plain(params, data, activation, gr)):
        for k in ("w", "b"):
            assert g[k].shape == p[k].shape
            if p[k].abs().max() > 0:
                assert _rel(g[k], p[k]) < 1e-4, (k, _rel(g[k], p[k]))


def test_jac_backward_is_deterministic(cuda):
    data, params, gr = _jac_case(cuda, *JAC_CASES[2][1:], (32, 32, 32), seed=1)
    g1 = fr.jac_residual_bwd(params, data, "tanh", gr)
    g2 = fr.jac_residual_bwd(params, data, "tanh", gr)
    for a, b in zip(g1, g2):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


@pytest.mark.parametrize("hard", [False, True], ids=["penalty", "hard"])
def test_burgers_training_on_cuda_goes_through_k3(cuda, hard):
    """Penalty Burgers trains through K3 and nothing else for its interior
    residual; exact BC with the nonlinear term takes the general path through K5,
    as in the JAX package.  Both take the plain path's steps; LM runs on K5/K6."""
    from varnet_tpu_torch.problems.analytic import burgers_1d_transient

    kw = dict(layer_width=(16, 16), disc_num=12, t_disc_num=6, device=cuda, hard_bc=hard)
    train = dict(epoch_num=4, weight=(1.0, 10.0, 10.0), save_freq=1, verbose=False,
                 error_disc=16, error_times=2)
    counters = (fr.jac_residual_fwd, fr.jac_residual_bwd, fr.dir_residual_fwd,
                fr.dirp_residual_fwd, vj.vj_fwd, vj.vj_bwd)
    before = [c.launches for c in counters]
    vn = VarNet(burgers_1d_transient()["pde"], **kw)
    assert vn._fused_kind == (None if hard else "jac")
    res = vn.train(**train)
    grown = [c.launches - b for c, b in zip(counters, before)]
    if hard:
        assert grown[:4] == [0, 0, 0, 0] and min(grown[4:]) >= 4
    else:
        assert grown == [4, 4, 0, 0, 0, 0]
    plain = VarNet(burgers_1d_transient()["pde"], use_pallas=False, use_fused_residual=False,
                   **kw).train(**train)
    np.testing.assert_allclose([r["loss"] for r in res.losses],
                               [r["loss"] for r in plain.losses], rtol=2e-4)
    before = vj.vj_jvp.launches
    vn.refine_lm(steps=1, weight=(1.0, 10.0, 10.0), cg_iters=3, k_chunks=2, verbose=False,
                 error_disc=16, error_times=2)
    assert vj.vj_jvp.launches - before >= 3


# ---------------------------------------------------------------------------
# ff_mlp.cu's stacked kernels on the tensor cores (3xTF32 mma.sync): every mode (K2-FF,
# K7, wide K4, K3), every padded hidden width, depths 1 and 3, without an embedding and
# with 8 or 128 features, against the plain versions evaluated in f64

FF_SWEEP_MODES = [("dir", None), ("dir", 8), ("dir", 128), ("unit", None), ("unit", 8),
                  ("unit", 128), ("pre", None), ("jac", None)]
FF_SWEEP_HP = [32, 64, 96, 128, 160, 192, 224, 256]
FF_SWEEP_NQ = {1: 1001, 64: 23, 1296: 3}   # nq -> k: P = 1001 and 3888 are no multiple
                                           # of any tile (16 .. 64 points); 64 nq always is


def _ff_sweep_case(mode, n_feat, hp, depth, nq, seed, device="cuda"):
    """A seeded net (hidden width hp: the padded width itself, or hp - 5 from 128 up),
    its data for ``mode`` (n_in 3 and d 2 with time; K3 with the Burgers direction b and
    reaction) and the cotangent: gr [k] of a residual, or g [4, P] of K7."""
    gen = torch.Generator().manual_seed(seed)
    k = FF_SWEEP_NQ[nq]
    p, n_in, d = k * nq, 3, 2

    def rand(*shape):
        return torch.randn(*shape, generator=gen)

    width = hp if hp < 128 else hp - 5
    params = init_mlp(gen, n_in if n_feat is None else 2 * n_feat, (width,) * depth,
                      device=device)
    for layer in params:
        layer["b"] = 0.1 * torch.randn(layer["b"].shape, generator=gen).to(device)
    bt = None
    if n_feat is not None:
        b_mat = torch.cat([0.5 * rand(n_in, n_feat - n_feat // 2), 2.0 * rand(n_in, n_feat // 2)],
                          dim=1)
        bt = ((2 * np.pi) * b_mat.T).contiguous().to(device)
    # raw coordinates in [0, 2] as the contaminant's unscaled inputs, or scaled ones
    xs = (torch.rand((n_in, p), generator=gen) * (2.0 if bt is not None else 1.0)
          - (0.0 if bt is not None else 0.5)).to(device)
    if mode == "unit":
        return params, bt, xs, rand(1 + n_in, p).to(device)
    if mode == "pre":
        data = fr.CoeffData(xs=xs, cdir=(0.3 * rand(n_in, p)).to(device),
                            csrc=(0.1 * rand(p)).to(device), cu=rand(p).to(device), k=k, nq=nq)
        return params, bt, data, rand(k).to(device)
    react = mode == "jac"
    flds = torch.cat([1.0 + torch.rand((1, p), generator=gen), rand(d + 1, p)]
                     + ([rand(1, p)] if react else []))
    tab = torch.cat([torch.rand((nq, 2), generator=gen), rand(nq, d)], dim=1)
    data = fr.ResidualData(xs=xs, flds=flds.to(device), tab=tab.to(device),
                           scale=(1.0 + torch.rand(n_in, generator=gen)).to(device), k=k,
                           nq=nq, d=d, td=True, has_react=react, bt=bt,
                           nl=torch.tensor([1.0, -0.5], device=device) if react else None,
                           jac=react)
    return params, bt, data, rand(k).to(device)


def _gate(err, own, gate):
    """Within the gate of the f64 value, or within 3x the f32 plain version's own
    distance from it where that exceeds half the gate (a sum that cancels)."""
    return err < (gate if own <= gate / 2 else 3 * own)


@pytest.mark.parametrize("nq", sorted(FF_SWEEP_NQ))
@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("hp", FF_SWEEP_HP)
@pytest.mark.parametrize("mode,n_feat", FF_SWEEP_MODES,
                         ids=[f"{m}-F{f or 0}" for m, f in FF_SWEEP_MODES])
def test_ff_tensor_core_kernels_match_plain(cuda, mode, n_feat, hp, depth, activation, nq,
                                            request):
    """Forward and backward of each mode against the plain version in f64: K2-FF r 5e-5
    with an embedding (angles of tens of radians), wide K4 / K3 r 1e-5 (and K2-FF without
    an embedding), K7 rows and every gradient leaf 1e-4.  Every comparison (output row or
    leaf, error against f64, the f32 plain version's, gate) is kept as the user property
    ``gates`` (``--junitxml`` writes it; ``scripts/gate_report.py`` counts the fallbacks)."""
    params, bt, data, g = _ff_sweep_case(mode, n_feat, hp, depth, nq, seed=hp + depth + nq)
    p64 = _f64(params)
    bt64 = None if bt is None else bt.double()
    if mode == "unit":
        fwd = lambda: vj.ff_vj_fwd(params, data, bt, activation)                     # noqa: E731
        bwd = lambda: vj.ff_vj_bwd(params, data, bt, activation, g)                  # noqa: E731
        plain_f = lambda p, x, b: vj.ff_vj_fwd_plain(p, x, b, activation)            # noqa: E731
        plain_b = lambda p, x, b, gg: vj.ff_vj_bwd_plain(p, x, b, activation, gg)    # noqa: E731
        args32, args64 = (data, bt), (data.double(), bt64)
        counters, r_gate = (vj.ff_vj_fwd, vj.ff_vj_bwd), 1e-4
    else:
        fns = {"dir": (fr.dir_residual_ff_fwd, fr.dir_residual_ff_bwd),
               "pre": (fr.dirp_residual_ff_fwd, fr.dirp_residual_ff_bwd),
               "jac": (fr.jac_residual_fwd, fr.jac_residual_bwd)}[mode]
        if mode == "jac" or (mode == "pre" and hp > 64):
            assert fr._residual_fns(params, data) == fns
        fwd = lambda: fns[0](params, data, activation)                               # noqa: E731
        bwd = lambda: fns[1](params, data, activation, g)                            # noqa: E731
        pf, pb = ((fr.jac_residual_fwd_plain, fr.jac_residual_bwd_plain) if mode == "jac"
                  else (fr.dir_residual_fwd_plain, fr.dir_residual_bwd_plain))
        plain_f = lambda p, dd, _b: pf(p, dd, activation)                            # noqa: E731
        plain_b = lambda p, dd, _b, gg: pb(p, dd, activation, gg)                    # noqa: E731
        d64 = (_dir_f64(data) if mode == "pre"
               else _f64_data(data)._replace(bt=bt64))
        args32, args64 = (data, bt), (d64, bt64)
        counters, r_gate = fns, (5e-5 if bt is not None else 1e-5)
    before = [c.launches for c in counters]
    out = fwd()
    grads = bwd()
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1]
    ref = plain_f(p64, *args64)
    own = plain_f(params, *args32)
    rows = list(out) if mode == "unit" else [out]
    refs = list(ref) if mode == "unit" else [ref]
    owns = list(own) if mode == "unit" else [own]
    checks = [(f"r{i}", _rel(a.double(), b), _rel(c.double(), b), r_gate)
              for i, (a, b, c) in enumerate(zip(rows, refs, owns))]
    g64 = g.double()
    for li, (got, gr64, gr32) in enumerate(zip(grads, plain_b(p64, *args64, g64),
                                               plain_b(params, *args32, g))):
        for key in ("w", "b"):
            assert got[key].shape == gr64[key].shape
            if gr64[key].abs().max() > 0:
                checks.append((f"{key}{li}", _rel(got[key].double(), gr64[key]),
                               _rel(gr32[key].double(), gr64[key]), 1e-4))
    request.node.user_properties.append(("gates", json.dumps(checks)))
    for what, err, own, gate in checks:
        assert _gate(err, own, gate), (what, err, own)



@pytest.mark.parametrize("nq", sorted(FF_SWEEP_NQ))
@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("hp", FF_SWEEP_HP)
@pytest.mark.parametrize("n_feat", [None, 8, 128], ids=["F0", "F8", "F128"])
def test_ff_jvp_kernel_matches_plain(cuda, n_feat, hp, depth, activation, nq, request):
    """K8 (the tensor-core ff_jvp_kernel) against its plain version in f64 at every padded
    width, feature count, depth and activation, on the sweep's point counts (P = 1001,
    1472, 3888: no multiple of any tile), a seeded tangent of every leaf: each output row
    within 1e-4 (or 3x the f32 plain version's own distance, as the sweep above), kept as
    the ``gates`` property."""
    params, bt, xs, _ = _ff_sweep_case("unit", n_feat, hp, depth, nq, seed=hp + depth + nq)
    gen = torch.Generator().manual_seed(hp + nq)
    tangent = [{k: torch.randn(v.shape, generator=gen).to(cuda) for k, v in layer.items()}
               for layer in params]
    before = vj.ff_vj_jvp.launches
    dout = vj.ff_vj_jvp(params, xs, bt, activation, tangent)
    torch.cuda.synchronize()
    assert vj.ff_vj_jvp.launches - before == 1
    ref = vj.ff_vj_jvp_plain(_f64(params), xs.double(), None if bt is None else bt.double(),
                             activation, _f64(tangent))
    own = vj.ff_vj_jvp_plain(params, xs, bt, activation, tangent)
    checks = [(f"r{i}", _rel(a.double(), b), _rel(c.double(), b), 1e-4)
              for i, (a, b, c) in enumerate(zip(dout, ref, own))]
    request.node.user_properties.append(("gates", json.dumps(checks)))
    for what, err, own_err, gate in checks:
        assert _gate(err, own_err, gate), (what, err, own_err)


# ---------------------------------------------------------------------------
# checkpoints and fault recovery on the card

RESUME_MESH = dict(layer_width=(20, 20), disc_num=8, b_disc_num=6, t_disc_num=4)
RESUME_TRAIN = dict(weight=(1.0, 10.0, 10.0), save_freq=10, verbose=False, error_disc=8,
                    error_times=2)
RESUME_LM = dict(weight=(1.0, 10.0, 10.0), cg_iters=5, k_chunks=2, save_freq=1,
                 verbose=False, error_disc=8, error_times=2)


def _resume_vn(cuda, **kw):
    from varnet_tpu_torch.train.optim import OptimizerConfig

    return VarNet(transient_ad_2d()["pde"], device=cuda, seed=3,
                  optimizer=OptimizerConfig(lr=2e-3, decay_rate=0.5, decay_steps=7),
                  **{**RESUME_MESH, **kw})


def _max_dtheta(a, b):
    return max(float((x[k] - y[k]).abs().max()) for x, y in zip(a, b) for k in ("w", "b"))


def test_adam_resume_through_k1_is_exact(cuda, tmp_path):
    """20 epochs through K1/K2, then a fresh VarNet resumed to 40, equal the
    uninterrupted 40 epochs bit for bit (no kernel of the path sums atomically)."""
    full = _resume_vn(cuda)
    full.train(epoch_num=40, folderpath=str(tmp_path / "full"), **RESUME_TRAIN)
    _resume_vn(cuda).train(epoch_num=20, folderpath=str(tmp_path / "cut"), **RESUME_TRAIN)
    before = fr.dir_residual_fwd.launches
    resumed = _resume_vn(cuda)
    res = resumed.train(epoch_num=40, folderpath=str(tmp_path / "cut"), resume=True,
                        **RESUME_TRAIN)
    assert fr.dir_residual_fwd.launches - before >= 20
    assert res.epochs == [30, 40]
    assert resumed.theta[0]["w"].device.type == "cuda"
    assert _max_dtheta(resumed.theta, full.theta) == 0.0


def test_lm_resume_through_k5_k6_is_exact(cuda, tmp_path):
    start = _resume_vn(cuda)
    start.train(epoch_num=20, **RESUME_TRAIN)
    theta = start.theta
    full = _resume_vn(cuda)
    full.theta = theta
    full.refine_lm(steps=2, folderpath=str(tmp_path / "full"), **RESUME_LM)
    cut = _resume_vn(cuda)
    cut.theta = theta
    cut.refine_lm(steps=1, folderpath=str(tmp_path / "cut"), **RESUME_LM)
    before = (vj.vj_bwd.launches, vj.vj_jvp.launches)
    resumed = _resume_vn(cuda)
    res = resumed.refine_lm(steps=2, folderpath=str(tmp_path / "cut"), resume=True,
                            **RESUME_LM)
    assert vj.vj_bwd.launches > before[0] and vj.vj_jvp.launches > before[1]
    assert res.epochs == [2]
    assert _max_dtheta(resumed.theta, full.theta) == 0.0
    from varnet_tpu_torch.train.checkpoint import load_meta

    assert load_meta(str(tmp_path / "cut" / "lm"), 2) == load_meta(
        str(tmp_path / "full" / "lm"), 2)


def test_lm_retries_a_real_oom_with_k_chunks_doubled(cuda, tmp_path, monkeypatch):
    """After the first LM checkpoint the first attempt asks the allocator for
    twice the card's memory: a genuine ``torch.cuda.OutOfMemoryError``.
    ``refine_lm(max_retries=1)`` resumes from ``lm/`` with k_chunks doubled and
    lands within the LM band of the uninterrupted run."""
    start = _resume_vn(cuda)
    start.train(epoch_num=20, **RESUME_TRAIN)
    ref = _resume_vn(cuda)
    ref.theta = start.theta
    r_ref = ref.refine_lm(steps=3, **RESUME_LM)

    real_impl, real_save = VarNet._refine_lm_impl, VarNet._save
    seen = {"k": [], "oom": 0}

    def impl(self, steps, *args):
        seen["k"].append(args[8])
        return real_impl(self, steps, *args)

    def save(self, folderpath, step, theta, meta, optimizer=None):
        real_save(self, folderpath, step, theta, meta, optimizer)
        if not seen["oom"]:
            seen["oom"] += 1
            total = torch.cuda.get_device_properties(cuda).total_memory
            torch.empty(2 * total, dtype=torch.uint8, device=cuda)

    monkeypatch.setattr(VarNet, "_refine_lm_impl", impl)
    monkeypatch.setattr(VarNet, "_save", save)
    vn = _resume_vn(cuda)
    vn.theta = start.theta
    res = vn.refine_lm(steps=3, folderpath=str(tmp_path), max_retries=1, retry_backoff=0.0,
                       **RESUME_LM)
    assert seen["k"] == [2, 4] and seen["oom"] == 1
    assert res.epochs == [2, 3]
    np.testing.assert_allclose(res.losses[-1]["loss"], r_ref.losses[-1]["loss"], rtol=2e-2)
