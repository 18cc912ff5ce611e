"""The fused-residual CUDA kernel against its plain PyTorch version on the card.

These tests need an NVIDIA GPU and nvcc; without them they skip.  The CUDA
machine has no JAX, and tests/conftest.py imports it, so run them with
``python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from varnet_tpu_torch import VarNet
from varnet_tpu_torch.fem.assembly import build_fixed_data
from varnet_tpu_torch.models.mlp import init_mlp, make_input_scaling
from varnet_tpu_torch.ops import fused_residual as fr
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
