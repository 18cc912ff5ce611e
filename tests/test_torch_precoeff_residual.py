"""K4, the port's precomputed-coefficient residual (``prepare_residual_coeffs``
and ``dir_residual_*_plain`` on its CoeffData, in
varnet_tpu_torch.ops.fused_residual), on the CPU against the JAX package's ``prepare_residual_coeffs`` and
``pallas_fused_residual(..., precoeff=True)`` in interpret mode: penalty and
exact-BC (hard) data, order-1 and order-2 (per-node) test tables, reaction, a
MOR input with its zero direction row.

Tolerances: the coefficients are bit-equal (the same f32 casts and formulas);
r at rtol 1e-5 relative to max|r| and gradients at rtol 1e-4 of each leaf's max
(the tolerances of ``test_torch_fused_residual.py``), because the f32 sums run
in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from varnet_tpu.fem.assembly import build_fixed_data
from varnet_tpu.fem.hardbc import HardBC
from varnet_tpu.models.mlp import make_input_scaling
from varnet_tpu.ops.pallas_residual import pallas_fused_residual
from varnet_tpu.ops.pallas_residual import prepare_residual_coeffs as jax_prepare_coeffs
from varnet_tpu.problems.analytic import (
    mor_steady_ad_2d,
    steady_ad_2d,
    steady_adr_1d,
    transient_ad_1d,
    transient_ad_2d,
    transient_ad_3d,
)
from varnet_tpu_torch.models.mlp import params_from_jax
from varnet_tpu_torch.ops import fused_residual as fr
from _torch_threads import _one_intra_op_thread  # noqa: F401


# name, factory, assembly kwargs, time-dependent, reaction, hard, widths
CASES = [
    ("2dt", transient_ad_2d, dict(disc_num=6, b_disc_num=4, t_disc_num=3), True, False,
     False, (12, 12)),
    ("2dt-hard", transient_ad_2d, dict(disc_num=6, b_disc_num=4, t_disc_num=3), True, False,
     True, (12, 12)),
    ("2d-hard", steady_ad_2d, dict(disc_num=8, b_disc_num=4), False, False, True, (10, 10)),
    ("2dt-o2", transient_ad_2d, dict(disc_num=6, b_disc_num=4, t_disc_num=4, test_order=2),
     True, False, False, (10, 10)),
    ("2d-o2-hard", steady_ad_2d, dict(disc_num=6, b_disc_num=4, test_order=2,
                                      integ_p_num=3), False, False, True, (10, 10)),
    ("adr1d", steady_adr_1d, dict(disc_num=16), False, True, False, (8, 8, 8)),
    ("adr1d-hard", steady_adr_1d, dict(disc_num=16), False, True, True, (8, 8, 8)),
    ("1dt-hard", transient_ad_1d, dict(disc_num=12, t_disc_num=4), True, False, True,
     (8, 8)),
    ("3dt-hard", transient_ad_3d, dict(disc_num=3, b_disc_num=3, t_disc_num=2), True, False,
     True, (8, 8)),
    ("mor2d", mor_steady_ad_2d, dict(disc_num=6, b_disc_num=4), False, False, False, (10,)),
]
IDS = [c[0] for c in CASES]


def _setup(factory, kw, hard, widths, seed=0, siren=False):
    """Fixed data, exact-BC tables, a seeded net, a cotangent and the input scaling;
    ``siren``: the net drawn from SIREN's bounds at omega0 6 (``init_siren``)."""
    pde = factory()["pde"]
    fd = build_fixed_data(pde, **kw)
    st = fd.static
    hq = HardBC(pde).tables(np.asarray(fd.quad.coords)) if hard else None
    rng = np.random.default_rng(seed)
    sizes = (st.n_inputs,) + widths + (1,)
    raw = [{"w": (rng.standard_normal((a, b)) * np.sqrt(2.0 / (a + b))).astype(np.float32),
            "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
           for a, b in zip(sizes[:-1], sizes[1:])]
    if siren:
        bounds = [6.0 / a if i == 0 else np.sqrt(6.0 / a) for i, a in enumerate(sizes[:-1])]
        for layer, bound in zip(raw, bounds):
            layer["w"] = rng.uniform(-bound, bound, layer["w"].shape).astype(np.float32)
    cw = rng.standard_normal(fd.quad.coords.shape[0]).astype(np.float32)
    scale, shift = (np.asarray(a) for a in make_input_scaling(st.input_lo, st.input_hi))
    return fd, st, hq, raw, cw, scale, shift


def _port_data(fd, st, hq, td, react, scale, shift):
    return fr.prepare_residual_coeffs(fd.quad, scale, shift, time_dependent=td,
                                      has_react=react, hard=hq)


@pytest.mark.parametrize("name,factory,kw,td,react,hard,widths", CASES, ids=IDS)
def test_coefficients_bit_equal_to_jax(name, factory, kw, td, react, hard, widths):
    fd, st, hq, _, _, scale, shift = _setup(factory, kw, hard, widths)
    data = _port_data(fd, st, hq, td, react, scale, shift)
    k, nq = data.k, data.nq
    ref = jax_prepare_coeffs(fd.quad, scale, shift, time_dependent=td, has_react=react,
                             G=1, tile=k, hard=hq)

    def k_major(a):  # the G = 1 layout [rows, nq * K] (q-major) -> [rows, K * nq]
        a = np.asarray(a)
        return a.reshape(a.shape[0], nq, k).transpose(0, 2, 1).reshape(a.shape[0], k * nq)

    assert (data.cu is None) == (len(ref) == 3)
    ours = [data.xs, data.cdir, data.csrc[None], *([] if data.cu is None else [data.cu[None]])]
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), k_major(b))
    if st.n_mor:
        assert not data.cdir[st.n_space:].any()  # the MOR rows' zero direction


def _port(fd, st, hq, raw, cw, td, react, scale, shift, activation="tanh"):
    """Port r and the gradients of sum(r * cw) through DirResidualFn (K4's plain
    version on the CPU)."""
    data = _port_data(fd, st, hq, td, react, scale, shift)
    params = params_from_jax(raw)
    leaves = [layer[k] for layer in params for k in ("w", "b")]
    for v in leaves:
        v.requires_grad_(True)
    r = fr.fused_residual(params, data, activation)
    grads = torch.autograd.grad((r * torch.from_numpy(cw)).sum(), leaves, allow_unused=True)
    return r.detach().numpy(), [np.zeros(tuple(v.shape), np.float32) if g is None
                                else g.numpy() for v, g in zip(leaves, grads)]


def _jax(fd, hq, raw, cw, td, react, scale, shift, activation="tanh"):
    quad = jax.tree_util.tree_map(jnp.asarray, fd.quad)
    hq_d = None if hq is None else jax.tree_util.tree_map(jnp.asarray, hq)
    k = quad.coords.shape[0]

    def loss(p):
        r = pallas_fused_residual(p, quad, activation, jnp.asarray(scale), jnp.asarray(shift),
                                  time_dependent=td, has_react=react, tile=k,
                                  interpret=True, q_block=1, precoeff=True, hard=hq_d)
        return jnp.sum(r * cw), r

    (_, r), g = jax.value_and_grad(loss, has_aux=True)(
        [{k2: jnp.asarray(v) for k2, v in layer.items()} for layer in raw])
    return np.asarray(r), [np.asarray(layer[k2]) for layer in g for k2 in ("w", "b")]


@pytest.mark.parametrize("name,factory,kw,td,react,hard,widths", CASES, ids=IDS)
def test_plain_version_matches_jax_kernel(name, factory, kw, td, react, hard, widths):
    fd, st, hq, raw, cw, scale, shift = _setup(factory, kw, hard, widths)
    r, grads = _port(fd, st, hq, raw, cw, td, react, scale, shift)
    r_ref, g_ref = _jax(fd, hq, raw, cw, td, react, scale, shift)
    np.testing.assert_allclose(r, r_ref, rtol=1e-5, atol=1e-5 * np.abs(r_ref).max())
    for g, gr in zip(grads, g_ref):
        np.testing.assert_allclose(g, gr, rtol=1e-4, atol=1e-4 * np.abs(gr).max())


@pytest.mark.parametrize("name,factory,kw,td,react,hard,widths", CASES, ids=IDS)
def test_sin_matches_jax_kernel(name, factory, kw, td, react, hard, widths):
    """A SIREN net (sin, omega0 6) through K4's plain version against the JAX
    kernel, at the tolerances above."""
    fd, st, hq, raw, cw, scale, shift = _setup(factory, kw, hard, widths, seed=3, siren=True)
    r, grads = _port(fd, st, hq, raw, cw, td, react, scale, shift, "sin")
    r_ref, g_ref = _jax(fd, hq, raw, cw, td, react, scale, shift, "sin")
    np.testing.assert_allclose(r, r_ref, rtol=1e-5, atol=1e-5 * np.abs(r_ref).max())
    for g, gr in zip(grads, g_ref):
        np.testing.assert_allclose(g, gr, rtol=1e-4, atol=1e-4 * np.abs(gr).max())


@pytest.mark.parametrize("case", [c for c in CASES if c[0] in ("2dt-hard", "2d-o2-hard")],
                         ids=["2dt-hard", "2d-o2-hard"])
def test_sin_wide_matches_jax_kernel(case):
    """A SIREN net of hidden width 72, which the card runs on csrc/ff_mlp.cu's precoeff
    mode (wide K4), through K4's plain version against the JAX kernel with sin, at the
    tolerances above."""
    _, factory, kw, td, react, hard, _ = case
    fd, st, hq, raw, cw, scale, shift = _setup(factory, kw, hard, (72, 72), seed=4, siren=True)
    r, grads = _port(fd, st, hq, raw, cw, td, react, scale, shift, "sin")
    r_ref, g_ref = _jax(fd, hq, raw, cw, td, react, scale, shift, "sin")
    np.testing.assert_allclose(r, r_ref, rtol=1e-5, atol=1e-5 * np.abs(r_ref).max())
    for g, gr in zip(grads, g_ref):
        np.testing.assert_allclose(g, gr, rtol=1e-4, atol=1e-4 * np.abs(gr).max())


def test_width_256_matches_jax_kernel():
    """At the widest hidden width csrc/ff_mlp.cu takes in precoeff mode (HP 256, warp
    groups of four on the card): exact BC on the order-2 2-D space, tolerances as above."""
    _, factory, kw, td, react, hard, _ = CASES[IDS.index("2d-o2-hard")]
    fd, st, hq, raw, cw, scale, shift = _setup(factory, kw, hard, (256,), seed=2)
    r, grads = _port(fd, st, hq, raw, cw, td, react, scale, shift)
    r_ref, g_ref = _jax(fd, hq, raw, cw, td, react, scale, shift)
    np.testing.assert_allclose(r, r_ref, rtol=1e-5, atol=1e-5 * np.abs(r_ref).max())
    for g, gr in zip(grads, g_ref):
        np.testing.assert_allclose(g, gr, rtol=1e-4, atol=1e-4 * np.abs(gr).max())


@pytest.mark.parametrize("activation", ["tanh", "sigmoid", "sin"])
@pytest.mark.parametrize("case", [c for c in CASES if c[0] in ("2dt-hard", "2d-o2-hard",
                                                                "adr1d-hard")],
                         ids=["2dt-hard", "2d-o2-hard", "adr1d-hard"])
def test_closed_form_backward_matches_autograd(case, activation):
    """K4's plain closed-form backward (the kernel's algorithm) against
    torch.autograd through its plain forward."""
    _, factory, kw, td, react, hard, widths = case
    fd, st, hq, raw, cw, scale, shift = _setup(factory, kw, hard, widths, seed=1)
    data = _port_data(fd, st, hq, td, react, scale, shift)
    params = params_from_jax(raw)
    leaves = [layer[k] for layer in params for k in ("w", "b")]
    for v in leaves:
        v.requires_grad_(True)
    gr = torch.from_numpy(cw)
    r = fr.dir_residual_fwd_plain(params, data, activation)
    auto = torch.autograd.grad((r * gr).sum(), leaves)
    closed = fr.dir_residual_bwd_plain(params, data, activation, gr)
    for a, c in zip(auto, [g[k] for g in closed for k in ("w", "b")]):
        np.testing.assert_allclose(c.detach().numpy(), a.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(a.abs().max()))


def test_cpu_dispatch_takes_plain_version_and_counts_nothing():
    fd, st, hq, raw, cw, scale, shift = _setup(*CASES[1][1:3], True, (12, 12))
    data = _port_data(fd, st, hq, True, False, scale, shift)
    params = params_from_jax(raw)
    before = (fr.dirp_residual_fwd.launches, fr.dirp_residual_bwd.launches)
    r = fr.dirp_residual_fwd(params, data)
    np.testing.assert_array_equal(r.numpy(), fr.dir_residual_fwd_plain(params, data).numpy())
    fr.dirp_residual_bwd(params, data, "tanh", torch.from_numpy(cw))
    assert (fr.dirp_residual_fwd.launches, fr.dirp_residual_bwd.launches) == before


def test_kernel_refuses_what_it_does_not_take():
    """The argument checks of K4's wrappers (run before any launch on CUDA)."""
    fd, st, hq, raw, _, scale, shift = _setup(*CASES[1][1:3], True, (12, 12))
    data = _port_data(fd, st, hq, True, False, scale, shift)
    with pytest.raises(ValueError, match="dirp_residual_ff_fwd"):
        fr._check_dirp_args(params_from_jax(_setup(*CASES[1][1:3], True, (72, 8))[3]), data,
                            "tanh")
    # sin runs on K4 up to width 64, and above, where the card takes csrc/ff_mlp.cu's
    # precoeff mode (a relu is refused on both)
    fr._check_dirp_args(params_from_jax(raw), data, "sin")
    wide = params_from_jax(_setup(*CASES[1][1:3], True, (72, 8))[3])
    fr._check_dirp_ff_args(wide, data, "sin")
    torch.testing.assert_close(fr.dirp_residual_fwd(wide, data, "sin"),
                               fr.dir_residual_fwd_plain(wide, data, "sin"), rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown activation"):
        fr._check_dirp_ff_args(wide, data, "relu")
    fr._check_dirp_args(params_from_jax(raw), data, "tanh")
    with pytest.raises(ValueError, match="contiguous"):
        fr._check_dirp_args(params_from_jax(raw), data._replace(csrc=data.csrc[:-1]), "tanh")


def test_fused_precoeff_runs_k4_on_shared_tables():
    """``VarNet(fused_precoeff=True)`` routes a shared-table net through K4 (its
    plain version here), taking the steps the table kernels' plain version takes."""
    from varnet_tpu_torch import VarNet
    from varnet_tpu_torch.problems.analytic import transient_ad_2d as torch_transient_ad_2d

    kw = dict(layer_width=(10, 10), disc_num=6, b_disc_num=4, t_disc_num=3, device="cpu")
    train = dict(epoch_num=5, weight=(1.0, 10.0, 10.0), save_freq=1, verbose=False,
                 error_disc=6, error_times=2)
    pre = VarNet(torch_transient_ad_2d()["pde"], fused_precoeff=True, **kw)
    table = VarNet(torch_transient_ad_2d()["pde"], **kw)
    assert (pre._fused_kind, table._fused_kind) == ("precoeff", "dir")
    np.testing.assert_allclose([r["loss"] for r in pre.train(**train).losses],
                               [r["loss"] for r in table.train(**train).losses], rtol=2e-5)
