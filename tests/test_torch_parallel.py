"""The port's data-parallel layout (``varnet_tpu_torch/parallel/mesh.py``) against
the JAX package's ``varnet_tpu/parallel/mesh.py``, and the last single-device names.

Each rank's shard of the port equals, bit for bit, the addressable shard of the same
mesh position in JAX's ``shard_quad`` / ``shard_points`` / ``shard_flux`` /
``shard_hard`` on the conftest's host devices, for 2 and 3 shards, after the same
padding: ``pad_quad`` to the shard count, or, with ``batch_num`` 3, to the batch
count and then each batch's axis to the shard count (``_pad_batched_axis1``).  The
cases cover the shared [nQ] tables, per-node (order-2) tables, exact-BC tables and
Neumann flux rows.  Part two: ``VarNet(dtype=)``, ``evaluate(matmul_precision=)``,
``n_devices`` without a process group, the top-level exports and the host helpers
copied from the reference (bit-equal)."""

import jax
import numpy as np
import pytest
import torch

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.fem.hardbc import HardBC as JaxHardBC
from varnet_tpu.parallel import mesh as jmesh
from varnet_tpu.problems import analytic as jax_analytic
from varnet_tpu.train.trainer import _pad_batched_axis1, _tree_reshape_batches
from varnet_tpu_torch import VarNet
from varnet_tpu_torch.fem.assembly import build_fixed_data, pad_flux, pad_points, pad_quad
from varnet_tpu_torch.fem.hardbc import HardBC
from varnet_tpu_torch.parallel import mesh as pmesh
from varnet_tpu_torch.problems import analytic
from varnet_tpu_torch.train.trainer import pad_batched_axis1, reshape_batches
from _torch_threads import _one_intra_op_thread  # noqa: F401


# name -> (problem factory, build_fixed_data keywords)
CASES = {
    "transient": ("transient_ad_2d", dict(disc_num=5, b_disc_num=4, t_disc_num=4)),
    "order2": ("steady_ad_2d", dict(disc_num=5, b_disc_num=4, test_order=2)),
    "hard": ("transient_ad_1d", dict(disc_num=7, b_disc_num=4, t_disc_num=5)),
    "flux": ("steady_ad_2d_neumann", dict(disc_num=5, b_disc_num=5)),
}


def _jax_shard(arr, mesh, s):
    """The addressable shard of ``arr`` on mesh position ``s`` of the data axis."""
    dev = mesh.devices[s, 0]
    return np.asarray(next(sh.data for sh in arr.addressable_shards if sh.device == dev))


def _same(port_tree, jax_tree, mesh, s, what):
    for i, (a, b) in enumerate(zip(port_tree, jax_tree)):
        assert (a is None) == (b is None), (what, i)
        if a is None:
            continue
        b = _jax_shard(b, mesh, s)
        a = a.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, (what, i, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f"{what} field {i} shard {s}")


def _padded(quad, batch_num, n):
    """The host quad as the trainers pad it: (port's, JAX's)."""
    if batch_num == 1:
        return pad_quad(quad, n), pad_quad(quad, n)
    q = pad_quad(quad, batch_num)
    return (pad_batched_axis1(reshape_batches(q, batch_num), n),
            _pad_batched_axis1(_tree_reshape_batches(q, batch_num), n))


@pytest.mark.parametrize("batch_num", [1, 3])
@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_shards_equal_jax_addressable_shards(case, n, batch_num):
    name, kw = CASES[case]
    pde = getattr(analytic, name)()["pde"]
    fixed = build_fixed_data(pde, pad_multiple=1, **kw)
    assert fixed.quad.tables_per_node == (case == "order2")
    jm = jmesh.make_mesh(n)
    ours, theirs = _padded(fixed.quad, batch_num, n)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    batched = batch_num > 1
    jq = jmesh.shard_quad(theirs, jm, dtype=jax.numpy.float32, batched=batched)
    bc_h = pad_points(fixed.bc, n)
    jbc = jmesh.shard_points(bc_h, jm, dtype=jax.numpy.float32)
    neu_h = None if fixed.neu is None else pad_flux(fixed.neu, n)
    jneu = None if neu_h is None else jmesh.shard_flux(neu_h, jm, dtype=jax.numpy.float32)
    hard = None
    if case == "hard":
        flat = ours.coords.reshape((-1,) + ours.coords.shape[-2:])
        hq = HardBC(pde).tables(flat)
        ref = JaxHardBC(getattr(jax_analytic, name)()["pde"]).tables(flat)
        for a, b in zip(hq, ref):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a, b)
        hq = type(hq)(*(None if a is None else a.reshape(ours.coords.shape[:-2] + a.shape[1:])
                        for a in hq))
        obs_h = pad_points(fixed.bc, n)   # the BC points stand in for observation rows
        hard = (hq, HardBC(pde).points(obs_h.coords), None)
        jhard = jmesh.shard_hard(hard, jm, dtype=jax.numpy.float32, batched=batched)
    for s in range(n):
        pm = pmesh.Mesh(n, s, None, torch.device("cpu"))
        _same(pmesh.shard_quad(ours, pm, torch.float32, batched=batched), jq, jm, s, "quad")
        _same(pmesh.shard_points(bc_h, pm, torch.float32), jbc, jm, s, "bc")
        if jneu is not None:
            _same(pmesh.shard_flux(neu_h, pm, torch.float32), jneu, jm, s, "flux")
        if hard is not None:
            got = pmesh.shard_hard(hard, pm, torch.float32, batched=batched)
            for part, (g, j) in enumerate(zip(got, jhard)):
                if g is not None:
                    _same(g, j, jm, s, f"hard part {part}")


def test_shard_rows_refuses_an_axis_that_does_not_divide():
    with pytest.raises(ValueError, match="pad to a multiple"):
        pmesh.shard_rows(np.zeros((5, 2)), pmesh.Mesh(2, 0, None, torch.device("cpu")))


def test_no_group_is_one_shard_and_no_collective(monkeypatch):
    """Without a process group: ``initialize_distributed()`` is a no-op returning
    1, ``n_devices`` None or 1 gives one shard, another count raises naming both,
    and ``replicate`` / ``all_reduce_sum`` call no collective."""
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)
    assert not torch.distributed.is_initialized()
    assert pmesh.initialize_distributed() == 1
    calls = []
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(torch.distributed, "broadcast", lambda *a, **k: calls.append(a))
    pde = analytic.steady_ad_1d()["pde"]
    for n_dev in (None, 1):
        vn = VarNet(pde, layer_width=(6,), disc_num=6, device="cpu", n_devices=n_dev)
        assert vn.n_shards == 1 and not vn.mesh.distributed
    vn.train(epoch_num=2, save_freq=2, verbose=False, error_disc=8)
    with pytest.raises(ValueError, match="n_devices=2 does not match .* 1"):
        VarNet(pde, layer_width=(6,), disc_num=6, device="cpu", n_devices=2)
    t = torch.ones(3)
    assert pmesh.all_reduce_sum(t, vn.mesh) is t and calls == []


# ---------------------------------------------------------------------------- #
# VarNet(dtype=), evaluate(matmul_precision=), exports, host helpers


F64_MESH = dict(layer_width=(8, 8), disc_num=4, b_disc_num=4, t_disc_num=3)
F64_REPORT = dict(weight=(1.0, 10.0, 10.0), save_freq=1, verbose=False, error_disc=8,
                  error_times=2)
F64_CALLS = [("train", dict(epoch_num=10)), ("refine_lm", dict(steps=2, cg_iters=4)),
             ("refine_lbfgs", dict(steps=5))]


def _f64_losses(vn, call):
    method, kw = call
    return np.array([float(rec["loss"]) for rec in
                     getattr(vn, method)(**kw, **F64_REPORT).losses])


def _small(**kw):
    pde = analytic.transient_ad_2d()["pde"]
    return VarNet(pde, layer_width=(8, 8), disc_num=4, b_disc_num=4, t_disc_num=3,
                  device="cpu", **kw)


def test_dtype_routes_other_dtypes_to_the_plain_chain():
    """float32 keeps the fused residual and (on CUDA) the kernels; float64 takes the
    general path through the plain chain end to end (data, theta, Adam, LM, L-BFGS,
    evaluate), and lands near the f32 run of the same net."""
    v32 = _small()
    assert v32.dtype == torch.float32 and v32._fused_kind == "dir"
    v64 = _small(dtype=torch.float64)
    assert v64._fused_kind is None and not v64.use_pallas and not v64.use_fused_residual
    v64.theta = [{k: v.double() for k, v in layer.items()} for layer in v32.theta]
    assert all(v.dtype == torch.float64 for layer in v64.theta for v in layer.values())
    kw = dict(epoch_num=5, weight=(1.0, 10.0, 10.0), save_freq=5, verbose=False,
              error_disc=8, error_times=2)
    r32, r64 = v32.train(**kw), v64.train(**kw)
    assert all(v.dtype == torch.float64 for layer in v64.theta for v in layer.values())
    np.testing.assert_allclose(r64.losses[-1]["loss"], r32.losses[-1]["loss"], rtol=1e-4)
    lm = v64.refine_lm(steps=1, cg_iters=3, verbose=False, error_disc=8, error_times=2)
    assert np.isfinite(lm.losses[-1]["loss"])
    lb = v64.refine_lbfgs(steps=2, save_freq=2, verbose=False, error_disc=8, error_times=2)
    assert np.isfinite(lb.losses[-1]["loss"])
    x = np.array([[0.3, 0.4], [0.6, 0.1]])
    assert v64.evaluate(x, t=0.2).dtype == np.float64


def test_float64_follows_jax_x64():
    """``dtype=torch.float64`` against the JAX package's ``dtype=jnp.float64`` under
    ``jax.enable_x64``, from its theta: 10 Adam epochs, then 2 LM iterations, then 5
    L-BFGS iterations, each continuing the last, every recorded loss within rtol
    1e-10 (f64 agreement: they meet within 1e-13 here; Adam's f64 bias corrections
    follow optax's under x64)."""
    with jax.enable_x64(True):
        jv = JaxVarNet(jax_analytic.transient_ad_2d()["pde"], n_devices=1,
                       dtype=jax.numpy.float64, **F64_MESH)
        theta = jax.tree_util.tree_map(np.asarray, jv.theta)
        ref = [_f64_losses(jv, call) for call in F64_CALLS]
    vn = VarNet(analytic.transient_ad_2d()["pde"], device="cpu", dtype=torch.float64,
                **F64_MESH)
    vn.theta = vn._as_tensors(theta)
    assert all(v.dtype == torch.float64 for layer in vn.theta for v in layer.values())
    for call, want in zip(F64_CALLS, ref):
        got = _f64_losses(vn, call)
        assert got.shape == want.shape and np.all(np.isfinite(got))
        np.testing.assert_allclose(got, want, rtol=1e-10, err_msg=call[0])


@pytest.mark.parametrize("flag", ["use_pallas", "use_fused_residual"])
def test_kernel_flags_with_another_dtype_raise_naming_both(flag):
    with pytest.raises(ValueError, match=f"{flag}=True needs dtype=torch.float32.*float64"):
        _small(dtype=torch.float64, **{flag: True})
    assert getattr(_small(**{flag: True}), flag) is True


def test_evaluate_takes_matmul_precision():
    vn = _small()
    x = np.array([[0.2, 0.7], [0.5, 0.5]])
    u = vn.evaluate(x, t=0.1)
    np.testing.assert_array_equal(vn.evaluate(x, t=0.1, matmul_precision="highest"), u)
    np.testing.assert_array_equal(vn.evaluate(x, t=0.1, matmul_precision=None), u)
    with pytest.raises(NotImplementedError, match="not ported"):
        vn.evaluate(x, t=0.1, matmul_precision="bfloat16")


def test_top_level_exports_match_the_reference():
    import varnet_tpu
    import varnet_tpu_torch

    for name in ("BoxDomain3D", "BoxDomainND", "PolygonDomain2D", "PrismDomain3D", "FluxData"):
        assert name in varnet_tpu_torch.__all__ and name in varnet_tpu.__all__
        assert getattr(varnet_tpu_torch, name).__name__ == getattr(varnet_tpu, name).__name__
    assert set(varnet_tpu.__all__) <= set(varnet_tpu_torch.__all__)


HELPER_INPUTS = [None, [], (), np.zeros((0, 2)), np.arange(3.0), [1, 2], 0, "ab",
                 np.ones((2, 2))]


@pytest.mark.parametrize("name", ["is_none", "is_empty"])
def test_predicates_equal_the_reference(name):
    from varnet_tpu.utils import helpers as ref
    from varnet_tpu_torch.utils import helpers as ours

    assert [getattr(ours, name)(x) for x in HELPER_INPUTS] == [
        getattr(ref, name)(x) for x in HELPER_INPUTS]


@pytest.mark.parametrize("name", ["vstack", "hstack"])
def test_stacks_equal_the_reference(name):
    from varnet_tpu.utils import helpers as ref
    from varnet_tpu_torch.utils import helpers as ours

    rng = np.random.default_rng(0)
    cases = [[None, np.zeros((0, 3))], [rng.standard_normal(3), rng.standard_normal(3)],
             [[], rng.standard_normal((4, 3))]]
    cases.append([rng.standard_normal((2, 3)), None, rng.standard_normal((1, 3))]
                 if name == "vstack" else
                 [rng.standard_normal((2, 3)), None, rng.standard_normal((2, 1))])
    for arrays in cases:
        a, b = getattr(ours, name)(arrays), getattr(ref, name)(arrays)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_save_solution_csv_equals_the_reference(tmp_path):
    from varnet_tpu.utils.io import save_solution_csv as ref
    from varnet_tpu_torch.utils.io import save_solution_csv

    rng = np.random.default_rng(1)
    coords, u = rng.standard_normal((7, 3)), rng.standard_normal(7)
    for header in (None, "x,y,t,c"):
        save_solution_csv(str(tmp_path / "a" / "ours.csv"), coords, u, header)
        ref(str(tmp_path / "b" / "ref.csv"), coords, u, header)
        assert (tmp_path / "a" / "ours.csv").read_bytes() == (
            tmp_path / "b" / "ref.csv").read_bytes()


def test_param_count_equals_the_reference():
    from varnet_tpu.models.mlp import param_count as ref
    from varnet_tpu_torch.models.mlp import param_count

    vn = _small()
    numpy_net = [{k: v.numpy() for k, v in layer.items()} for layer in vn.theta]
    assert param_count(vn.theta) == ref(numpy_net) == 4 * 8 + 9 * 8 + 9
