"""The benchmark's exact-BC 3-D transient configuration (``portbench/configs/
hard3dt_w64x2.json``) and the flagship configuration's LM, on the CPU:

* the plain reference's form ``transient_box3d_hard`` (written from the
  definitions, importing nothing of the port) against ``VarNet(hard_bc=True)``
  on ``transient_ad_3d`` at a small mesh, from seeded weights: the loss, every
  gradient leaf and three Adam steps, on K4's plain version and on the general
  path;
* the reference's ansatz tables (A, dA, At, B, dB, Bt; autograd in f64)
  against ``fem/hardbc.py``'s (central differences in f64) at the program's
  quadrature points, within the differences' error;
* ``shapes()`` at the recipe's mesh (K 30,375, P 7,776,000) and against the
  program's own mesh at small sizes;
* the flagship LM's J^T r and J^T (J b) against the reference at a tiny size;
* the new per-layer reader ``k4_roofline`` on synthetic events, and K4's bytes
  per point against the rows of the program's ``CoeffData``;
* the ``adam_timed`` driver's window sizing against a program whose per-call
  preparation varies.
"""

import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_threads import _one_intra_op_thread  # noqa: F401
from portbench import compare, harness, roofline, trace
from portbench.reference import problems as ref_problems
from portbench.reference.forms import transient_box3d_hard as hard_form
from varnet_tpu_torch.fem.assembly import build_fixed_data, pad_quad
from varnet_tpu_torch.fem.hardbc import HardBC
from varnet_tpu_torch.ops.fused_residual import prepare_residual_coeffs
from varnet_tpu_torch.problems.analytic import transient_ad_3d

ROOT = Path(__file__).resolve().parents[1]
SEED = 2 ** 31 + 77
RTOL = 1e-5
KW = harness.load_cell("hard3dt-adam").config["problem_kwargs"]


def _tiny():
    spec = importlib.util.spec_from_file_location(
        "tiny_added", ROOT / "portbench" / "tests" / "_tiny_added.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _hard_cell(**varnet_kwargs):
    cell = _tiny().tiny_cell("hard3dt-adam")
    config = {**cell.config,
              "varnet_kwargs": {**cell.config["varnet_kwargs"], **varnet_kwargs}}
    return cell._replace(config=config)


def test_shapes_at_the_recipe_mesh():
    config = harness.load_cell("hard3dt-adam").config
    s = roofline.shapes(config)
    assert (s["tests"], s["points"], s["bc_points"], s["ic_points"]) == (30_375, 7_776_000, 0, 0)
    assert (s["n_in"], s["k0"], s["widths"], s["panels"]) == (4, 4, (64, 64), 2)
    assert roofline.adam_step_flops(s) == pytest.approx(5.3947e11, rel=1e-4)


@pytest.mark.parametrize("disc,t_disc", [(4, 3), (5, 4), (3, 6)])
def test_shapes_and_mesh_match_the_program(disc, t_disc):
    fixed = build_fixed_data(transient_ad_3d(**KW)["pde"], disc, b_disc_num=4, t_disc_num=t_disc)
    config = {**harness.load_cell("hard3dt-adam").config, "disc_num": disc, "t_disc_num": t_disc}
    s = roofline.shapes(config)
    assert s["tests"] == fixed.static.n_test
    assert s["points"] == fixed.static.n_test * fixed.static.n_quad_per_test
    data = hard_form.build(ref_problems.build("transient_ad_3d", **KW), disc, t_disc)
    assert (data.centers.shape[0], data.offsets.shape[0]) == (s["tests"], s["points"] // s["tests"])
    # the program's quadrature points, as a set, are the reference's
    ref_pts = (data.centers[:, None] + data.offsets[None]).reshape(-1, 4).numpy()
    ours = np.asarray(fixed.quad.coords)[: s["tests"]].reshape(-1, 4)
    key = lambda a: a[np.lexsort(np.round(a, 12).T[::-1])]  # noqa: E731
    np.testing.assert_allclose(key(ref_pts), key(ours), rtol=0, atol=1e-12)
    assert data.vol == pytest.approx(float(np.sum(np.asarray(fixed.quad.w))), rel=1e-6)


@pytest.fixture(scope="module")
def tables():
    """The reference's tables and the program's at the program's points."""
    pde = transient_ad_3d(**KW)["pde"]
    fixed = build_fixed_data(pde, 4, b_disc_num=4, t_disc_num=3)
    coords = np.asarray(fixed.quad.coords, dtype=np.float64)[: fixed.static.n_test]
    ours = HardBC(pde).tables(coords)
    prob = ref_problems.build("transient_ad_3d", **KW)
    ref = hard_form.ansatz_tables(prob, torch.tensor(coords.reshape(-1, 4)))
    return ours, [r.numpy().reshape(np.shape(o)) for r, o in zip(ref, (
        ours.A, ours.dA, ours.At, ours.B, ours.dB, ours.Bt))]


@pytest.mark.parametrize("i,field", enumerate(["A", "dA", "At", "B", "dB", "Bt"]))
def test_reference_tables_match_the_programs(tables, i, field):
    ours, ref = tables
    a = np.asarray(getattr(ours, field))
    # central differences at a step of 1e-6 of the diagonal: ~1e-10
    np.testing.assert_allclose(ref[i], a, rtol=0, atol=1e-8)


def test_distance_vanishes_on_the_faces_and_matches_the_programs():
    prob = ref_problems.build("transient_ad_3d", **KW)
    pde = transient_ad_3d(**KW)["pde"]
    gen = torch.Generator().manual_seed(3)
    x = torch.rand(500, 3, generator=gen, dtype=torch.float64)
    np.testing.assert_allclose(hard_form.distance(prob, x).numpy(), HardBC(pde).dist(x.numpy()),
                               rtol=1e-14, atol=1e-16)
    assert bool(torch.all(hard_form.distance(prob, x) > 0))
    for j in range(3):
        for side in (0.0, 1.0):
            y = x.clone()
            y[:, j] = side
            assert float(hard_form.distance(prob, y).abs().max()) < 1e-15


@pytest.mark.parametrize("path", ["fused_k4_plain", "general"])
def test_hard_adam_matches_the_reference(path):
    cell = _hard_cell(**({} if path == "fused_k4_plain" else {"use_fused_residual": False}))
    vn, params0 = harness.build_program(cell, SEED, "cpu")
    assert vn._fused_kind == ("precoeff" if path == "fused_k4_plain" else None)
    prog = cell.driver.checked(cell, vn)
    ref = cell.driver.reference(cell, params0, "cpu")
    assert len(prog["losses"]) == 3
    np.testing.assert_allclose(prog["losses"], ref["losses"], rtol=RTOL)
    for a, b in zip(compare.leaves(prog["grad"]), compare.leaves(ref["grad"])):
        assert torch.allclose(a, b, rtol=RTOL, atol=RTOL * float(b.abs().max()))
    for a, b in zip(compare.leaves(prog["after"]), compare.leaves(ref["after"])):
        assert torch.allclose(a, b, rtol=RTOL, atol=1e-7)
    numbers = cell.driver.compare_numbers(cell, prog, ref, None)
    assert max(numbers.values()) < RTOL, numbers


def _flagship_lm_cell():
    """The flagship configuration at a tiny size under the LM driver, with the
    flagship recipe's LM settings but for the CG iterations and chunks."""
    cell = harness.load_cell("flagship-adam")
    config = {**cell.config, "disc_num": 6, "b_disc_num": 6, "t_disc_num": 5,
              "reference_block": 13, "layer_width": [12, 12]}
    params = dict(cg_iters=4, cg_segment=4, k_chunks=2, lam0=1e-3, save_freq=1, checked_steps=2)
    driver = harness.load_module(ROOT / "portbench" / "drivers" / "lm.py", "flagship_lm_driver")
    return cell._replace(config=config, driver=driver,
                         workload={"config": cell.config["name"], "driver": "lm", "params": params})


def test_flagship_lm_products_match_the_reference():
    cell = _flagship_lm_cell()
    vn, params0 = harness.build_program(cell, SEED, "cpu")
    prog = cell.driver.checked(cell, vn)
    ref = cell.driver.reference(cell, params0, "cpu")
    assert prog["lams"] == ref["lams"]
    for key, want in (("jtr", "grad"), ("jtjb", "jtjb")):
        for a, b in zip(compare.leaves(prog[key]), compare.leaves(ref[want])):
            assert torch.allclose(a, b, rtol=RTOL, atol=RTOL * float(b.abs().max())), key


def test_k4_bytes_are_the_coeffdata_rows():
    """K4 reads per point the n_in scaled coordinates, the n_in direction rows,
    csrc and cu: the k4_roofline's n_in + n_fields."""
    cell = _hard_cell()
    vn, _ = harness.build_program(cell, SEED, "cpu")
    quad = pad_quad(vn.fixed.quad, 1)
    data = prepare_residual_coeffs(quad, vn.scale, vn.shift, time_dependent=True,
                                   has_react=False, hard=vn._hard_tables(quad))
    rows = data.xs.shape[0] + data.cdir.shape[0] + 1 + (data.cu is not None)
    s = roofline.shapes(cell.config)
    assert rows == s["n_in"] + (s["n_in"] + 2) == 10


class _Ctx:
    def __init__(self, events, shapes, hi):
        self.events, self.shapes, self.units, self.lo, self.hi = events, shapes, 3, 0.0, hi


def _k4_read(events, hi):
    reader = harness.load_module(ROOT / "portbench" / "metrics" / "k4_roofline.py", "m_k4")
    return reader.read(_Ctx(events, roofline.shapes(harness.load_cell("hard3dt-adam").config), hi))


@pytest.mark.parametrize("stretch", [1.0, 1.7, 40.0])
def test_k4_roofline_on_synthetic_events(stretch):
    """Three forward and three backward launches at ``stretch`` times their
    bound read 100 / stretch %; a helper pass of K4's family (the reduction)
    adds its time, a kernel of another family adds none."""
    s = roofline.shapes(harness.load_cell("hard3dt-adam").config)
    evs, at = [], 0.0
    for name, kind in (("void vr_fwd_kernel<64, true>(VrProblem)", "fwd"),
                       ("void vr_bwd_kernel<64, 2, true>(VrProblem)", "bwd")):
        bound = roofline.bound_seconds(*roofline.bounds(
            kind, s["widths"], s["k0"], 2, s["points"], 4, s["tests"], 6))
        for _ in range(3):
            evs.append(trace.Event(name, True, True, at, at + bound * stretch))
            at += bound * stretch
    other = trace.Event("void ff_jvp_kernel<3, false>(FfProblem)", True, True, at, at + 1.0)
    share = _k4_read(evs + [other], at + 1.0)
    assert share == pytest.approx(100.0 / stretch) and share <= 100.0 + 1e-9
    helper = trace.Event("vr_reduce_kernel", True, True, at, 2 * at)
    assert _k4_read(evs + [helper], 2 * at) == pytest.approx(50.0 / stretch)


def test_k4_roofline_with_nothing_to_read_returns_none():
    evs = [trace.Event("void ff_fwd_kernel<3, false>(FfProblem)", True, True, 0.0, 1.0)]
    assert _k4_read(evs, 1.0) is None


def test_the_new_reference_files_import_nothing_of_the_port():
    for path in (ROOT / "portbench" / "reference" / "forms" / "transient_box3d_hard.py",
                 ROOT / "portbench" / "reference" / "problems" / "transient_ad_3d.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            assert not {n.split(".")[0] for n in names} & {
                "varnet_tpu", "varnet_tpu_torch", "jax", "jaxlib", "flax"}, path


class _Clock:
    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


class _Probed:
    """A program whose train call takes ``overheads[i] + n * per_epoch`` seconds
    (the i-th call's own preparation first) and ``report`` more for each report,
    with ``VarNet.train``'s ``wall_times`` (from the end of the first epoch,
    each read after its report's error evaluation) and ``report_seconds``."""

    def __init__(self, clock, per_epoch, overheads, report):
        self.clock, self.per_epoch, self.overheads = clock, per_epoch, list(overheads)
        self.report = report
        self.device = torch.device("cpu")
        self.calls = []

    def train(self, epoch_num, save_freq, **kw):
        ov = self.overheads[len(self.calls) % len(self.overheads)]
        self.calls.append(epoch_num)
        ends = range(save_freq, epoch_num + 1, save_freq)
        self.clock.now += ov + epoch_num * self.per_epoch + len(ends) * self.report
        walls = [(e - 1) * self.per_epoch + (k + 1) * self.report for k, e in enumerate(ends)]
        return type("R", (), {"wall_times": walls, "report_seconds": len(ends) * self.report})()


@pytest.mark.parametrize("per_epoch,overheads,report", [
    (0.019, [0.9], 0.0), (0.019, [0.5, 1.4, 0.7], 0.019), (0.008, [0.05, 0.3], 0.004),
    (0.25, [0.3, 1.3], 0.05)])
def test_timed_window_is_sized_past_the_calls_own_time(monkeypatch, per_epoch, overheads, report):
    """``adam_timed`` reads an epoch off one call's reports, less the reports'
    own time, so however the per-call preparation varies, the window plus its
    call fills the seconds."""
    cell = harness.load_cell("hard3dt-adam")
    assert cell.workload["driver"] == "adam_timed"
    clock = _Clock()
    monkeypatch.setattr(cell.driver, "time", clock)
    vn = _Probed(clock, per_epoch, overheads, report)
    n = cell.driver.size(cell, vn, 40.0, None)
    last = overheads[(len(vn.calls) - 1) % len(overheads)] + 4 * report
    assert abs(n - (40.0 - last) / per_epoch) <= 1
    assert vn.calls[0] == 8 and all(b == 2 * a for a, b in zip(vn.calls, vn.calls[1:]))
    assert 1.0 <= vn.calls[-1] * 3 // 4 * per_epoch < 2.0 or vn.calls == [8]
