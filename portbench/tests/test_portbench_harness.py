"""The harness on the CPU: every cell and metric of ``BENCHMARK.json`` found by
name in its files; the window sized from the warm-up's timings; the result
line's shape; nothing of JAX or the JAX package imported; no result without a
card."""

from __future__ import annotations

import ast
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stderr, redirect_stdout

import pytest

from _tiny import CELLS, ROOT, tiny_cell
from portbench import faults, harness
from portbench.reference import forms

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
DRIVER_API = ("varnet_kwargs", "checked", "size", "window", "window_finite", "work_units",
              "rates", "reference", "compare_numbers")


def test_benchmark_names_its_cells():
    assert {w["name"] for w in BENCH["workloads"]} == set(CELLS)


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = harness.load_cell(name)
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == name)
    for fn in DRIVER_API:
        assert callable(getattr(cell.driver, fn)), fn
    e2e = {m["name"] for m in harness.end_to_end_metrics(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.per_layer_metrics(cell)
    assert per_layer and all(m["moves"] in e2e for m in per_layer)
    form = forms.load(cell.config["form"])
    for fn in ("setup", "blocks", "rows", "shapes"):
        assert callable(getattr(form, fn)), fn
    assert set(cell.driver.FAULTS) <= set(faults.FAULTS)
    entry = next(c for c in BENCH["configs"] if c["name"] == cell.config["name"])
    assert set(entry["reduced"]) == set(cell.config["reduced"]) <= set(cell.config)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_loads_by_name(metric):
    mod = harness.load_module(ROOT / "portbench" / "metrics" / f"{metric}.py", f"t_{metric}")
    assert callable(mod.read)


class _Clock:
    def __init__(self):
        self.now = 0.0

    def perf_counter(self):
        return self.now


class _FakeProgram:
    """A program whose train call takes ``overhead + n * per_epoch`` seconds."""

    def __init__(self, clock, per_epoch, overhead):
        self.clock, self.per_epoch, self.overhead = clock, per_epoch, overhead
        self.device = type("D", (), {"type": "cpu"})()
        self.calls = []

    def train(self, epoch_num, **kw):
        self.calls.append(epoch_num)
        self.clock.now += self.overhead + epoch_num * self.per_epoch


@pytest.mark.parametrize("per_epoch,overhead,seconds,want", [
    (0.008, 0.001, 40.0, 5000), (0.008, 0.3, 40.0, 4962), (0.24, 0.001, 40.0, 167),
    (0.25, 1.3, 40.0, 155), (0.24, 0.001, 10.0, 42), (2.0, 0.001, 10.0, 5)])
def test_adam_window_sized_from_the_warm_up(monkeypatch, per_epoch, overhead, seconds, want):
    cell = harness.load_cell("flagship-adam")
    clock = _Clock()
    monkeypatch.setattr(cell.driver, "time", clock)
    vn = _FakeProgram(clock, per_epoch, overhead=overhead)
    n = cell.driver.size(cell, vn, seconds, None)
    assert abs(n - want) <= 1
    # window + the call's own time = the requested seconds
    assert overhead + n * per_epoch == pytest.approx(seconds, abs=per_epoch)
    # probes double, at least two, until one lasts a second: a few seconds of set-up
    assert len(vn.calls) >= 2 and vn.calls[0] == 2
    assert all(b == 2 * a for a, b in zip(vn.calls, vn.calls[1:]))
    assert clock.now < 4 * max(1.0, 4 * per_epoch) + len(vn.calls) * overhead


@pytest.mark.parametrize("per_step,seconds,want", [(9.7, 40.0, 4), (8.6, 51.0, 6), (30.0, 10.0, 1)])
def test_lm_window_sized_from_the_checked_iterations(per_step, seconds, want):
    cell = harness.load_cell("contaminant-lm")
    assert cell.driver.size(cell, None, seconds, {"seconds_per_step": per_step}) == want


@pytest.fixture(scope="module")
def cpu_results():
    import torch

    torch.set_num_threads(2)
    out = {}
    for traced in (False, True):
        cell = tiny_cell("contaminant-lm")
        out[traced] = harness.run_cell(cell, 2 ** 31 + 5, 0.5, traced, "cpu", 0.0)
    return out


def test_result_line_shape(cpu_results):
    for traced, res in cpu_results.items():
        keys = list(res)
        assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert keys[-1] == "checks"
        assert ("breakdown" in keys) == traced
        assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
        assert isinstance(res["correct"], bool) and res["attempted"] > 0 and res["failed"] == 0
        for m in res["metrics"].values():
            assert set(m) == {"value", "unit"} and isinstance(m["value"], float)
        for c in res["checks"].values():
            assert set(c) == {"value", "limit"}
    untraced = set(cpu_results[False]["metrics"])
    assert untraced == {"lm_cg_iters_per_s", "setup_s"}
    traced = cpu_results[True]
    assert {"busy_s", "window_s"} <= set(traced["device"])
    assert set(traced["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in traced["breakdown"].values())


def test_report_prints_the_checks_last(cpu_results):
    from portbench import run

    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        run.report(cpu_results[False])
    last = json.loads(out.getvalue().splitlines()[-1])
    assert list(last)[-1] == "checks"
    tail = err.getvalue().splitlines()[-len(last["checks"]):]
    assert [line.split()[1] for line in tail] == list(last["checks"])
    assert all(line.startswith("check ") and " limit " in line for line in tail)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("varnet_tpu_torch", "varnet_tpu_torch.api", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    found = set(harness.forbidden_modules())
    assert not found & {"varnet_tpu_torch", "jaxtyping", "flaxen"}
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "varnet_tpu.api", sys)
    assert {"jax", "varnet_tpu"} <= set(harness.forbidden_modules())


def test_portbench_imports_neither_jax_nor_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "varnet_tpu"}
    for path in (ROOT / "portbench").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and not node.level:
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not tops & bad, path


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
            "from _tiny import tiny_cell; from portbench import harness\n"
            "harness.run_cell(tiny_cell('flagship-adam'), 3, 0.2, False, 'cpu', 0.0)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % (str(ROOT), str(ROOT / "portbench" / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "varnet_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "varnet_tpu"}


def test_no_result_without_a_card():
    out = subprocess.run([sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
                          "flagship-adam", "--seed", str(2 ** 31 + 3), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=str(ROOT))
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
