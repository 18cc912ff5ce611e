"""The cell that ``_tiny.py`` does not list (``hard3dt-adam``) through the harness on the
CPU, cut by ``_tiny_added.py``: it loads by name with its configuration, weak form,
problem, driver and metrics; a sound run is correct; the TF32 control is not; and every
fault its driver names is caught."""

from __future__ import annotations

import json

import pytest
import torch

from _tiny_added import ADDED, ROOT, tiny_cell
from portbench import compare, faults, harness, roofline
from portbench.reference import forms

SEED = 2 ** 31 + 23
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _limits(cell):
    return {**cell.workload["limits"], "window_nonfinite": 0.0}


@pytest.mark.parametrize("name", ADDED)
def test_added_cell_loads_by_name(name):
    cell = harness.load_cell(name, ROOT)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell.config["name"] == entry["config"] and cell.chips == 1
    form = forms.load(cell.config["form"])
    for fn in ("setup", "blocks", "rows", "shapes"):
        assert callable(getattr(form, fn)), fn
    e2e = {m["name"] for m in harness.end_to_end_metrics(cell)}
    per_layer = harness.per_layer_metrics(cell)
    assert "setup_s" in e2e and len(e2e) == 2
    assert per_layer and all(m["moves"] in e2e for m in per_layer)
    for m in per_layer:
        assert callable(harness.load_module(ROOT / "portbench" / "metrics" / f"{m['name']}.py",
                                            f"added_{m['name']}").read)
    config_entry = next(c for c in BENCH["configs"] if c["name"] == cell.config["name"])
    assert set(config_entry["reduced"]) == set(cell.config["reduced"]) <= set(cell.config)


@pytest.mark.parametrize("name", ADDED)
def test_added_cell_runs_correct_and_traced(name):
    cell = tiny_cell(name)
    for traced in (False, True):
        res = harness.run_cell(cell, SEED, 0.3, traced, "cpu", 0.0)
        assert res["correct"], res["checks"]
        assert set(res["checks"]) == set(_limits(cell))
    assert roofline.shapes(cell.config)["points"] > 0


@pytest.mark.parametrize("name", ADDED)
def test_added_cell_tf32_control_is_not_correct(name):
    cell = tiny_cell(name)
    params0 = harness.build_program(cell, SEED, "cpu")[1]
    setup = harness.reference_setup(cell, "cpu")
    ref = cell.driver.reference(cell, params0, "cpu", setup=setup)
    ctrl = cell.driver.reference(cell, params0, "cpu", control=True, setup=setup)
    assert not compare.judge(cell.driver.compare_numbers(cell, ctrl, ref, setup), _limits(cell))


CELL_FAULTS = [(name, fault) for name in ADDED for fault in tiny_cell(name).driver.FAULTS]


@pytest.mark.parametrize("name,fault", CELL_FAULTS, ids=[f"{n}-{f}" for n, f in CELL_FAULTS])
def test_added_cell_broken_timed_path_is_not_correct(name, fault):
    with faults.FAULTS[fault]():
        res = harness.run_cell(tiny_cell(name), SEED, 0.3, False, "cpu", 0.0)
    assert not res["correct"], res["checks"]
