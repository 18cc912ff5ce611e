"""``correct`` at a size that a CPU test run holds: a sound run is correct; the
lower-precision control (the reference with TF32 matrix products in the
program's place) is not; and a run with its timed path broken underneath
(``faults.py``: a step that returns its state unchanged, half of the batch
left out with the mean over the rest, an answer altered where it is produced,
and in LM J v or J^T w altered where CG gets it) is not.  The look for a card is skipped; the rest of a run is driven as on the
card.  The card's own readings at the cells' sizes are ``calibrate.py``'s."""

from __future__ import annotations

import pytest
import torch

from _tiny import CELLS, tiny_cell
from portbench import compare, faults, harness

SEED = 2 ** 31 + 21


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _limits(cell):
    return {**cell.workload["limits"], "window_nonfinite": 0.0}


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    res = harness.run_cell(tiny_cell(name), SEED, 0.3, False, "cpu", 0.0)
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_is_not_correct(name):
    cell = tiny_cell(name)
    params0 = harness.build_program(cell, SEED, "cpu")[1]
    setup = harness.reference_setup(cell, "cpu")
    ref = cell.driver.reference(cell, params0, "cpu", setup=setup)
    ctrl = cell.driver.reference(cell, params0, "cpu", control=True, setup=setup)
    numbers = cell.driver.compare_numbers(cell, ctrl, ref, setup)
    assert not compare.judge(numbers, _limits(cell)), numbers


CELL_FAULTS = [(name, fault) for name in CELLS for fault in tiny_cell(name).driver.FAULTS]


def test_every_fault_is_planted_in_some_cell():
    assert {f for _, f in CELL_FAULTS} == set(faults.FAULTS)


@pytest.mark.parametrize("name,fault", CELL_FAULTS, ids=[f"{n}-{f}" for n, f in CELL_FAULTS])
def test_a_broken_timed_path_is_not_correct(name, fault):
    with faults.FAULTS[fault]():
        res = harness.run_cell(tiny_cell(name), SEED, 0.3, False, "cpu", 0.0)
    assert not res["correct"], res["checks"]
