"""The plain reference held to the port's eager path (its plain versions, on
the CPU) at a small mesh: Adam's losses, first gradient and parameters after
three steps, and LM's losses, damping, parameters after two iterations and
the products its CG starts from (J^T r, J^T J b), for both configurations; and the reference imports nothing of the port."""

from __future__ import annotations

import ast
import math

import pytest
import torch

from _tiny import ROOT, tiny_cell
from portbench import compare, harness

# f32 sums in another order: Adam agrees to ~1e-7 relative; LM's CG amplifies
# the rounding (measured 2e-4 on the flagship's first step at this mesh)
ADAM_RTOL = 1e-5
LM_RTOL = 2e-3


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _program_and_reference(name, seed):
    cell = tiny_cell(name)
    vn, params0 = harness.build_program(cell, seed, "cpu")
    prog = cell.driver.checked(cell, vn)
    ref = cell.driver.reference(cell, params0, "cpu")
    return cell, prog, ref


def _close(a, b, rtol):
    return all(math.isclose(x, y, rel_tol=rtol) for x, y in zip(a, b)) and len(a) == len(b)


@pytest.mark.parametrize("name", ["flagship-adam", "contaminant-adam"])
def test_adam_reference_matches_port(name):
    _, prog, ref = _program_and_reference(name, 2 ** 31 + 11)
    assert len(prog["losses"]) == 3 and _close(prog["losses"], ref["losses"], ADAM_RTOL)
    for a, b in zip(compare.leaves(prog["grad"]), compare.leaves(ref["grad"])):
        assert torch.allclose(a, b, rtol=ADAM_RTOL, atol=ADAM_RTOL * float(b.abs().max()))
    for a, b in zip(compare.leaves(prog["after"]), compare.leaves(ref["after"])):
        assert torch.allclose(a, b, rtol=ADAM_RTOL, atol=1e-7)


def test_lm_reference_matches_port():
    _, prog, ref = _program_and_reference("contaminant-lm", 2 ** 31 + 12)
    assert _close(prog["losses"], ref["losses"], LM_RTOL)
    assert prog["lams"] == ref["lams"]
    for key, want in (("jtr", "grad"), ("jtjb", "jtjb")):
        for a, b in zip(compare.leaves(prog[key]), compare.leaves(ref[want])):
            assert torch.allclose(a, b, rtol=ADAM_RTOL, atol=ADAM_RTOL * float(b.abs().max())), key
    assert compare.leaf_gap(compare.change(prog["after"], prog["before"]),
                            compare.change(ref["after"], ref["before"])) < LM_RTOL


def test_reference_imports_nothing_of_the_port():
    for path in (ROOT / "portbench" / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) and not node.level
                     else [])
            tops = {n.split(".")[0] for n in names}
            assert not tops & {"varnet_tpu", "varnet_tpu_torch", "jax", "jaxlib", "flax"}, path
