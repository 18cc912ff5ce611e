"""Cells of ``BENCHMARK.json`` cut to a mesh and net that a CPU test run holds."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

CELLS = ["flagship-adam", "contaminant-adam", "contaminant-lm"]
MESH = dict(disc_num=6, b_disc_num=6, t_disc_num=5, reference_block=13)
WIDTH = {"flagship_w48x2": [12, 12], "contaminant_ff128_w96x3": [16, 16, 16]}
LM = dict(k_chunks=2, cg_iters=4)


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    config = {**cell.config, **MESH, "layer_width": WIDTH[cell.config["name"]]}
    workload = cell.workload
    if workload["driver"] == "lm":
        workload = {**workload, "params": {**workload["params"], **LM}}
    return cell._replace(config=config, workload=workload)
