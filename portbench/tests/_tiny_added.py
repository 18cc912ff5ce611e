"""The cell that ``_tiny.py`` does not list (``hard3dt-adam``), cut to a mesh and net that
a CPU test run holds."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

ADDED = ["hard3dt-adam"]
MESH = dict(disc_num=4, b_disc_num=4, t_disc_num=3, reference_block=13, layer_width=[8, 8])


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name, ROOT)
    return cell._replace(config={**cell.config, **MESH})
