"""Weak forms of the reference, one file per form, found by the configuration's
``form`` key: ``forms/<form>.py`` defines

    setup(config, device, bt2pi) -> loss.Setup   the problem, the fixed data and
                                                  the loss weights, built again
    blocks(setup) -> [(k0, k1), ...]              blocks of test functions
    rows(params, setup, blk) -> tensor            the rows of r_vec of one block,
                                                  or the penalty rows for blk None
    shapes(config) -> dict                        the sizes the roofline and MFU
                                                  read: tests, points, bc_points,
                                                  ic_points, n_in, k0, widths,
                                                  panels

so that a configuration on another domain or weak form comes with a file of
its own.
"""

from __future__ import annotations

import importlib


def load(form: str):
    return importlib.import_module(f"{__name__}.{form}")
