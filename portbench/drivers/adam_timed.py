"""Adam traffic as ``adam.py`` drives it (the same call, checked steps, window,
reports, rates, reference and comparison), with the window sized from epochs
timed inside one call.

``adam.py`` sizes the window from the difference of two whole calls.  Each call
pays its own preparation first; where that preparation is long against an
epoch and varies from call to call, the difference of the two short calls that
reach ``PROBE_SECONDS`` misses an epoch's time by a wide margin.  The exact-BC
3-D transient recipe is such a case: about 1 s of per-call preparation (the
padded tables and the quadrature data copied to the card, K4's fold) against
19 ms an epoch on an H100, so that windows of 12 s and of 454 s came out of one
cell.

Here each probe is one call of n epochs that reports at its quarters; an
epoch's time is read off the call's report times after the first quarter,
which its preparation does not reach, less the reports' own time (each
evaluates the error; left in, it would weigh on an epoch by how few epochs
the probe ran), and the call's own time is what the probe took beyond its
epochs.  Probes double n until the epochs between the reports span
``PROBE_SECONDS``.  The window is the epochs that fill ``seconds`` beside the
call's own time, as in ``adam.py``.
"""

from __future__ import annotations

import time

import torch

from portbench.drivers.adam import (  # noqa: F401  (the driver's interface)
    FAULTS, _call, checked, compare_numbers, rates, reference, varnet_kwargs, window,
    window_finite, work_units)

PROBE_SECONDS = 1.0
FIRST_PROBE = 8


def size(cell, vn, seconds, first):
    """Epochs in the window, from the report times of one probe call (module
    docstring)."""
    n = FIRST_PROBE
    while True:
        t = time.perf_counter()
        res = _call(cell, vn, n, n // 4)
        if vn.device.type == "cuda":
            torch.cuda.synchronize(vn.device)
        total = time.perf_counter() - t
        # a report's time is spent before its wall time is read: the first
        # report's before wall_times[0], the other three's between the two ends
        walls = res.wall_times
        reports = res.report_seconds * (len(walls) - 1) / len(walls)
        spanned = walls[-1] - walls[0] - reports
        if spanned >= PROBE_SECONDS or n >= 1 << 16:
            break
        n *= 2
    per_epoch = spanned / (n - n // 4) if spanned > 0 else total / n
    call = max(total - n * per_epoch, 0.0)
    return max(2, round((float(seconds) - call) / per_epoch))
