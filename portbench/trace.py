"""The traced run: ``torch.profiler`` over the window, its events reduced to
plain records, and the arithmetic that the per-layer readers share (device
busy time as the union of device intervals, kernel time by name, idle gaps
by what the host was doing).

An event is ``(name, on_device, kernel, start_s, end_s)``.  On a CUDA device
the profiler records the card's activity only: its kernels, copies and fills,
and on the host the CUDA runtime calls that launched or waited for them.  Host
operators are left out: an LM window launches millions of them, and recording
them would slow the host-paced parts that the trace is there to show.
"""

from __future__ import annotations

import bisect
import re
from typing import Iterable, List, NamedTuple


# device activity that is not a kernel: copies and fills
_NOT_KERNELS = ("Memcpy", "Memset")


class Event(NamedTuple):
    name: str
    on_device: bool
    kernel: bool
    start: float
    end: float


def profile(device_type: str):
    """A profiler over the card's activity (host operators on a CPU device,
    where there is no card)."""
    from torch.profiler import ProfilerActivity, profile as _profile

    acts = [ProfilerActivity.CUDA if device_type == "cuda" else ProfilerActivity.CPU]
    return _profile(activities=acts, record_shapes=False, with_stack=False)


def events(prof) -> List[Event]:
    """The profiler's raw events as :class:`Event` records (seconds)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        dev = "CUDA" in str(e.device_type())
        name = e.name()
        start = e.start_ns() * 1e-9
        out.append(Event(name, dev, dev and not name.startswith(_NOT_KERNELS), start,
                         start + e.duration_ns() * 1e-9))
    return out


def busy_intervals(evs: Iterable[Event]) -> List[tuple]:
    """The union of the device events' intervals, merged and sorted."""
    spans = sorted((e.start, e.end) for e in evs if e.on_device)
    merged: List[list] = []
    for a, b in spans:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [tuple(m) for m in merged]


def busy_seconds(evs: Iterable[Event]) -> float:
    return sum(b - a for a, b in busy_intervals(evs))


def kernels(evs: Iterable[Event], pattern: str) -> List[Event]:
    """The device kernels whose name contains a match of ``pattern``."""
    rx = re.compile(pattern)
    return [e for e in evs if e.kernel and rx.search(e.name)]


def kernel_seconds(evs: Iterable[Event], pattern: str) -> float:
    return sum(e.end - e.start for e in kernels(evs, pattern))


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and parameters."""
    if name.startswith(_NOT_KERNELS):
        return " ".join(name.split()[:2])
    base = name.replace("(anonymous namespace)::", "")
    while True:
        stripped = re.sub(r"<[^<>]*>", "", base)
        if stripped == base:
            break
        base = stripped
    base = base.split("(")[0].split()
    return base[-1] if base else name


def top_device_ops(evs: Iterable[Event], n: int = 10) -> List[list]:
    """The device operations with the most time, summed by short name."""
    total: dict = {}
    for e in evs:
        if e.on_device:
            key = short_name(e.name)
            total[key] = total.get(key, 0.0) + (e.end - e.start)
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(evs: List[Event], lo: float, hi: float, n: int = 10) -> List[list]:
    """Idle time of the card inside [lo, hi], summed by the host call (a CUDA
    runtime call on a CUDA device) running at the start of each gap."""
    busy = busy_intervals(evs)
    gaps, at = [], lo
    for a, b in busy:
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if hi > at:
        gaps.append((at, hi))
    host = sorted((e for e in evs if not e.on_device), key=lambda e: e.start)
    starts = [e.start for e in host]
    total: dict = {}
    for a, b in gaps:
        # the latest-started host event still running at a is the innermost
        # (a bounded look back: past it only long spans remain)
        i = bisect.bisect_right(starts, a)
        label = next((e.name for e in reversed(host[max(0, i - 256):i]) if e.end > a),
                     "host code between CUDA calls")
        total[label] = total.get(label, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
