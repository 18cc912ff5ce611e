#!/usr/bin/env python3
"""Where a benchmark cell's device time and idle time go, by program span.

    python3 scripts/span_report.py --workload <cell> [--seed N] [--seconds S] [--out DIR]

Sets up the cell as ``portbench/run.py`` does (the program built from the seed,
the checked steps, the window sized to ``--seconds``), with the program's span
recorder (``varnet_tpu_torch/utils/spans.py``) on from just before the build,
then runs four windows, each under ``torch.profiler`` over the card's activity
(``portbench/trace.py``): recorder on (the first, continuing the set-up's
recording), off, off, on.  Each window's line gives its rate; the two windows
with the recorder on also give what the spans show:

* ``idle_by_span``: the card's idle seconds by the innermost program span open
  when each gap began (``outside spans`` before and after every span), beside
  ``device_idle`` (the share ``portbench`` reads) and their sum;
* ``kernels_in_spans``: the share of the window's kernels whose launch call (the
  CUDA runtime call that shares the kernel's correlation id) began inside some
  program span, and how many kernels had no launch call in the trace;
* the metrics a traced benchmark run would read from the spans:
  ``adam_prepare_s`` / ``adam_report_s`` (host length of the window call's
  ``train.prepare``, and its ``train.report`` spans summed), ``adam_epoch_idle``
  (% of the window idle in gaps that began while ``train.epoch`` was innermost),
  ``lm_cg_ms`` / ``lm_kernels_per_cg_iter`` (device time and kernels launched
  inside ``lm.cg_iter``, per such span of the window call) and
  ``lm_outside_cg_share`` (% of the device time launched outside it);
* of an LM cell, ``fwd_per_lm_iteration``: the net's forward kernel (K7's
  ``ff_fwd_kernel``, K5's ``vj_fwd_kernel``) launches per LM iteration of the
  window call, by innermost span; and in every window line the LM iteration's
  stored primal (``ops/value_and_jac.py``'s ``primal_fills`` / ``primal_hits``,
  counted over the window call) with ``primal_hit_share`` = hits / (hits + fills);
* with exact BC, ``hard_tables_s`` / ``coeff_fold_s`` and their counts: the
  host seconds of the window call's ``prepare.hard_tables`` (the f64 table
  build, opened only when its cache misses) and ``prepare.coeff_fold`` (K4's
  fold of the tables into its coefficients) spans;
* ``by_span``: launches and device seconds per (kernel, innermost span).

The set-up's span counts and seconds by name (``setup_span_counts``,
``setup_span_seconds``) hold the first table build.

The last line of standard output is one JSON object with every window; the full
record is written to ``<DIR>/span_report_<cell>.json`` (default ``build/span_report``).
Needs a CUDA card: without one it exits 2.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import math
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

OUTSIDE = "outside spans"


class Launched(NamedTuple):
    """A device event and the program span open when its launch call began."""

    name: str
    kernel: bool
    seconds: float
    span: Optional[int]     # index of the innermost program span (None: outside all)
    matched: bool           # a launch call with its correlation id was traced


def innermost_index(spans, hi_ns: int):
    """``at(t_ns)`` -> index of the innermost span open at ``t_ns`` (None outside
    every span).  Spans nest (they come from one thread's ``with`` blocks); one
    still open counts as open until ``hi_ns``."""
    marks = []
    for i, s in enumerate(spans):
        marks.append((s.t0_ns, 1, i))
        marks.append((hi_ns if s.t1_ns is None else s.t1_ns, 0, i))
    marks.sort()
    starts, labels, stack = [-math.inf], [None], []
    for t, opening, i in marks:
        if opening:
            stack.append(i)
        elif i in stack:
            stack.remove(i)
        starts.append(t)
        labels.append(stack[-1] if stack else None)

    def at(t_ns: int):
        return labels[bisect.bisect_right(starts, t_ns) - 1]

    return at


def within(spans, index: Optional[int], name: str) -> bool:
    """Whether span ``index`` or one of its ancestors is named ``name``."""
    while index is not None:
        if spans[index].name == name:
            return True
        index = spans[index].parent
    return False


def launched(events, corr, start_ns, spans, hi_ns) -> List[Launched]:
    """Each device event with the innermost span open when the host call that
    shares its correlation id began (``corr`` and ``start_ns``: each event's
    correlation id, 0 for none, and its start in Unix nanoseconds)."""
    calls = {c: t for e, c, t in zip(events, corr, start_ns) if not e.on_device and c}
    at = innermost_index(spans, hi_ns)
    out = []
    for e, c in zip(events, corr):
        if not e.on_device:
            continue
        t = calls.get(c) if c else None
        out.append(Launched(e.name, e.kernel, e.end - e.start, None if t is None else at(t),
                            t is not None))
    return out


def idle_by_span(events, spans, lo: float, hi: float, hi_ns: int) -> Dict[str, float]:
    """The card's idle seconds in [lo, hi], summed by the innermost span open at
    the start of each gap (``OUTSIDE`` where none is)."""
    from portbench import trace

    at = innermost_index(spans, hi_ns)
    total: Dict[str, float] = defaultdict(float)
    cursor = lo
    for a, b in trace.busy_intervals(events) + [(hi, hi)]:
        if a > cursor:
            i = at(round(cursor * 1e9))
            total[OUTSIDE if i is None else spans[i].name] += a - cursor
        cursor = max(cursor, b)
    return dict(sorted(total.items(), key=lambda kv: -kv[1]))


def window_call(spans, name: str) -> Optional[int]:
    """Index of the last top-level ``name`` span: the window's call."""
    top = [i for i, s in enumerate(spans) if s.name == name and s.parent is None]
    return top[-1] if top else None


def in_call(spans, call: int, name: str) -> List[int]:
    """Indices of the spans named ``name`` inside span ``call``."""
    def descends(i):
        while i is not None and i != call:
            i = spans[i].parent
        return i == call

    return [i for i, s in enumerate(spans) if s.name == name and descends(i)]


def seconds_by_name(spans) -> Dict[str, float]:
    """Host seconds of the closed spans, summed by name."""
    out: Dict[str, float] = defaultdict(float)
    for s in spans:
        if s.t1_ns is not None:
            out[s.name] += (s.t1_ns - s.t0_ns) * 1e-9
    return dict(out)


def exact_bc_metrics(spans, call: int) -> dict:
    """``hard_tables_s`` / ``coeff_fold_s`` (host seconds of the exact-BC
    table build and of K4's coefficient fold inside span ``call``) and the
    counts of those spans; nothing where the call opened neither."""
    out = {}
    for name, key in (("prepare.hard_tables", "hard_tables"), ("prepare.coeff_fold", "coeff_fold")):
        found = in_call(spans, call, name)
        if found:
            out[f"{key}_s"] = sum((spans[i].t1_ns - spans[i].t0_ns) * 1e-9 for i in found)
            out[f"{key}_count"] = len(found)
    return out


def span_metrics(driver: str, events, corr, start_ns, spans) -> dict:
    """What the spans show of one traced window (module docstring) of an
    ``lm`` driver's cell or of an Adam driver's (``adam``, ``adam_timed``)."""
    from portbench import trace

    lo, hi = min(e.start for e in events), max(e.end for e in events)
    hi_ns = round(hi * 1e9) + 1
    dev = launched(events, corr, start_ns, spans, hi_ns)
    kernels = [d for d in dev if d.kernel]
    window = hi - lo
    idle = idle_by_span(events, spans, lo, hi, hi_ns)
    busy = trace.busy_seconds(events)
    out = {"window_s": window, "device_idle": 100.0 * (1.0 - busy / window),
           "idle_by_span_sum": 100.0 * sum(idle.values()) / window, "idle_by_span": idle,
           "kernels": len(kernels),
           "kernels_in_spans": sum(d.span is not None for d in kernels) / max(len(kernels), 1),
           "kernels_unmatched": sum(not d.matched for d in kernels)}
    by: Dict[str, list] = defaultdict(lambda: [0, 0.0])
    for d in dev:
        key = f"{trace.short_name(d.name)} | {OUTSIDE if d.span is None else spans[d.span].name}"
        by[key][0] += 1
        by[key][1] += d.seconds
    out["by_span"] = dict(sorted(by.items(), key=lambda kv: -kv[1][1]))
    dur = lambda i: (spans[i].t1_ns - spans[i].t0_ns) * 1e-9  # noqa: E731
    lm = driver == "lm"
    call = window_call(spans, "lm.call" if lm else "train.call")
    if call is not None:
        out.update(exact_bc_metrics(spans, call))
    if not lm:
        if call is not None:
            out["adam_prepare_s"] = sum(dur(i) for i in in_call(spans, call, "train.prepare"))
            out["adam_report_s"] = sum(dur(i) for i in in_call(spans, call, "train.report"))
        out["adam_epoch_idle"] = 100.0 * idle.get("train.epoch", 0.0) / window
    else:
        n_cg = len(in_call(spans, call, "lm.cg_iter")) if call is not None else 0
        cg = [d for d in dev if within(spans, d.span, "lm.cg_iter")]
        cg_kernels = [d for d in cg if d.kernel]
        device_s = sum(d.seconds for d in dev)
        if n_cg:
            out["lm_cg_ms"] = 1e3 * sum(d.seconds for d in cg) / n_cg
            out["lm_kernels_per_cg_iter"] = len(cg_kernels) / n_cg
        if device_s > 0:
            out["lm_outside_cg_share"] = 100.0 * (1.0 - sum(d.seconds for d in cg) / device_s)
        jvp = [d for d in kernels if "ff_jvp_kernel" in d.name]
        out["ff_jvp_launches"] = len(jvp)
        out["ff_jvp_in_cg_iter"] = sum(within(spans, d.span, "lm.cg_iter") for d in jvp)
        out["lm_cg_iters_in_window"] = n_cg
        n_lm = len(in_call(spans, call, "lm.iteration")) if call is not None else 0
        if n_lm:
            fwd: Dict[str, int] = defaultdict(int)
            for d in kernels:
                if trace.short_name(d.name) in ("ff_fwd_kernel", "vj_fwd_kernel"):
                    fwd[OUTSIDE if d.span is None else spans[d.span].name] += 1
            out["fwd_per_lm_iteration"] = {k: v / n_lm for k, v in sorted(fwd.items())}
            out["lm_iterations_in_window"] = n_lm
    return out


def clock_offset_ms(device) -> float:
    """Milliseconds from a ``time.time_ns()`` read to the start of the CUDA
    runtime call made right after it, as the profiler stamps that call."""
    import torch

    from portbench import harness, trace

    x = torch.zeros(16, device=device)
    with trace.profile(torch.device(device).type) as prof:
        t0 = time.time_ns()
        x.add_(1.0)
        harness._sync(device)
    calls = [e for e in trace.events(prof) if not e.on_device and "Launch" in e.name]
    return (calls[0].start * 1e9 - t0) * 1e-6 if calls else float("nan")


def traced_window(cell, vn, units, device, recorder: bool):
    """One window of the cell under the profiler; with ``recorder`` the spans
    recorded from before the window call to its end."""
    import torch

    from portbench import harness, trace
    from varnet_tpu_torch.ops import value_and_jac as vj
    from varnet_tpu_torch.utils import spans as program_spans

    scope = program_spans.record() if recorder else contextlib.nullcontext()
    stored = (vj.primal_fills, vj.primal_hits)
    with scope as rec, trace.profile(torch.device(device).type) as prof:
        t = time.perf_counter()
        out = cell.driver.window(cell, vn, units)
        harness._sync(device)
        elapsed = time.perf_counter() - t
    fills, hits = vj.primal_fills - stored[0], vj.primal_hits - stored[1]
    kin = list(prof.profiler.kineto_results.events())
    events = trace.events(prof)
    corr = [int(e.correlation_id()) for e in kin]
    start_ns = [int(e.start_ns()) for e in kin]
    del prof, kin
    line = {"recorder": recorder, "elapsed_s": elapsed,
            **cell.driver.rates(cell, units, elapsed),
            "result_prepare_s": out.prepare_seconds, "result_report_s": out.report_seconds,
            "primal_fills": fills, "primal_hits": hits,
            "primal_hit_share": 100.0 * hits / (hits + fills) if hits + fills else None}
    if recorder:
        line.update(span_metrics(cell.workload["driver"], events, corr, start_ns, rec.spans))
    return line


def run(cell, seed: int, seconds: float, device) -> dict:
    """Set-up and the four windows of one cell (module docstring)."""
    import torch

    from portbench import harness
    from varnet_tpu_torch.utils import spans as program_spans

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"workload": cell.name, "seed": seed, "torch": torch.__version__,
              "clock_offset_ms": clock_offset_ms(device)}
    # the recorder is on from just before the build to the end of the first window
    with program_spans.record() as setup_rec:
        vn, _ = harness.build_program(cell, seed, device)
        first = cell.driver.checked(cell, vn)
        units = cell.driver.size(cell, vn, seconds, first)
        windows = [traced_window(cell, vn, units, device, recorder=True)]
    windows += [traced_window(cell, vn, units, device, on) for on in (False, False, True)]
    report.update(units=units, setup_span_counts=setup_rec.counts,
                  setup_span_seconds=seconds_by_name(setup_rec.spans), windows=windows)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=5100000011)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--out", default=str(ROOT / "build" / "span_report"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("span_report: needs a CUDA card", file=sys.stderr)
        return 2
    from portbench import harness

    cell = harness.load_cell(args.workload)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    report = {"card": smi, **run(cell, args.seed, args.seconds, "cuda:0")}
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"span_report_{cell.name}.json").write_text(json.dumps(report, indent=1))
    brief = {k: v for k, v in report.items() if k != "windows"}
    brief["windows"] = []
    for w in report["windows"]:
        line = {k: v for k, v in w.items() if k != "by_span"}
        if "by_span" in w:
            line["by_span_top"] = dict(list(w["by_span"].items())[:12])
        brief["windows"].append(line)
    print(json.dumps(brief), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
