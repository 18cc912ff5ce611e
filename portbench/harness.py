"""One run of one cell: set-up, the timed window, the traced readings and the
check of the window's first steps against the plain reference.

Everything that belongs to one configuration, traffic mix or per-layer metric
sits in a file of its own, found by the name that ``BENCHMARK.json`` gives:

    configs/<config>.json      the problem, weak form, mesh, net and loss weights
    reference/forms/<form>.py  the reference's weak form: its data, rows and shapes
    reference/problems/<p>.py  the reference's problem, by the program's factory name
    workloads/<cell>.json      the config, the kind of traffic, its parameters, the limits
    drivers/<traffic>.py       one kind of traffic: how the program is driven and checked
    metrics/<metric>.py        one per-layer metric: ``read(ctx)`` from the traced window

The program is the PyTorch/CUDA port; the reference (``reference/``) imports
nothing of it.  The benchmark draws the weights from the seed and hands the
same weights to both.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Any, Dict, NamedTuple

import numpy as np

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "varnet_tpu")


class Cell(NamedTuple):
    name: str
    chips: int
    config: Dict[str, Any]
    workload: Dict[str, Any]
    bench: Dict[str, Any]
    driver: Any


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    workload = json.loads((PKG / "workloads" / f"{name}.json").read_text())
    driver = load_module(PKG / "drivers" / f"{workload['driver']}.py",
                         f"portbench_driver_{workload['driver']}")
    return Cell(name, int(entry["chips"]), config, workload, bench, driver)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def end_to_end_metrics(cell: Cell):
    return [m for m in cell.bench["end_to_end"]
            if m.get("workloads") is None or cell.name in m["workloads"]]


def per_layer_metrics(cell: Cell):
    """The per-layer metrics that list the cell (every entry lists its cells)."""
    return [m for m in cell.bench["per_layer"] if cell.name in m["workloads"]]


def fourier_bt2pi(config, device):
    """2 pi B as float32 [3, F] (None without an embedding), from the
    configuration's own file."""
    import torch

    if not config.get("fourier_b_file"):
        return None
    b = np.load(PKG / "configs" / config["fourier_b_file"])
    return ((2.0 * math.pi) * torch.tensor(b, dtype=torch.float32)).to(device)


def layer_sizes(config):
    from . import roofline

    return [roofline.shapes(config)["k0"]] + list(config["layer_width"]) + [1]


def build_program(cell: Cell, seed: int, device):
    """The port's ``VarNet`` of the configuration, with weights drawn on the
    device from ``seed`` (the same weights go to the reference).  The problem
    is the factory ``problem`` of ``varnet_tpu_torch.problems.<problem_module>``
    (``analytic`` by default); ``varnet_kwargs`` adds constructor options."""
    from varnet_tpu_torch import VarNet

    from .reference.model import draw_params

    cfg = cell.config
    problems = importlib.import_module(
        f"varnet_tpu_torch.problems.{cfg.get('problem_module', 'analytic')}")
    pde = getattr(problems, cfg["problem"])(**cfg["problem_kwargs"])["pde"]
    kw = {k: cfg[k] for k in ("disc_num", "b_disc_num", "t_disc_num", "integ_p_num") if k in cfg}
    kw.update(layer_width=tuple(cfg["layer_width"]), activation=cfg["activation"],
              input_scaling=cfg["input_scaling"], seed=int(seed) % (2 ** 63), device=device)
    if cfg.get("fourier_b_file"):
        kw["fourier_b"] = np.load(PKG / "configs" / cfg["fourier_b_file"])
    kw.update(cfg.get("varnet_kwargs", {}))
    kw.update(cell.driver.varnet_kwargs(cell))
    vn = VarNet(pde, **kw)
    params0 = draw_params(seed, layer_sizes(cfg), device)
    vn.theta = [{"w": w.clone(), "b": b.clone()} for w, b in params0]
    return vn, params0


def theta_pairs(theta):
    """The program's net as (W, b) pairs, copied."""
    net = theta["net"] if isinstance(theta, dict) else theta
    return [(layer["w"].detach().clone(), layer["b"].detach().clone()) for layer in net]


def reference_setup(cell: Cell, device):
    """The reference's problem, fixed data and loss weights for the cell's
    config, built by the config's weak form (``reference/forms/<form>.py``)."""
    from .reference import forms

    cfg = cell.config
    return forms.load(cfg["form"]).setup(cfg, device, fourier_bt2pi(cfg, device))


def launch_counts() -> Dict[str, int]:
    """The port's per-kernel launch counters."""
    from varnet_tpu_torch.ops import fused_residual, value_and_jac

    return {f"{mod.__name__.rsplit('.', 1)[-1]}.{name}": int(fn.launches)
            for mod in (fused_residual, value_and_jac)
            for name, fn in vars(mod).items() if hasattr(fn, "launches")}


class TraceContext(NamedTuple):
    """What a per-layer reader reads: the traced window's events, its bounds,
    the cell and its shapes, the window's work units and the spans timed by the
    harness."""

    events: list
    lo: float
    hi: float
    cell: Cell
    shapes: dict
    units: int
    spans: Dict[str, float]


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device, t0: float) -> dict:
    """Set-up, window, readings and check of one run; returns the result line."""
    import torch

    from . import compare, roofline, trace

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import varnet_tpu_torch  # noqa: F401  (imported before the data build is timed)

    drv = cell.driver
    spans, phases = {}, {"import_s": time.perf_counter() - t0}
    t = time.perf_counter()
    vn, params0 = build_program(cell, seed, device)
    _sync(device)
    spans["data_build_s"] = time.perf_counter() - t
    t = time.perf_counter()
    first = drv.checked(cell, vn)
    phases["checked_s"] = time.perf_counter() - t
    t = time.perf_counter()
    units = drv.size(cell, vn, seconds, first)
    _sync(device)
    phases["size_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t0

    before = launch_counts()
    with trace.profile(torch.device(device).type) if traced else contextlib.nullcontext() as prof:
        t = time.perf_counter()
        out = drv.window(cell, vn, units)
        _sync(device)
        elapsed = time.perf_counter() - t
    launches = {k: v - before.get(k, 0) for k, v in launch_counts().items() if v != before.get(k, 0)}
    on_cuda = torch.device(device).type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if on_cuda else 0
    finite = drv.window_finite(out)

    metrics, dev, breakdown = {}, {}, None
    if not traced:
        values = {"setup_s": setup_s, **drv.rates(cell, units, elapsed)}
        for m in end_to_end_metrics(cell):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        evs = trace.events(prof)
        del prof
        # the traced window: from the first to the last activity the profiler saw
        lo, hi = min(e.start for e in evs), max(e.end for e in evs)
        ctx = TraceContext(evs, lo, hi, cell, roofline.shapes(cell.config), units, spans)
        for m in per_layer_metrics(cell):
            value = load_module(PKG / "metrics" / f"{m['name']}.py",
                                f"portbench_metric_{m['name']}").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev = {"busy_s": trace.busy_seconds(evs), "window_s": hi - lo}
        breakdown = {"device_ops": trace.top_device_ops(evs),
                     "idle_gaps": trace.idle_gaps(evs, lo, hi)}
        del evs, ctx

    del vn, out
    gc.collect()
    if on_cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    setup = reference_setup(cell, device)
    ref = drv.reference(cell, params0, device, setup=setup)
    numbers = drv.compare_numbers(cell, first, ref, setup)
    phases["reference_s"] = time.perf_counter() - t
    numbers["window_nonfinite"] = 0.0 if finite else 1.0
    limits = {**cell.workload.get("limits", {}), "window_nonfinite": 0.0}
    correct = compare.judge(numbers, limits)

    result = {"correct": bool(correct), "attempted": int(drv.work_units(cell, units)),
              "failed": 0 if finite else int(drv.work_units(cell, units)),
              "metrics": metrics,
              "device": {"platform": "gpu" if on_cuda else "cpu",
                         "kind": torch.cuda.get_device_name(device) if on_cuda else "cpu",
                         "count": cell.chips, "memory_peak_bytes": peak, **dev}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["notes"] = {"seed": int(seed), "units": int(units), "window_s": elapsed,
                       "setup_s": setup_s, **spans, **phases, "launches": launches}
    # the numbers compared, each beside its limit: the line's last key
    result["checks"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    return result
