"""The A B B A runner shared by ``scripts/ab_adam.py``, ``ab_vj.py`` and ``ab_ff.py``:
two checkouts of this repository alternated on one GPU, each run a fresh process in its
checkout (which builds that checkout's kernels on its first run), so a drift of the
shared host over the call falls on both trees alike.

A script hands ``main`` its child program (Python source run with ``python -c`` in the
tree under test; its options arrive as one JSON object in ``sys.argv[1]``, its last line
of output is one JSON object of numbers) and its options.  ``main`` prints the card's
name and power limit, one JSON line per run and last a JSON summary with each tree's
numbers in run order.  The child can import ``kernel_ms`` from this module: the scripts
directory is put on its path.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SCRIPTS = os.path.dirname(os.path.abspath(__file__))


def kernel_ms(fn, n=3):
    """Each CUDA kernel's own device time per call of ``fn`` (ms), mean over ``n`` calls
    under ``torch.profiler``, after one call outside it; keyed by the kernel's name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()

    def dev_us(e):
        return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))

    return {e.key.split("(")[0]: dev_us(e) * 1e-3 / n
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA}


def run(tree, child, options):
    """One run of ``child`` in ``tree``: its last output line, parsed."""
    src = f"import sys\nsys.path.insert(0, {SCRIPTS!r})\nsys.path.insert(0, '.')\n" + child
    out = subprocess.run([sys.executable, "-c", src, json.dumps(options)], cwd=tree,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"{tree}: exit {out.returncode}\n{out.stdout[-2000:]}\n"
                         f"{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(child, argv=None, options=(), check=None):
    """Parse ``tree_a tree_b --pairs N`` and ``options`` (``(flag, type, default)``
    each, handed to the child by their dest names), ``check`` the parsed arguments
    (raise SystemExit on a bad one), then run A B B A ``--pairs`` times."""
    ap = argparse.ArgumentParser()
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--pairs", type=int, default=3)
    for flag, typ, default in options:
        ap.add_argument(flag, type=typ, default=default)
    args = ap.parse_args(argv)
    if check:
        check(args)
    opts = {k: v for k, v in vars(args).items() if k not in ("tree_a", "tree_b", "pairs")}

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    trees = {"a": os.path.abspath(args.tree_a), "b": os.path.abspath(args.tree_b)}
    runs = {"a": [], "b": []}
    for _ in range(args.pairs):
        for key in ("a", "b", "b", "a"):
            nums = run(trees[key], child, opts)
            runs[key].append(nums)
            print(json.dumps({"tree": trees[key], **nums}), flush=True)
    print(json.dumps({key: {"tree": trees[key],
                            **{name: [r[name] for r in runs[key]] for name in runs[key][0]}}
                      for key in runs}), flush=True)
