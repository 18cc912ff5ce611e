#!/usr/bin/env python3
"""Flagship Adam throughput of two checkouts of this repository, alternated on one
GPU: 200 (``--epochs``) Adam epochs of ``transient_ad_2d`` at d48/t32, w20x2, through
the fused residual kernels K1/K2, as ``chip_smoke.py``'s train phase runs them, each
run in a fresh process from its checkout's own ``chip_smoke.py`` (which builds that
checkout's kernels on its first run).

    python3 scripts/ab_adam.py OTHER_CHECKOUT . --pairs 3

Runs A, B, B, A for each pair, so a drift of the shared host over the call falls on
both trees alike.  Prints the card's name and power limit, one JSON line per run and
last a JSON summary with each tree's steps/s and quad-pt evals/s in run order.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = """
import json, sys
sys.path.insert(0, ".")
import chip_smoke as cs
cs.phase_build()
_, res = cs._train((20, 20), None, {epochs}, {epochs}, True)
print(json.dumps({{"steps_per_sec": res.steps_per_sec,
                  "quad_evals_per_sec": res.quad_evals_per_sec}}))
"""


def run(tree, epochs):
    out = subprocess.run([sys.executable, "-c", CHILD.format(epochs=epochs)], cwd=tree,
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise SystemExit(f"{tree}: exit {out.returncode}\n{out.stdout[-2000:]}\n"
                         f"{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("tree_a")
    ap.add_argument("tree_b")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--epochs", type=int, default=200)
    args = ap.parse_args(argv)

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    trees = {"a": os.path.abspath(args.tree_a), "b": os.path.abspath(args.tree_b)}
    runs = {"a": [], "b": []}
    for _ in range(args.pairs):
        for key in ("a", "b", "b", "a"):
            nums = run(trees[key], args.epochs)
            runs[key].append(nums)
            print(json.dumps({"tree": trees[key], **nums}), flush=True)
    print(json.dumps({key: {"tree": trees[key],
                            "steps_per_sec": [r["steps_per_sec"] for r in runs[key]],
                            "quad_evals_per_sec": [r["quad_evals_per_sec"] for r in runs[key]]}
                      for key in runs}), flush=True)


if __name__ == "__main__":
    main()
