"""Readings that the limits of ``correct`` are set from, for one cell, in one
process on the card:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,...,12 \
        --control-seeds 1,2,3 --fault-seeds 1,2,3

For each seed the program's checked steps (the first steps of the window's own
call, from that seed's weights) against the reference's; for each control seed
the reference computed with TF32 matrix products in the program's place; for
each fault seed the program with each planted fault (``faults.py``).  The
benchmark's runs do not run this.  Prints one JSON line per reading, then the
largest program reading, the smallest control reading and the smallest reading
of each fault, per number.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import compare, faults, harness  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, required=True)
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    import torch

    from portbench.reference.model import draw_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    drv, dev = cell.driver, args.device
    vn, _ = harness.build_program(cell, args.seeds[0], dev)
    setup = harness.reference_setup(cell, dev)
    sizes = harness.layer_sizes(cell.config)
    worst = {}

    def emit(kind, seed, numbers, t0, prog=None, ref=None):
        detail = {} if prog is None else {
            "losses": [prog["losses"], ref["losses"]],
            "change": [compare.change(prog["after"], prog["before"]),
                       compare.change(ref["after"], ref["before"])]}
        print(json.dumps({"kind": kind, "seed": seed, "seconds": time.perf_counter() - t0,
                          **numbers, **detail}), flush=True)
        for k, v in numbers.items():
            key = (kind, k)
            worst[key] = max(worst.get(key, v), v) if kind == "program" else min(worst.get(key, v), v)

    def program_run(seed):
        params0 = draw_params(seed, sizes, dev)
        vn.theta = [{"w": w.clone(), "b": b.clone()} for w, b in params0]
        return params0, drv.checked(cell, vn)

    refs = {}
    for seed in args.seeds:
        t0 = time.perf_counter()
        params0, prog = program_run(seed)
        refs[seed] = drv.reference(cell, params0, dev, setup=setup)
        emit("program", seed, drv.compare_numbers(cell, prog, refs[seed], setup), t0, prog,
             refs[seed])
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        params0 = draw_params(seed, sizes, dev)
        ref = refs.get(seed) or drv.reference(cell, params0, dev, setup=setup)
        ctrl = drv.reference(cell, params0, dev, control=True, setup=setup)
        emit("control", seed, drv.compare_numbers(cell, ctrl, ref, setup), t0, ctrl, ref)
    for seed in args.fault_seeds:
        for name in drv.FAULTS:
            t0 = time.perf_counter()
            with faults.FAULTS[name]():
                params0, prog = program_run(seed)
            ref = refs.get(seed) or drv.reference(cell, params0, dev, setup=setup)
            emit(name, seed, drv.compare_numbers(cell, prog, ref, setup), t0, prog, ref)
    print(json.dumps({"summary": {f"{kind}.{k}": v for (kind, k), v in sorted(worst.items())},
                      "card": torch.cuda.get_device_name(dev) if "cuda" in dev else "cpu"}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
