#!/usr/bin/env python3
"""Where the time of K2-FF (``csrc/ff_mlp.cu``'s ``ff_fwd_kernel`` / ``ff_bwd_kernel`` in
the directional mode) goes, on one NVIDIA GPU, at the contaminant's full mesh as
``chip_smoke.py`` gives it (disc 64 / t_disc 40 / bdisc 64: P = 9,906,624; the pinned
w96x3 net behind 128 features; a seeded cotangent):

* the share of each phase of the forward and the backward (the backward on the engine
  its launcher takes there, ``bwd_wgmma_engine``: the wgmma engine's phases are the
  mma.sync engine's, with the same marks): a build with
  ``-DFF_PHASE_CLOCK``, in which thread 0 of every block sums the ``clock64()`` cycles of
  each phase of its walk; the shares are of the cycles summed over blocks.  Its
  gradient is checked bit-equal to the default build's, and its times are printed
  beside the default's (what the instrument costs);
* what the backward's two stand-ins for on-chip state cost: a build with
  ``-DFF_DW_NO_PARTIAL_ADDS`` (each dW unit added into one register instead of to the
  block's partial in device memory once per tile) and one with ``-DFF_DW0_STALE_EMB``
  (dW_0 reads the embedding slices left in shared memory instead of forming them
  again).  Their gradients are wrong: they time what the design pays, nothing else.

The builds start together.  Then the K2-FF backward of each build runs in turns
D N S C C S N D (default, no partial adds, stale embedding, clock) for 3 rounds in this
one process, each turn the median of 5 calls (CUDA events); the forward of the default
and the clock build likewise.  Prints the card's name and power limit, the phase
shares and each build's median and range over its turns, and last one JSON line (with
each build's ptxas registers and spills of the HP 96 kernels).  Names of builds as
arguments take those alone (the default and the clock build always: ``python3
scripts/ff_costs.py -`` runs those two).

    python3 scripts/ff_costs.py [no_partial_adds] [stale_emb]
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from varnet_tpu_torch.ops import build  # noqa: E402
from varnet_tpu_torch.ops import fused_residual as fr  # noqa: E402

ROUNDS, REPS = 3, 5
BUILDS = {"default": (), "no_partial_adds": ("FF_DW_NO_PARTIAL_ADDS",),
          "stale_emb": ("FF_DW0_STALE_EMB",), "clock": ("FF_PHASE_CLOCK",)}
FWD_PHASES = ["setup", "layer 0 (embedding formed per slice)", "hidden layers",
              "outputs and per-point results"]
BWD_PHASES = ["setup", "recompute layer 0 (embedding formed per slice)", "recompute hidden",
              "top epilogue", "dW_l units", "dW_l partial adds", "cotangent products",
              "epilogues", "dW_0 embedding formed again", "dW_0 units (and their barrier)",
              "dW_0 partial adds", "the small sums, once per block"]


def ptxas(defines):
    """ptxas' registers and spill loads of the tanh / sigmoid ff_fwd_kernel<3> and of both
    engines of ff_bwd_kernel<3> (HP 96; "<3,wgmma>" the wgmma engine) in a build's log."""
    out, name = {}, None
    for line in (build.build_dir(defines) / "build.log").read_text().splitlines():
        m = re.search(r"Compiling entry function "
                      r"'_Z\d+(ff_(?:fwd|bwd)_kernel)ILi3ELb0E(Lb([01])E)?", line)
        if m:
            name = m.group(1) + ("<3,wgmma>" if m.group(3) == "1" else "<3>")
        elif name and (m := re.search(r"(\d+) bytes spill loads", line)):
            out[f"{name} spill loads"] = int(m.group(1))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[f"{name} registers"] = int(m.group(1))
            name = None
    return out


def phase_shares(lib, fwd, bwd):
    """Run fwd and bwd 3 times each on the clock build; the share of each phase."""
    ticks = (ctypes.c_ulonglong * 64)()
    n_phase = ctypes.c_int(0)
    lib.ff_phase_ticks_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong),
                                        ctypes.POINTER(ctypes.c_int)]
    build.raise_on(lib.ff_phase_ticks_read(ticks, ctypes.byref(n_phase)), "ticks")
    out = {}
    for kind, fn, names in (("fwd", fwd, FWD_PHASES), ("bwd", bwd, BWD_PHASES)):
        for _ in range(3):
            fn()
        build.raise_on(lib.ff_phase_ticks_read(ticks, ctypes.byref(n_phase)), "ticks")
        row = ticks[(kind == "bwd") * n_phase.value:][:len(names)]
        total = sum(row)
        out[kind] = {name: v / total for name, v in zip(names, row)}
    return out


def main(argv=None):
    global BUILDS
    names = sys.argv[1:] if argv is None else argv
    if names:
        BUILDS = {k: v for k, v in BUILDS.items() if k in ("default", "clock", *names)}
    if not torch.cuda.is_available():
        raise SystemExit("needs an NVIDIA GPU")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with ThreadPoolExecutor(len(BUILDS)) as pool:
        libs = dict(zip(BUILDS, pool.map(fr.load_library, BUILDS.values())))

    vn = cs._contaminant(cs.CONT_FULL)
    theta = cs._pinned_ff()
    data = fr.prepare_residual_data(vn._to_device(vn.fixed.quad), None, None,
                                    time_dependent=True, has_react=vn.has_react, device="cuda",
                                    fourier_bt=vn.fourier_bt)
    gr = torch.randn(data.k, generator=torch.Generator().manual_seed(11)).cuda()
    stream = torch.cuda.current_stream().cuda_stream

    def fwd(name):
        return lambda: fr.kernel_ff_fwd(libs[name], theta, data, "tanh", stream)

    def bwd(name):
        return lambda: fr.kernel_ff_bwd(libs[name], theta, data, "tanh", gr, stream)

    (g_default, wg_default), (g_clock, wg_clock) = bwd("default")(), bwd("clock")()
    bit_equal = all(torch.equal(a[k], b[k]) for a, b in zip(g_default, g_clock) for k in "wb")
    shares = phase_shares(libs["clock"], fwd("clock"), bwd("clock"))

    order = list(BUILDS) + list(BUILDS)[::-1]
    bwd_ms = {name: [] for name in BUILDS}
    fwd_ms = {"default": [], "clock": []}
    for _ in range(ROUNDS):
        for name in order:
            bwd_ms[name].append(cs._median_ms(bwd(name), n=REPS, warmup=1))
        for name in ("default", "clock", "clock", "default"):
            fwd_ms[name].append(cs._median_ms(fwd(name), n=REPS, warmup=1))

    def summary(ms):
        return {"median": statistics.median(ms), "min": min(ms), "max": max(ms)}

    for kind, rows in shares.items():
        print(f"K2-FF {kind} phase shares (clock build):")
        for name, v in rows.items():
            print(f"  {100 * v:6.2f}%  {name}")
    out = {"k2ff_bwd_ms": {n: summary(v) for n, v in bwd_ms.items()},
           "k2ff_fwd_ms": {n: summary(v) for n, v in fwd_ms.items()},
           "phase_shares": shares, "clock_build_grad_bit_equal": bit_equal,
           "bwd_wgmma_engine": {"default": wg_default, "clock": wg_clock},
           "ptxas": {name: ptxas(defines) for name, defines in BUILDS.items()}}
    base = out["k2ff_bwd_ms"]["default"]["median"]
    for name in [b for b in BUILDS if b != "default"]:
        med = out["k2ff_bwd_ms"][name]["median"]
        print(f"K2-FF bwd {name}: {med:.4g} ms against {base:.4g} ({100 * (med / base - 1):+.2f}%)")
    print(json.dumps(out), flush=True)
    if not bit_equal:
        raise SystemExit("the clock build's gradient differs from the default build's")


if __name__ == "__main__":
    main()
