#!/usr/bin/env python3
"""ptxas' report (registers, spills, stack, barriers) of every kernel in two builds of
the port's library, side by side.

Usage (on a machine with nvcc; builds each tree's ``csrc/`` with its own ``ops/build.py``,
both started together):

    python3 scripts/ptxas_diff.py build/parent .

or, with two ``build.log`` files of such builds (anywhere ``c++filt`` is):

    python3 scripts/ptxas_diff.py parent/build.log ours/build.log

Kernels are paired by their demangled names, with a trailing ``false`` template argument
(the tanh / sigmoid instantiation of a kernel that gained a sin flag) dropped, so an
unchanged kernel reads the same in both columns; kernels only one tree has (the sin
instantiations, ``..., true>``) are listed after.  Exit code 1 when a paired kernel's
report differs.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
from pathlib import Path

BUILD = ("import sys; sys.path.insert(0, '.'); from varnet_tpu_torch.ops import build; "
         "build.load_library(); print(build.build_dir() / 'build.log')")


def build_logs(trees):
    """Build each tree's library in a process of its own, all started together; the
    paths of their build logs."""
    procs = [subprocess.Popen([sys.executable, "-c", BUILD], cwd=tree, text=True,
                              stdout=subprocess.PIPE) for tree in trees]
    out = []
    for tree, proc in zip(trees, procs):
        text = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"build of {tree} failed")
        out.append(Path(tree) / text.strip().splitlines()[-1])
    return out


def demangle(names):
    tool = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if not Path(tool).exists():
        tool = shutil.which("c++filt")
    text = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True,
                          check=True).stdout
    return text.splitlines()


def report(log: Path) -> dict:
    """{demangled kernel: 'R regs, S spill st, L spill ld, F stack, B barriers'}."""
    entries, cur = {}, None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = m.group(1)
            entries[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m:
            entries[cur].update(stack=int(m.group(1)), spill_st=int(m.group(2)),
                                spill_ld=int(m.group(3)))
        m = re.search(r"Used (\d+) registers, used (\d+) barriers", line)
        if m:
            entries[cur].update(regs=int(m.group(1)), barriers=int(m.group(2)))
    names = list(entries)
    return {re.sub(r", (false|\(bool\)0)>", ">", d): entries[n]
            for n, d in zip(names, demangle(names))}


def main():
    trees = sys.argv[1:3]
    if len(trees) != 2:
        raise SystemExit(__doc__)
    logs = ([Path(t) for t in trees] if all(t.endswith(".log") for t in trees)
            else build_logs(trees))
    a, b = (report(log) for log in logs)
    fmt = "{regs} regs, {spill_st}/{spill_ld} B spill st/ld, {stack} B stack, {barriers} bar"
    changed = 0
    for name in sorted(set(a) & set(b)):
        same = a[name] == b[name]
        changed += not same
        print(f"{'same' if same else 'DIFF'}  {name[:110]}\n      {trees[0]}: "
              f"{fmt.format(**a[name])}\n      {trees[1]}: {fmt.format(**b[name])}")
    for tree, only in ((trees[0], set(a) - set(b)), (trees[1], set(b) - set(a))):
        for name in sorted(only):
            rep = (a if tree == trees[0] else b)[name]
            print(f"only {tree}: {name[:110]}\n      {fmt.format(**rep)}")
    print(f"paired {len(set(a) & set(b))} kernels, {changed} differ")
    sys.exit(1 if changed else 0)


if __name__ == "__main__":
    main()
