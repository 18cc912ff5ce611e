#!/usr/bin/env python3
"""How the card sweep's comparisons against f64 came out, from a JUnit XML report of
``tests/test_torch_cuda.py`` (the ``gates`` property that
``test_ff_tensor_core_kernels_match_plain`` keeps for every output row and gradient
leaf: error against the f64 plain version, the f32 plain version's own error, gate).

A comparison "falls back" where the f32 plain version is itself more than half the gate
from f64: it is then held to 3x that distance instead of the gate.  Prints the count of
comparisons and of fallbacks, each fallback, the largest error of the comparisons held
to the gate itself (as a share of the gate), and last the same as one JSON line.

    python3 -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py \\
        --junitxml=build/cuda.xml
    python3 scripts/gate_report.py build/cuda.xml
"""

import json
import sys
import xml.etree.ElementTree as ET


def main(path):
    checks, fallbacks = [], []
    for case in ET.parse(path).getroot().iter("testcase"):
        for prop in case.iter("property"):
            if prop.get("name") != "gates":
                continue
            for what, err, own, gate in json.loads(prop.get("value")):
                row = {"case": case.get("name"), "what": what, "err": err, "own": own,
                       "gate": gate}
                (fallbacks if own > gate / 2 else checks).append(row)
    if not checks and not fallbacks:
        raise SystemExit(f"{path}: no 'gates' properties")
    worst = max(checks, key=lambda r: r["err"] / r["gate"]) if checks else None
    print(f"{len(checks) + len(fallbacks)} comparisons in "
          f"{len({r['case'] for r in checks + fallbacks})} cases; "
          f"{len(fallbacks)} fell back to 3x the f32 plain version's distance")
    for r in fallbacks:
        print(f"  fallback {r['case']} {r['what']}: err {r['err']:.3e}, f32 plain {r['own']:.3e}, "
              f"gate {r['gate']:.0e}")
    if worst:
        print(f"largest against its gate: {worst['case']} {worst['what']}: err "
              f"{worst['err']:.3e} ({worst['err'] / worst['gate']:.3f} of {worst['gate']:.0e}), "
              f"f32 plain {worst['own']:.3e}")
    print(json.dumps({"comparisons": len(checks) + len(fallbacks), "fallbacks": fallbacks,
                      "largest_held_to_gate": worst}))


if __name__ == "__main__":
    main(sys.argv[1])
