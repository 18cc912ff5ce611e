"""The port imports no JAX, optax or orbax, directly or through varnet_tpu."""

import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

SCRIPT = """
import sys
import varnet_tpu_torch
from varnet_tpu_torch import VarNet
from varnet_tpu_torch.ops import fused_residual
from varnet_tpu_torch.problems.analytic import transient_ad_2d
vn = VarNet(transient_ad_2d()["pde"], layer_width=(8, 8), disc_num=4, b_disc_num=4,
            t_disc_num=3, device="cpu")
vn.train(epoch_num=2, weight=(1.0, 10.0, 10.0), save_freq=2, verbose=False,
         error_disc=4, error_times=2)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "optax", "orbax", "varnet_tpu"))
print("IMPORTED:", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax():
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORTED: []" in proc.stdout
