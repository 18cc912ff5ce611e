"""The port imports no JAX, optax or orbax, directly or through varnet_tpu: not
when imported, not through Adam training, not through LM refinement, not through
the Fourier-feature causal curriculum and its LM polish."""

import os
import subprocess
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

SCRIPT = """
import sys
import varnet_tpu_torch
from varnet_tpu_torch import VarNet
from varnet_tpu_torch.ops import build, fused_residual, value_and_jac
from varnet_tpu_torch.train import gauss_newton
from varnet_tpu_torch.problems.analytic import transient_ad_2d
vn = VarNet(transient_ad_2d()["pde"], layer_width=(8, 8), disc_num=4, b_disc_num=4,
            t_disc_num=3, device="cpu")
vn.train(epoch_num=2, weight=(1.0, 10.0, 10.0), save_freq=2, verbose=False,
         error_disc=4, error_times=2)
for use_pallas in (True, False):
    vn.use_pallas = use_pallas
    vn.refine_lm(steps=1, weight=(1.0, 10.0, 10.0), cg_iters=2, k_chunks=2, precond=2,
                 verbose=False, error_disc=4, error_times=2)
from varnet_tpu_torch.examples import contaminant_2d
from varnet_tpu_torch.problems.analytic import contaminant_transport_2d
from varnet_tpu_torch.train.causal import train_causal
from varnet_tpu_torch.utils.io import CONTAMINANT_CAUSAL_FOURIER_B
ff, _ = train_causal(lambda t: contaminant_transport_2d(t_final=t)["pde"], windows=(0.5, 1.0),
                     epoch_num=2, weight=(1.0, 10.0, 10.0), t_disc_full=4, verbose=False,
                     varnet_kwargs=dict(layer_width=(8, 8), disc_num=4, b_disc_num=4,
                                        fourier_features=8, fourier_scale="0.5,2.0",
                                        device="cpu", input_scaling=False))
ff.refine_lm(steps=1, weight=(1.0, 10.0, 10.0), cg_iters=2, k_chunks=2, verbose=False)
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
