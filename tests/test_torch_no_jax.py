"""The port imports no JAX, optax or orbax, directly or through varnet_tpu: not
when imported, not through Adam training, not through LM refinement, not through
the Fourier-feature causal curriculum and its LM polish, not through exact-BC
Adam + LM, a test-space refinement and the obstacle CLI with ``--hard-bc``, nor
through viscous Burgers (Adam on K3's route, LM, ``test_residuals``) and the
``burgers_1d`` CLI with ``--hard-bc``, nor through checkpoints, resume and fault
recovery (``train`` / ``refine_lm`` with ``folderpath``, ``resume`` and
``max_retries``, ``load_model``, ``train_causal(resume=True)``, the improve-only
theta guard) and the CLIs added with them, with ``--folder`` and ``--resume``, nor
through the flux, observation and inverse rows (``neumann_2d`` with ``--hard-bc``,
``inverse_coeff --recover vel``, ``inverse_source`` with ``--folder`` and
``--resume``), nor through ensembles, L-BFGS, ``evaluate_grad``, the profiler and
NaN hooks, ``sim_res``, the classical solver and the ``--ensemble`` / ``--plot``
CLI flags, nor through the data-parallel layer (``parallel/mesh.py``: Adam with
mini-batches, an ensemble, LM with probes and L-BFGS under a one-rank gloo group)
and a float64 run."""

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
hv = VarNet(transient_ad_2d()["pde"], layer_width=(8, 8), disc_num=4, b_disc_num=4,
            t_disc_num=3, device="cpu", hard_bc=True)
hv.train(epoch_num=2, save_freq=2, verbose=False, error_disc=4, error_times=2)
hv.refine_lm(steps=1, cg_iters=2, k_chunks=2, verbose=False, error_disc=4, error_times=2)
hv.refine_tests(frac=0.2, verbose=False)
hv.train(epoch_num=1, save_freq=1, verbose=False, error_disc=4, error_times=2)
from varnet_tpu_torch.examples import obstacle_2d
obstacle_2d.main(["--hard-bc", "--width", "8", "--disc", "6", "--bdisc", "6", "--epochs", "2",
                  "--save-freq", "2", "--lm-steps", "1", "--lm-cg", "2", "--device", "cpu"])
from varnet_tpu_torch.examples import burgers_1d
from varnet_tpu_torch.problems.analytic import burgers_2d_front
bv = VarNet(burgers_2d_front()["pde"], layer_width=(8, 8), disc_num=4, b_disc_num=4,
            t_disc_num=3, device="cpu")
bv.train(epoch_num=2, weight=(1.0, 10.0, 10.0), save_freq=2, verbose=False, error_disc=4,
         error_times=2)
bv.refine_lm(steps=1, weight=(1.0, 10.0, 10.0), cg_iters=2, k_chunks=2, verbose=False,
             error_disc=4, error_times=2)
bv.test_residuals()
burgers_1d.main(["--hard-bc", "--width", "8", "--disc", "6", "--tdisc", "4", "--epochs", "2",
                 "--save-freq", "2", "--lm-steps", "1", "--lm-cg", "2", "--device", "cpu"])
import tempfile
from varnet_tpu_torch.train import checkpoint, fault
from varnet_tpu_torch.utils.io import load_observations_csv, persist_theta_if_better
tmp = tempfile.mkdtemp()
cv = VarNet(transient_ad_2d()["pde"], layer_width=(8, 8), disc_num=4, b_disc_num=4,
            t_disc_num=3, device="cpu")
cv.train(epoch_num=2, save_freq=1, folderpath=tmp + "/a", verbose=False, error_disc=4,
         error_times=2, max_retries=1)
cv.train(epoch_num=3, save_freq=1, folderpath=tmp + "/a", resume=True, verbose=False,
         error_disc=4, error_times=2)
cv.refine_lm(steps=1, cg_iters=2, folderpath=tmp + "/a", max_retries=1, verbose=False,
             error_disc=4, error_times=2)
cv.refine_lm(steps=2, cg_iters=2, folderpath=tmp + "/a", resume=True, verbose=False,
             error_disc=4, error_times=2)
cv.load_model(tmp + "/a")
fault.is_transient_device_error(RuntimeError("x"))
persist_theta_if_better(tmp + "/t.npz", cv.theta, 1e-3, verbose=False)
load_observations_csv("benchmarks/data/contaminant_inlet_fdm.csv")
train_causal(lambda t: contaminant_transport_2d(t_final=t)["pde"], windows=(0.5, 1.0),
             epoch_num=2, weight=(1.0, 10.0, 10.0), t_disc_full=4, verbose=False,
             folderpath=tmp + "/c", resume=True,
             varnet_kwargs=dict(layer_width=(8, 8), disc_num=4, b_disc_num=4, device="cpu"))
from varnet_tpu_torch.examples import (ad1d_steady, ad1d_transient, ad2d_steady,
                                       ad2d_transient, ad3d_prism, ad3d_steady, lshape_2d,
                                       mor_1d)
for cli, extra in ((mor_1d, ["--disc", "6"]), (ad3d_prism, ["--disc", "4", "--hard-bc"])):
    argv = ["--epochs", "2", "--save-freq", "1", "--width", "4", "--bdisc", "3",
            "--device", "cpu", "--folder", tmp + "/" + cli.__name__] + extra
    cli.main(argv)
    cli.main(argv[:1] + ["3"] + argv[2:] + ["--resume"])
from varnet_tpu_torch.examples import inverse_coeff, inverse_source, neumann_2d
tiny = ["--epochs", "2", "--save-freq", "1", "--width", "4", "--bdisc", "3", "--disc", "4",
        "--lm-steps", "1", "--lm-cg", "2", "--device", "cpu"]
neumann_2d.main(tiny + ["--hard-bc"])
inverse_coeff.main(tiny + ["--recover", "vel"])
argv = tiny + ["--n-obs", "16", "--folder", tmp + "/inv"]
inverse_source.main(argv)
inverse_source.main(argv[:1] + ["3"] + argv[2:] + ["--resume"])
ev = VarNet(transient_ad_2d()["pde"], layer_width=(8, 8), disc_num=4, b_disc_num=4,
            t_disc_num=3, device="cpu")
ev.train_ensemble(epoch_num=2, n_members=2, save_freq=2, verbose=False, error_disc=4,
                  error_times=2)
ev.evaluate_ensemble([[0.5, 0.5]], t=0.2)
for use_pallas in (True, False):
    ev.use_pallas = use_pallas
    ev.refine_lbfgs(steps=2, save_freq=2, verbose=False, error_disc=4, error_times=2)
    ev.evaluate_grad([[0.5, 0.5]], t=0.2)
hv.evaluate_grad([[0.5, 0.5]], t=0.2)
ev.train(epoch_num=3, save_freq=3, verbose=False, error_disc=4, error_times=2,
         profile_dir=tmp + "/prof", profile_steps=1, debug_nans=True, normalize_residual=False)
ev.sim_res(tmp + "/plots", disc=4, n_times=2)
from varnet_tpu_torch.problems import solve_ad_fdm_2d
solve_ad_fdm_2d(transient_ad_2d()["pde"], nx=6, ny=6, nt=4)
ad2d_transient.main(["--epochs", "2", "--save-freq", "1", "--width", "4", "--bdisc", "3",
                     "--disc", "4", "--tdisc", "3", "--ensemble", "2", "--plot", "--folder",
                     tmp + "/ens", "--device", "cpu"])
import torch
from varnet_tpu_torch.parallel import initialize_distributed
sys.path.insert(0, "tests")
from _torch_dist_runs import free_port
port = free_port()
assert initialize_distributed("gloo", f"tcp://localhost:{port}", world_size=1, rank=0) == 1
dv = VarNet(transient_ad_2d()["pde"], layer_width=(8, 8), disc_num=4, b_disc_num=4,
            t_disc_num=3, device="cpu", n_devices=1)
assert dv.mesh.distributed
dv.train(epoch_num=2, batch_num=2, save_freq=2, verbose=False, error_disc=4, error_times=2)
dv.train_ensemble(epoch_num=1, n_members=2, save_freq=1, verbose=False, error_disc=4,
                  error_times=2)
dv.refine_lm(steps=1, cg_iters=2, precond=2, verbose=False, error_disc=4, error_times=2)
dv.refine_lbfgs(steps=1, save_freq=1, verbose=False, error_disc=4, error_times=2)
torch.distributed.destroy_process_group()
VarNet(transient_ad_2d()["pde"], layer_width=(8, 8), disc_num=4, b_disc_num=4, t_disc_num=3,
       device="cpu", dtype=torch.float64).train(epoch_num=1, save_freq=1, verbose=False,
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
