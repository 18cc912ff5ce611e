"""Small training runs of the port, the same in one process and across ranks.

``tests/test_torch_distributed.py`` imports this module to run the scenarios in its
own process (no process group: the 1-process baseline) and starts it as a script,
once per rank, to run them under a gloo group::

    python tests/_torch_dist_runs.py <rank> <world> <port> <theta dir>

Each rank prints ``RESULT <json>``: per scenario the recorded losses and how many
``torch.distributed.all_reduce`` calls (counted through a wrapper) and loss
evaluations the run made, and an LM run's reduced probe diagonals.  Every
run starts from ``<theta dir>/<scenario>.npz``, the JAX package's initial theta
for that scenario (an ensemble's members from ``<scenario>_member<i>.npz``, the
JAX package's members).  This file imports no JAX.
"""

import json
import os
import socket
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from varnet_tpu_torch import VarNet  # noqa: E402
from varnet_tpu_torch.problems import analytic  # noqa: E402
from varnet_tpu_torch.train import gauss_newton  # noqa: E402
from varnet_tpu_torch.utils.io import load_theta_npz  # noqa: E402

TRANSIENT = dict(layer_width=(12, 12), disc_num=6, b_disc_num=4, t_disc_num=4)
W3 = (1.0, 10.0, 10.0)
REPORT = dict(verbose=False, error_disc=8, error_times=2)

# scenario -> (problem factory, VarNet keywords, method, call keywords)
SCENARIOS = {
    "adam_batch": ("transient_ad_2d", TRANSIENT, "train",
                   dict(epoch_num=10, batch_num=2, weight=W3, save_freq=1)),
    "adam_hard": ("transient_ad_1d", dict(layer_width=(10, 10), disc_num=8, b_disc_num=4,
                                          t_disc_num=4, hard_bc=True), "train",
                  dict(epoch_num=10, weight=W3, save_freq=1)),
    "adam_flux": ("steady_ad_1d_neumann", dict(layer_width=(12, 12), disc_num=6, b_disc_num=4),
                  "train", dict(epoch_num=10, weight=(1.0, 10.0), save_freq=1)),
    "lm": ("transient_ad_2d", TRANSIENT, "refine_lm",
           dict(steps=2, cg_iters=5, weight=W3, save_freq=1)),
    "lm_precond": ("transient_ad_2d", TRANSIENT, "refine_lm",
                   dict(steps=2, cg_iters=4, weight=W3, save_freq=1, precond=2)),
    "lbfgs": ("transient_ad_2d", TRANSIENT, "refine_lbfgs",
              dict(steps=5, weight=W3, save_freq=1)),
    "ensemble": ("transient_ad_2d", TRANSIENT, "train_ensemble",
                 dict(epoch_num=5, n_members=2, weight=W3, save_freq=1)),
}


def free_port():
    """A free TCP port on localhost for a process group's rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return str(s.getsockname()[1])


def build(name, theta_dir):
    """The scenario's VarNet on the CPU, from the stored JAX theta; an ensemble's
    members are the JAX package's, ``<theta dir>/<scenario>_member<i>.npz``."""
    factory, vn_kw, _, _ = SCENARIOS[name]
    vn = VarNet(getattr(analytic, factory)()["pde"], device="cpu", **vn_kw)
    vn.theta = vn._as_tensors(load_theta_npz(os.path.join(theta_dir, f"{name}.npz")))
    vn._init_member = lambda i: load_theta_npz(
        os.path.join(theta_dir, f"{name}_member{i}.npz"))
    return vn


def losses(result):
    """The loss record of a TrainResult or an EnsembleResult."""
    if hasattr(result, "member_losses"):
        return [list(map(float, row)) for row in result.member_losses]
    return [float(rec["loss"]) for rec in result.losses]


def run(name, theta_dir, diags=None):
    """Run one scenario: its losses, all_reduce calls and loss gradients taken,
    and the diag(J^T J) estimates an LM run with probes floors, one per
    iteration (under a group, the sum over the ranks of their probes' mean
    square).  A rank of a group whose ``<theta dir>/<scenario>_probes<rank>.npy``
    exists draws those probes (the JAX package's for its shard) in place of its
    own; ``diags`` (another run's estimates) replaces this run's, in order."""
    vn = build(name, theta_dir)
    _, _, method, call = SCENARIOS[name]
    counts = {"all_reduce": 0, "grad": 0}
    seen = []
    dist_all_reduce, autograd_grad = torch.distributed.all_reduce, torch.autograd.grad
    floor_diag, probes = gauss_newton._floor_diag, gauss_newton.rademacher_probes
    given = None
    if torch.distributed.is_initialized():
        path = os.path.join(theta_dir, f"{name}_probes{torch.distributed.get_rank()}.npy")
        given = np.load(path) if os.path.exists(path) else None

    def recorded_floor(diag):
        if diags is not None:
            diag = torch.tensor(diags[len(seen)], dtype=diag.dtype)
        seen.append(diag.tolist())
        return floor_diag(diag)

    def given_probes(n_probes, n_r, dtype=torch.float32, device=None, rank=0):
        assert given.shape == (n_probes, n_r), (given.shape, n_probes, n_r)
        return torch.from_numpy(given).to(dtype=dtype, device=device)

    def counted_all_reduce(*a, **k):
        counts["all_reduce"] += 1
        return dist_all_reduce(*a, **k)

    def counted_grad(*a, **k):
        counts["grad"] += 1
        return autograd_grad(*a, **k)

    torch.distributed.all_reduce, torch.autograd.grad = counted_all_reduce, counted_grad
    gauss_newton._floor_diag = recorded_floor
    if given is not None:
        gauss_newton.rademacher_probes = given_probes
    try:
        result = getattr(vn, method)(**call, **REPORT)
    finally:
        torch.distributed.all_reduce, torch.autograd.grad = dist_all_reduce, autograd_grad
        gauss_newton._floor_diag, gauss_newton.rademacher_probes = floor_diag, probes
    return {"losses": losses(result), "diags": seen, **counts}


def main(rank, world, port, theta_dir):
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                                         world_size=world, rank=rank)
    try:
        out = {name: run(name, theta_dir) for name in SCENARIOS}
        out["jax_imported"] = any(m in ("jax", "varnet_tpu")
                                  or m.startswith(("jax.", "varnet_tpu.")) for m in sys.modules)
        print("RESULT " + json.dumps(out), flush=True)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
