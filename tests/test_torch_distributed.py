"""The port's data-parallel training across two processes (gloo on the CPU).

Two subprocesses, which import no JAX, join one gloo group and run every scenario of
``tests/_torch_dist_runs.py`` (Adam with penalty BC and two mini-batches, exact BC
and flux rows; LM, also with Jacobi probes; L-BFGS; an ensemble) from the JAX
package's initial theta (the ensemble from the JAX package's members).  Their losses
are held to the JAX package's ``VarNet(..., n_devices=2)`` on two of the conftest's
host devices and to the port's own one-process run, in the bands of
``__graft_entry__.py::dryrun_multichip``: Adam and the ensemble rtol 2e-4, LM 2e-2;
L-BFGS's first 5 losses at rtol 1e-3 (as ``tests/test_torch_lbfgs.py``).  LM with
Jacobi probes draws on each rank the probes JAX draws on that shard; its reduced
diagonal is held to the sum over the ranks of mean((J_r^T z_r)^2), each rank's
slice computed here in one process, and the one-process run, whose own probes
would estimate another diagonal, is handed the ranks' estimates.  The wrapped ``torch.distributed.all_reduce`` counts the collectives: one
per Adam update and per ensemble step, 2 + cg_iters per LM iteration (plus one for
the starting loss), one per L-BFGS loss evaluation.  Last, an example CLI runs under
torchrun with ``--devices 2``.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import _torch_dist_runs as runs
from _torch_threads import _one_intra_op_thread  # noqa: F401
from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.problems import analytic as jax_analytic
from varnet_tpu.train.gauss_newton import _PROBE_KEY_SEED as _JAX_PROBE_KEY_SEED
from varnet_tpu_torch import api as port_api
from varnet_tpu_torch.parallel.mesh import Mesh
from varnet_tpu_torch.train import gauss_newton as gn
from varnet_tpu_torch.utils.io import save_theta_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "_torch_dist_runs.py")
BAND = {"adam_batch": 2e-4, "adam_hard": 2e-4, "adam_flux": 2e-4, "lm": 2e-2,
        "lm_precond": 2e-2, "lbfgs": 1e-3, "ensemble": 2e-4}


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    return env


def _rank_slices(theta_dir, name):
    """[(closure, flat)] for ranks 0 and 1: the port's LM residual slice of that
    two-shard mesh position and the starting parameters, built here without a
    group (every reduction the identity)."""
    captured = []

    def capture(closure, **kw):
        def step(state):
            captured.append((closure, state.flat))
            return state
        return step

    real, port_api.make_lm_step = port_api.make_lm_step, capture
    try:
        for rank in range(2):
            vn = runs.build(name, theta_dir)
            vn.mesh, vn.n_shards = Mesh(2, rank, None, torch.device("cpu")), 2
            vn.refine_lm(**{**runs.SCENARIOS[name][3], "steps": 1}, **runs.REPORT)
    finally:
        port_api.make_lm_step = real
    return captured


def _jax_shard_probes(theta_dir, name):
    """Store the probes JAX's sharded LM step draws on shards 0 and 1 (its key
    folded with the shard index) for the ranks to draw, and return sum over r
    of mean((J_r^T z_r)^2) at the start, each rank's slice computed here."""
    n_probes = runs.SCENARIOS[name][3]["precond"]
    diag = 0
    for rank, (closure, flat) in enumerate(_rank_slices(theta_dir, name)):
        r, pullback = gn.linearize(closure, flat)
        key = jax.random.fold_in(jax.random.PRNGKey(_JAX_PROBE_KEY_SEED), rank)
        z = np.array(jax.random.rademacher(key, (n_probes, r.shape[0]), dtype=np.float32))
        np.save(os.path.join(theta_dir, f"{name}_probes{rank}.npy"), z)
        diag = diag + gn._diag_probe_est(pullback, torch.from_numpy(z))
    return diag.numpy()


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{"two": rank -> scenario -> result, "one": scenario -> result of the port's
    one-process run, "jax": scenario -> JAX n_devices=2 losses, "diag": the
    ranks' first probe diagonal as computed here}."""
    theta_dir = tmp_path_factory.mktemp("dist")
    jax_runs = {}
    for name, (factory, vn_kw, method, call) in runs.SCENARIOS.items():
        jv = JaxVarNet(getattr(jax_analytic, factory)()["pde"], n_devices=2, **vn_kw)
        assert jv.n_shards == 2
        save_theta_npz(str(theta_dir / f"{name}.npz"),
                       jax.tree_util.tree_map(np.asarray, jv.theta))
        if method == "train_ensemble":   # the members JAX's train_ensemble draws
            keys = jax.random.split(jax.random.PRNGKey(jv.seed), call["n_members"])
            for i, k in enumerate(keys):
                save_theta_npz(str(theta_dir / f"{name}_member{i}.npz"),
                               jax.tree_util.tree_map(np.asarray, jv._init_theta(k)))
        jax_runs[name] = (jv, method, call)
    diag = _jax_shard_probes(str(theta_dir), "lm_precond")
    port = runs.free_port()
    procs = [subprocess.Popen([sys.executable, CHILD, str(rank), "2", port, str(theta_dir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=_env(), cwd=ROOT)
             for rank in range(2)]
    try:
        jax_losses = {name: runs.losses(getattr(jv, method)(**call, **runs.REPORT))
                      for name, (jv, method, call) in jax_runs.items()}
        one = {name: runs.run(name, str(theta_dir)) for name in runs.SCENARIOS
               if name != "lm_precond"}
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    two = {}
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-3000:]}"
        line = next(x for x in out.splitlines() if x.startswith("RESULT "))
        two[rank] = json.loads(line[len("RESULT "):])
    # one process's probes estimate the diagonal differently (no cross-rank
    # split of the rows), so its preconditioned run is given the ranks' estimates
    one["lm_precond"] = runs.run("lm_precond", str(theta_dir),
                                 diags=two[0]["lm_precond"]["diags"])
    return {"two": two, "one": one, "jax": jax_losses, "diag": diag}


def test_ranks_import_no_jax_and_agree_exactly(results):
    two = results["two"]
    assert not two[0].pop("jax_imported") and not two[1].pop("jax_imported")
    assert two[0] == two[1]   # the same reduced sums on both ranks, to the bit


@pytest.mark.parametrize("name", list(BAND))
def test_two_ranks_match_jax_and_one_process(results, name):
    got = np.asarray(results["two"][0][name]["losses"])
    one = np.asarray(results["one"][name]["losses"])
    ref = np.asarray(results["jax"][name])[:got.shape[0]]
    assert np.all(np.isfinite(got)) and got.shape == one.shape == ref.shape
    np.testing.assert_allclose(got, one, rtol=BAND[name])
    np.testing.assert_allclose(got, ref, rtol=BAND[name])


def test_lm_with_probes_runs_and_never_climbs(results):
    got = results["two"][0]["lm_precond"]["losses"]
    assert np.all(np.isfinite(got)) and got[1] <= got[0]


def test_lm_with_probes_reduces_the_ranks_probe_diagonals(results):
    """The diagonal estimate the two ranks floor at their first LM iteration is
    sum over r of mean((J_r^T z_r)^2), each rank's residual slice J_r and its
    probes z_r computed one after another in this process; the later
    iterations' estimates are their own (the parameters moved)."""
    diags = results["two"][0]["lm_precond"]["diags"]
    assert len(diags) == runs.SCENARIOS["lm_precond"][3]["steps"]
    got = np.asarray(diags[0], dtype=np.float32)
    assert got.shape == results["diag"].shape and np.all(got > 0)
    np.testing.assert_allclose(got, results["diag"], rtol=1e-6)
    assert not np.array_equal(diags[1], diags[0])


# scenario -> all-reduces the run must make
CENSUS = {
    "adam_batch": 10 * 2,       # epochs x mini-batches: one per update
    "adam_hard": 10,
    "adam_flux": 10,
    "ensemble": 5,              # one per ensemble step
    "lm": 1 + 2 * (2 + 5),      # the starting loss, then 2 + cg_iters per iteration
    "lm_precond": 1 + 2 * (2 + 4),
}


@pytest.mark.parametrize("name", list(CENSUS) + ["lbfgs"])
def test_collective_census(results, name):
    got = results["two"][0][name]
    if name == "lbfgs":
        assert got["grad"] >= 5 and got["all_reduce"] == got["grad"]   # one per evaluation
    else:
        assert got["all_reduce"] == CENSUS[name]
    assert results["one"][name]["all_reduce"] == 0   # no group: no collective


def test_cli_under_torchrun_two_ranks(tmp_path):
    """``torchrun --nproc_per_node 2 -m ...ad1d_steady --devices 2``: rank 0 alone
    prints the summary and writes the case folder; its loss is the one-process
    run's within the Adam band."""
    args = ["--epochs", "4", "--save-freq", "2", "--width", "6", "--layers", "1", "--disc",
            "6", "--bdisc", "4", "--device", "cpu"]
    two = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", "2", "-m", "varnet_tpu_torch.examples.ad1d_steady",
                          *args, "--devices", "2", "--folder", str(tmp_path / "case")],
                         cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert two.returncode == 0, two.stderr[-3000:]
    one = subprocess.run([sys.executable, "-m", "varnet_tpu_torch.examples.ad1d_steady", *args],
                         cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert one.returncode == 0, one.stderr[-3000:]
    summaries = [json.loads(x) for x in two.stdout.splitlines() if x.startswith("{")]
    assert len(summaries) == 1
    ref = [json.loads(x) for x in one.stdout.splitlines() if x.startswith("{")][0]
    np.testing.assert_allclose(summaries[0]["final_loss"], ref["final_loss"], rtol=2e-4)
    assert {"ckpt_0000000004", "train_result.json", "config.json"} <= set(
        os.listdir(tmp_path / "case"))
