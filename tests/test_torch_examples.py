"""The port's fourteen example CLIs (``varnet_tpu_torch/examples``) on the CPU.

Each runs end to end with ``--device cpu`` at a tiny size in a subprocess, as a
user would call it (the counterpart of ``tests/test_examples.py``);
``--folder`` writes its checkpoints, meta sidecars, ``config.json``, the training
log and the result, and ``--resume`` continues toward the TOTAL ``--epochs``
(a no-op once they are done).  For each CLI this slice adds, the fixed data of
the ``VarNet`` it builds is bit-equal to the one the JAX package's CLI builds for
the same arguments."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import varnet_tpu.examples.common as jax_common
from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.train.trainer import TrainResult as JaxTrainResult
from varnet_tpu_torch.models.mlp import params_to_numpy

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
TINY = ["--epochs", "2", "--save-freq", "2", "--width", "8", "--layers", "2",
        "--bdisc", "4"]

CLIS = {
    "ad1d_steady": ["--disc", "12"],
    "ad1d_transient": ["--disc", "8", "--tdisc", "4"],
    "ad2d_steady": ["--disc", "6"],
    "ad2d_transient": ["--disc", "5", "--tdisc", "3"],
    "ad3d_steady": ["--disc", "3", "--bdisc", "3"],
    "ad3d_prism": ["--disc", "4", "--bdisc", "3", "--hard-bc"],
    "lshape_2d": ["--disc", "6"],
    "mor_1d": ["--disc", "8", "--vels", "0.5,1.0"],
    "obstacle_2d": ["--disc", "6", "--hard-bc", "--lm-steps", "1", "--lm-cg", "2"],
    "burgers_1d": ["--disc", "6", "--tdisc", "3"],
    "contaminant_2d": ["--disc", "5", "--tdisc", "3", "--volumetric-source", "--causal",
                       "2", "--ff", "4"],
    "neumann_2d": ["--disc", "6", "--lm-steps", "1", "--lm-cg", "2"],
    "inverse_source": ["--disc", "6", "--n-obs", "25", "--lm-steps", "1", "--lm-cg", "2"],
    "inverse_coeff": ["--disc", "8", "--lm-steps", "1", "--lm-cg", "2"],
}
NEW = ("ad1d_steady", "ad1d_transient", "ad2d_steady", "ad2d_transient", "ad3d_steady",
       "ad3d_prism", "lshape_2d", "mor_1d", "neumann_2d", "inverse_source", "inverse_coeff")


def _run(name, args, timeout=240):
    proc = subprocess.run(
        [sys.executable, "-m", f"varnet_tpu_torch.examples.{name}", *args, "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def _summary(out):
    """The CLI's JSON summary line (mor_1d prints its per-sample scores after it)."""
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


@pytest.mark.parametrize("name", list(CLIS))
def test_cli_runs(name):
    out = _run(name, TINY + CLIS[name])
    summary = _summary(out)
    assert summary, out
    first = summary[0]
    loss = first.get("final_loss") or first.get("stage_losses")[-1]
    assert np.all(np.isfinite(loss))
    if name == "mor_1d":
        assert set(summary[1]["per_sample_rel_l2"]) == {"0.5", "1.0"}
        assert set(summary[1]["holdout_rel_l2"]) == {"0.75"}
    if name == "inverse_source":
        assert np.isfinite(summary[1]["source_rel_l2"])
    if name == "inverse_coeff":
        assert summary[1]["recover"] == "kappa" and np.isfinite(summary[1]["recovered"])


def test_cli_folder_and_resume(tmp_path):
    """--folder writes the case folder; --resume toward a larger total picks up
    at the newest checkpoint; with the budget met it is a no-op."""
    folder = str(tmp_path / "case")
    base = ["--save-freq", "20", "--width", "8", "--disc", "5", "--tdisc", "3",
            "--bdisc", "4", "--folder", folder]
    _run("ad2d_transient", ["--epochs", "40"] + base)
    names = set(os.listdir(folder))
    assert {"config.json", "train_log.jsonl", "train_result.json"} <= names
    assert sorted(n for n in names if n.startswith("ckpt_") and not n.endswith(".json")) == [
        f"ckpt_{s:010d}" for s in (20, 40)]
    assert {f"ckpt_{s:010d}.meta.json" for s in (20, 40)} <= names
    with open(os.path.join(folder, "train_log.jsonl")) as f:
        assert [json.loads(line)["epoch"] for line in f] == [20, 40]

    out = _run("ad2d_transient", ["--epochs", "60", "--resume"] + base)
    assert "resumed from epoch 40" in out
    assert json.load(open(os.path.join(folder, "train_result.json")))["epochs"] == [60]
    out = _run("ad2d_transient", ["--epochs", "60", "--resume"] + base)
    assert "already complete" in out
    assert json.load(open(os.path.join(folder, "train_result.json")))["epochs"] == [60]


def test_cli_resume_needs_folder():
    proc = subprocess.run(
        [sys.executable, "-m", "varnet_tpu_torch.examples.ad1d_steady", *TINY, "--disc", "6",
         "--resume", "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=240)
    assert proc.returncode != 0 and "requires folderpath" in proc.stderr


@pytest.mark.parametrize("flag,feature", [(["--ensemble", "2"], "train_ensemble"),
                                          (["--plot"], "sim_res"),
                                          (["--devices", "2"], "multi-device")])
def test_unported_flags_name_their_feature(flag, feature, monkeypatch, tmp_path):
    """The flags the port once refused: ``--ensemble`` and ``--plot`` now reach
    their feature (``train_ensemble``, ``sim_res``); ``--devices`` above 1 runs
    under torchrun (``tests/test_torch_distributed.py``), and without torchrun's
    environment exits with the torchrun command that starts it."""
    from varnet_tpu_torch.examples import ad1d_steady

    argv = TINY + ["--disc", "6", "--device", "cpu", "--folder", str(tmp_path)] + flag
    if feature == "multi-device":
        monkeypatch.delenv("WORLD_SIZE", raising=False)
        with pytest.raises(SystemExit, match=f"{feature}.*torchrun --nproc_per_node 2 -m "
                                             r"varnet_tpu_torch\.examples\..* --devices 2"):
            ad1d_steady.main(argv)
        return
    from varnet_tpu_torch import VarNet

    called, original = [], getattr(VarNet, feature)
    monkeypatch.setattr(VarNet, feature,
                        lambda self, *a, **kw: called.append(feature) or original(self, *a, **kw))
    ad1d_steady.main(argv)
    assert called == [feature]


def test_cli_ensemble_and_plot(tmp_path, capsys):
    """``--ensemble 2`` prints the JAX runner's summary keys and ``--plot
    --folder`` writes the solution plots; ``--ensemble`` with ``--resume`` exits
    with the JAX runner's message."""
    from varnet_tpu_torch.examples import ad1d_steady, ad2d_transient

    folder = str(tmp_path / "case")
    vn = ad2d_transient.main(TINY + ["--disc", "5", "--tdisc", "3", "--ensemble", "2",
                                     "--plot", "--folder", folder, "--device", "cpu"])
    summary = _summary(capsys.readouterr().out)[0]
    assert set(summary) == {"best_rel_l2", "best_member", "member_rel_l2", "final_loss",
                            "quad_evals_per_sec", "steps_per_sec"}
    assert len(summary["member_rel_l2"]) == 2 and np.isfinite(summary["final_loss"])
    assert summary["best_member"] in (0, 1) and vn._ensemble_thetas is not None
    assert {"sol_anim.gif", "error_table.json"} <= set(os.listdir(folder))
    with pytest.raises(SystemExit, match="--ensemble does not support --resume"):
        ad1d_steady.main(TINY + ["--disc", "6", "--ensemble", "2", "--resume", "--folder",
                                 folder, "--device", "cpu"])


class _Untrained(JaxVarNet):
    """The JAX CLI's VarNet without its training (only the fixed data is compared)."""

    def train(self, *args, **kw):
        self.train_result = JaxTrainResult()
        return self.train_result

    def refine_lm(self, *args, **kw):
        return self.train(*args, **kw)


@pytest.mark.parametrize("name", NEW)
def test_cli_fixed_data_matches_jax(name, monkeypatch):
    import importlib

    args = TINY + CLIS[name] + ["--devices", "1"]
    port = importlib.import_module(f"varnet_tpu_torch.examples.{name}").main(
        args + ["--device", "cpu"])
    monkeypatch.setattr(jax_common, "VarNet", _Untrained)
    ref = importlib.import_module(f"varnet_tpu.examples.{name}").main(args)
    assert port.layer_width == tuple(ref.layer_width)
    parts = [(part, getattr(port.fixed, part), getattr(ref.fixed, part))
             for part in ("quad", "bc", "ic", "neu")]
    parts.append(("obs_data", port.obs_data, ref.obs_data))
    for part, ours, theirs in parts:
        assert (ours is None) == (theirs is None), part
        if ours is None:
            continue
        for field, a, b in zip(ours._fields, ours, theirs):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{name}: {part}.{field}")
    assert port.config_dict() == json.loads(json.dumps(ref.config_dict()))
    # an inverse problem's theta: the same leaves, in the same ravel order
    assert jax.tree_util.tree_structure(params_to_numpy(port.theta)) == (
        jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, ref.theta)))
