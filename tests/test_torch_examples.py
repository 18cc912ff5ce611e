"""The port's eleven example CLIs (``varnet_tpu_torch/examples``) on the CPU.

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

import numpy as np
import pytest

import varnet_tpu.examples.common as jax_common
from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.train.trainer import TrainResult as JaxTrainResult

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
}
NEW = ("ad1d_steady", "ad1d_transient", "ad2d_steady", "ad2d_transient", "ad3d_steady",
       "ad3d_prism", "lshape_2d", "mor_1d")


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
def test_unported_flags_name_their_feature(flag, feature):
    from varnet_tpu_torch.examples import ad1d_steady

    with pytest.raises(SystemExit, match=feature):
        ad1d_steady.main(TINY + ["--disc", "6", "--device", "cpu"] + flag)


class _Untrained(JaxVarNet):
    """The JAX CLI's VarNet without its training (only the fixed data is compared)."""

    def train(self, *args, **kw):
        self.train_result = JaxTrainResult()
        return self.train_result


@pytest.mark.parametrize("name", NEW)
def test_cli_fixed_data_matches_jax(name, monkeypatch):
    import importlib

    args = TINY + CLIS[name] + ["--devices", "1"]
    port = importlib.import_module(f"varnet_tpu_torch.examples.{name}").main(
        args + ["--device", "cpu"])
    monkeypatch.setattr(jax_common, "VarNet", _Untrained)
    ref = importlib.import_module(f"varnet_tpu.examples.{name}").main(args)
    assert port.layer_width == tuple(ref.layer_width)
    for part in ("quad", "bc", "ic"):
        ours, theirs = getattr(port.fixed, part), getattr(ref.fixed, part)
        assert (ours is None) == (theirs is None), part
        if ours is None:
            continue
        for field, a, b in zip(ours._fields, ours, theirs):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=f"{name}: {part}.{field}")
    assert port.config_dict() == json.loads(json.dumps(ref.config_dict()))
