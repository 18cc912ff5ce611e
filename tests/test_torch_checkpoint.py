"""The port's checkpoints (``varnet_tpu_torch/train/checkpoint.py``) and resume
against the JAX package's on the CPU: the round trip and global-epoch resume
(``tests/test_trainer.py::test_checkpoint_roundtrip``), keep-3 pruning and the
params-only restore across optimizers (``tests/test_checkpoint_extra.py``), the
no-op resume, a card-written state loading on the CPU, the clear error on an
Orbax folder, a run cut at N/2 and resumed equal to the uninterrupted run bit
for bit, ``config.json`` key for key equal to the JAX package's, a run resumed in
both packages (checkpoint steps equal, theta within the Adam band rtol 2e-4), and
the improve-only theta guard (``tests/test_persist_guard.py``) reading the other
package's sidecar both ways."""

import io
import json
import os
import warnings

import jax
import numpy as np
import pytest
import torch

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.problems import analytic as jax_analytic
from varnet_tpu.train import checkpoint as jax_checkpoint
from varnet_tpu.train.optim import OptimizerConfig as JaxOptimizerConfig
from varnet_tpu.utils import io as jax_io
from varnet_tpu_torch import OptimizerConfig, VarNet, params_from_jax
from varnet_tpu_torch.problems import analytic
from varnet_tpu_torch.train import checkpoint as ckpt
from varnet_tpu_torch.train.checkpoint import (
    ForeignCheckpointError,
    list_checkpoint_steps,
    load_checkpoint,
    load_meta,
)
from varnet_tpu_torch.utils import io as port_io
from _torch_threads import _one_intra_op_thread  # noqa: F401


STEADY = dict(layer_width=(8, 8), disc_num=12, device="cpu")
TRAIN = dict(weight=(1.0, 1.0), verbose=False, error_disc=16)


def _flat(theta):
    return np.concatenate([np.ravel(np.asarray(layer[k])) for layer in theta
                           for k in ("w", "b")])


def _steady(**kw):
    return VarNet(analytic.steady_ad_1d(kappa=0.2)["pde"], **{**STEADY, **kw})


def test_checkpoint_roundtrip(tmp_path):
    folder = str(tmp_path)
    vn = _steady()
    vn.train(epoch_num=50, save_freq=25, folderpath=folder, **TRAIN)
    vn2 = _steady()
    assert vn2.load_model(folder) == 50
    np.testing.assert_array_equal(_flat(vn2.theta), _flat(vn.theta))
    assert vn2.opt_state["name"] == "adam" and vn2.opt_state["count"] == 50
    # resume continues from the checkpointed epoch toward the TOTAL budget
    res = vn2.train(epoch_num=75, save_freq=25, folderpath=folder, resume=True, **TRAIN)
    assert res.epochs == [75]
    # budget met: a no-op that restores the newest checkpoint's theta
    res2 = vn2.train(epoch_num=75, save_freq=25, folderpath=folder, resume=True, **TRAIN)
    assert res2.epochs == []
    theta75 = _flat(vn2.theta)
    assert vn2.load_model(folder) == 75
    np.testing.assert_array_equal(_flat(vn2.theta), theta75)
    with pytest.raises(ValueError, match="mismatch"):
        _steady(layer_width=(8, 4)).load_model(folder)
    assert load_meta(folder, 75) == {"seed": 0}


def test_checkpoint_pruning_keeps_latest_three(tmp_path):
    _steady(layer_width=(8,)).train(epoch_num=100, save_freq=20, folderpath=str(tmp_path),
                                    **TRAIN)
    assert list_checkpoint_steps(str(tmp_path)) == [60, 80, 100]
    metas = sorted(n for n in os.listdir(tmp_path) if n.endswith(".meta.json"))
    assert metas == [f"ckpt_{s:010d}.meta.json" for s in (60, 80, 100)]


def test_params_only_restore_across_optimizers(tmp_path):
    vn = _steady(layer_width=(8,), optimizer=OptimizerConfig(lr=1e-3, decay_rate=0.5,
                                                             decay_steps=10))
    vn.train(epoch_num=20, save_freq=10, folderpath=str(tmp_path), **TRAIN)
    vn2 = _steady(layer_width=(8,), optimizer=OptimizerConfig(name="rmsprop"))
    with pytest.warns(UserWarning, match="restored parameters only"):
        vn2.load_model(str(tmp_path))
    np.testing.assert_array_equal(_flat(vn2.theta), _flat(vn.theta))
    assert vn2.opt_state["name"] == "rmsprop"
    # and a resume under the other optimizer continues from theta with a fresh state
    with pytest.warns(UserWarning, match="restored parameters only"):
        res = vn2.train(epoch_num=25, save_freq=5, folderpath=str(tmp_path), resume=True,
                        **TRAIN)
    assert res.epochs == [25]


def test_noop_resume_leaves_the_folder_alone(tmp_path):
    folder = str(tmp_path)
    vn = _steady()
    vn.train(epoch_num=20, save_freq=10, folderpath=folder, **TRAIN)
    before = {n: (tmp_path / n).stat().st_mtime_ns for n in os.listdir(folder)}
    result = (tmp_path / "train_result.json").read_text()
    vn2 = _steady(seed=5)
    assert vn2.train(epoch_num=20, save_freq=10, folderpath=folder, resume=True,
                     **TRAIN).epochs == []
    np.testing.assert_array_equal(_flat(vn2.theta), _flat(vn.theta))
    assert {n: (tmp_path / n).stat().st_mtime_ns for n in os.listdir(folder)} == before
    assert (tmp_path / "train_result.json").read_text() == result


def test_resume_requires_folderpath():
    with pytest.raises(ValueError, match="folderpath"):
        _steady().train(epoch_num=2, resume=True, **TRAIN)


def test_corrupt_checkpoint_raises(tmp_path):
    folder = str(tmp_path)
    _steady().train(epoch_num=4, save_freq=4, folderpath=folder, **TRAIN)
    (tmp_path / f"ckpt_{4:010d}" / ckpt.STATE_FILE).write_bytes(b"not a checkpoint")
    with pytest.raises(Exception) as info:
        _steady().load_model(folder)
    assert "restored parameters only" not in str(info.value)


def test_interrupted_save_leaves_the_newest_complete_checkpoint(tmp_path, monkeypatch):
    """A crash inside torch.save of step 8 leaves step 4 the newest, readable."""
    folder = str(tmp_path)
    vn = _steady()
    vn.train(epoch_num=4, save_freq=4, folderpath=folder, **TRAIN)
    theta4 = _flat(vn.theta)

    def crash(*args, **kw):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", crash)
    with pytest.raises(OSError, match="disk full"):
        vn.train(epoch_num=8, save_freq=4, folderpath=folder, resume=True, **TRAIN)
    monkeypatch.undo()
    assert list_checkpoint_steps(folder) == [4]
    assert _steady().load_model(folder) == 4
    vn2 = _steady()
    vn2.load_model(folder)
    np.testing.assert_array_equal(_flat(vn2.theta), theta4)


def test_card_written_state_loads_on_the_cpu(tmp_path):
    """A state whose storages are tagged for the card (as ``torch.save``
    writes tensors that live there) loads on the CPU through ``map_location``;
    without it torch refuses on a machine without a card."""
    folder = str(tmp_path)
    vn = _steady()
    vn.train(epoch_num=4, save_freq=4, folderpath=folder, **TRAIN)
    state_file = tmp_path / f"ckpt_{4:010d}" / ckpt.STATE_FILE
    state = torch.load(state_file, weights_only=True)

    def tag_cuda(obj):
        return "cuda:0" if getattr(obj, "device", None) == torch.device("cpu") else None

    torch.serialization.register_package(-1, tag_cuda, lambda obj, loc: None)
    try:
        buf = io.BytesIO()
        torch.save(state, buf)
    finally:
        torch.serialization._package_registry[:] = [
            entry for entry in torch.serialization._package_registry
            if entry[1] is not tag_cuda]
    state_file.write_bytes(buf.getvalue())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            torch.load(state_file, weights_only=True)
    vn2 = _steady()
    assert vn2.load_model(folder) == 4
    assert all(v.device.type == "cpu" for layer in vn2.theta for v in layer.values())
    np.testing.assert_array_equal(_flat(vn2.theta), _flat(vn.theta))


def test_orbax_folder_raises_a_clear_error(tmp_path):
    """A folder of the JAX package's Orbax checkpoints: the port says it cannot
    read it and names the npz route, in load_model and in a resume."""
    jvn = JaxVarNet(jax_analytic.steady_ad_1d(kappa=0.2)["pde"], layer_width=(8, 8),
                    disc_num=12, n_devices=1)
    jvn.train(epoch_num=2, save_freq=2, folderpath=str(tmp_path), **TRAIN)
    assert jax_checkpoint.list_checkpoint_steps(str(tmp_path)) == [2]
    with pytest.raises(ForeignCheckpointError, match="load_theta_npz"):
        _steady().load_model(str(tmp_path))
    with pytest.raises(ForeignCheckpointError, match="Orbax"):
        _steady().train(epoch_num=4, save_freq=2, folderpath=str(tmp_path), resume=True,
                        **TRAIN)


@pytest.mark.parametrize("opt", [OptimizerConfig(lr=2e-3, decay_rate=0.3, decay_steps=7),
                                 OptimizerConfig(name="rmsprop", lr=1e-3)],
                         ids=["adam_decay", "rmsprop"])
def test_cut_and_resumed_equals_uninterrupted_bit_for_bit(tmp_path, opt):
    """Adam's count and slots, RMSProp's nu and the schedule's step all cross
    the checkpoint: 20 epochs + a resume to 40 in a fresh VarNet equal 40
    epochs straight, to the bit, the loss history of the second half too."""
    kw = dict(layer_width=(8, 8), disc_num=4, b_disc_num=4, t_disc_num=3, device="cpu",
              optimizer=opt)
    pde = analytic.transient_ad_2d()["pde"]
    tk = dict(weight=(1.0, 10.0, 10.0), save_freq=10, verbose=False, error_disc=4,
              error_times=2)
    full = VarNet(pde, **kw)
    r_full = full.train(epoch_num=40, folderpath=str(tmp_path / "full"), **tk)
    VarNet(pde, **kw).train(epoch_num=20, folderpath=str(tmp_path / "cut"), **tk)
    resumed = VarNet(pde, **kw)
    r_res = resumed.train(epoch_num=40, folderpath=str(tmp_path / "cut"), resume=True, **tk)
    np.testing.assert_array_equal(_flat(resumed.theta), _flat(full.theta))
    assert r_res.epochs == [30, 40]
    assert r_res.losses == r_full.losses[2:]
    assert list_checkpoint_steps(str(tmp_path / "cut")) == [20, 30, 40]


PROBLEMS = {
    "transient_2d": ("transient_ad_2d", dict(layer_width=(8, 8), disc_num=6, b_disc_num=4,
                                             t_disc_num=3)),
    "steady_1d_order2": ("steady_ad_1d", dict(layer_width=(6,), disc_num=8, test_order=2,
                                              integ_p_num=3)),
    "lshape_hard": ("lshape_manufactured_2d", dict(layer_width=(8,), disc_num=6,
                                                   b_disc_num=6, hard_bc=True)),
}


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_config_json_matches_jax_key_for_key(tmp_path, name):
    factory, kw = PROBLEMS[name]
    port = VarNet(getattr(analytic, factory)()["pde"], device="cpu", **kw)
    port.train(epoch_num=1, save_freq=1, folderpath=str(tmp_path), verbose=False,
               error_disc=4, error_times=2)
    ref = JaxVarNet(getattr(jax_analytic, factory)()["pde"], n_devices=1, **kw)
    written = json.loads((tmp_path / "config.json").read_text())
    assert written == ckpt.load_config(str(tmp_path))
    assert written == json.loads(json.dumps(ref.config_dict()))


def test_resume_matches_jax(tmp_path):
    """Both packages train 20 epochs from the same theta, then a fresh VarNet of
    each resumes to 40: the same checkpoint steps, theta within rtol 2e-4."""
    mesh = dict(layer_width=(12, 12), disc_num=6, b_disc_num=4, t_disc_num=3)
    tk = dict(weight=(1.0, 10.0, 10.0), save_freq=20, verbose=False, error_disc=4,
              error_times=2)
    jkw = dict(n_devices=1, optimizer=JaxOptimizerConfig(lr=2e-3, decay_rate=0.5,
                                                         decay_steps=15), **mesh)
    pkw = dict(device="cpu", optimizer=OptimizerConfig(lr=2e-3, decay_rate=0.5,
                                                       decay_steps=15), **mesh)
    jpde, pde = jax_analytic.transient_ad_2d()["pde"], analytic.transient_ad_2d()["pde"]
    jvn = JaxVarNet(jpde, **jkw)
    theta0 = jax.tree_util.tree_map(np.asarray, jvn.theta)
    jfolder, pfolder = str(tmp_path / "jax"), str(tmp_path / "port")
    jvn.train(epoch_num=20, folderpath=jfolder, **tk)
    port = VarNet(pde, **pkw)
    port.theta = params_from_jax(theta0)
    port.train(epoch_num=20, folderpath=pfolder, **tk)

    jres = JaxVarNet(jpde, **jkw)
    jres.train(epoch_num=40, folderpath=jfolder, resume=True, **tk)
    pres = VarNet(pde, **pkw)
    pres.train(epoch_num=40, folderpath=pfolder, resume=True, **tk)
    assert list_checkpoint_steps(pfolder) == jax_checkpoint.list_checkpoint_steps(jfolder)
    assert list_checkpoint_steps(pfolder) == [20, 40]
    jt = _flat(jax.tree_util.tree_map(np.asarray, jres.theta))
    np.testing.assert_allclose(_flat(pres.theta), jt, rtol=2e-4,
                               atol=2e-4 * float(np.abs(jt).max()))
    assert ckpt.load_config(pfolder) == json.loads(
        json.dumps(jax_checkpoint.load_config(jfolder)))


def _theta(val):
    return [{"w": np.full((2, 3), val, np.float32), "b": np.zeros((3,), np.float32)}]


def _side(tmp_path):
    return json.loads((tmp_path / "theta_x.npz.score.json").read_text())


def test_first_write_creates_file_and_sidecar(tmp_path):
    p = tmp_path / "theta_x.npz"
    assert port_io.persist_theta_if_better(p, _theta(1.0), 1e-3, verbose=False)
    assert p.exists() and _side(tmp_path)["rel_l2"] == 1e-3


def test_worse_or_equal_score_refused(tmp_path):
    p = tmp_path / "theta_x.npz"
    port_io.persist_theta_if_better(p, _theta(1.0), 1e-3, verbose=False)
    assert not port_io.persist_theta_if_better(p, _theta(2.0), 5e-3, verbose=False)
    assert port_io.load_theta_npz(p)[0]["w"][0, 0] == 1.0
    assert _side(tmp_path)["rel_l2"] == 1e-3
    assert not port_io.persist_theta_if_better(p, _theta(3.0), 1e-3, verbose=False)


def test_better_score_overwrites(tmp_path):
    p = tmp_path / "theta_x.npz"
    port_io.persist_theta_if_better(p, _theta(1.0), 1e-3, verbose=False, note="first")
    assert port_io.persist_theta_if_better(p, _theta(2.0), 1e-4, verbose=False, note="2nd")
    assert port_io.load_theta_npz(p)[0]["w"][0, 0] == 2.0
    side = _side(tmp_path)
    assert side["rel_l2"] == 1e-4 and side["note"] == "2nd" and "date" in side


def test_legacy_file_without_sidecar_refused(tmp_path, monkeypatch):
    p = tmp_path / "theta_x.npz"
    port_io.save_theta_npz(p, _theta(1.0))
    assert not port_io.persist_theta_if_better(p, _theta(2.0), 1e-9, verbose=False)
    assert port_io.load_theta_npz(p)[0]["w"][0, 0] == 1.0
    monkeypatch.setenv("VARNET_FORCE_THETA", "1")
    assert port_io.persist_theta_if_better(p, _theta(2.0), 1e-9, verbose=False)
    assert port_io.load_theta_npz(p)[0]["w"][0, 0] == 2.0


def test_custom_write_fn(tmp_path):
    p = tmp_path / "theta_pair.npz"
    called = []
    assert port_io.persist_theta_if_better(
        p, None, 1e-3, verbose=False,
        write_fn=lambda pth: (called.append(pth), np.savez(pth, a=np.zeros(2)))[-1])
    assert called and os.path.exists(p)
    assert json.loads((tmp_path / "theta_pair.npz.score.json").read_text())["rel_l2"] == 1e-3


@pytest.mark.parametrize("writer,reader", [(jax_io, port_io), (port_io, jax_io)],
                         ids=["jax_then_port", "port_then_jax"])
def test_guard_reads_the_other_packages_sidecar(tmp_path, writer, reader):
    p = tmp_path / "theta_x.npz"
    assert writer.persist_theta_if_better(p, _theta(1.0), 1e-3, verbose=False, note="n")
    assert not reader.persist_theta_if_better(p, _theta(2.0), 2e-3, verbose=False)
    assert reader.load_theta_npz(p)[0]["w"][0, 0] == 1.0
    assert reader.persist_theta_if_better(p, _theta(3.0), 5e-4, verbose=False)
    assert writer.load_theta_npz(p)[0]["w"][0, 0] == 3.0
    assert not writer.persist_theta_if_better(p, _theta(4.0), 6e-4, verbose=False)
    assert _side(tmp_path)["rel_l2"] == 5e-4


def test_load_checkpoint_shape_mismatch_raises(tmp_path):
    _steady().train(epoch_num=2, save_freq=2, folderpath=str(tmp_path), **TRAIN)
    target = {"theta": _steady(layer_width=(8, 4))._params(None)}
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with pytest.raises(ValueError, match="structure"):
            load_checkpoint(str(tmp_path), target)


def test_train_adaptive_checkpoints_each_stage(tmp_path):
    """Each stage of ``train_adaptive`` checkpoints into its own ``stage<K>/``
    (refinement changes the problem's shape: separate lineages), with the
    stage's own test count in its ``config.json``."""
    vn = VarNet(analytic.steady_ad_2d()["pde"], layer_width=(8,), disc_num=6, b_disc_num=6,
                device="cpu")
    vn.train_adaptive(epoch_num=8, rounds=1, frac=0.25, weight=(1.0, 10.0), save_freq=4,
                      folderpath=str(tmp_path), verbose=False, error_disc=8)
    n_tests = []
    for stage in ("stage0", "stage1"):
        folder = str(tmp_path / stage)
        assert list_checkpoint_steps(folder) == [4]
        n_tests.append(ckpt.load_config(folder)["n_test"])
    assert n_tests[1] > n_tests[0] == 25
    assert n_tests[1] == vn.static.n_test
