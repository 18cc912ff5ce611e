"""The port's causal curriculum (``train/causal.py``) and the Fourier-feature
contaminant path of ``VarNet`` against the JAX package on the CPU: the window
checks, the per-stage t_disc and warm start, one window's 20-epoch Adam
trajectory from a carried theta and B (rtol 2e-4, the Adam band of
``__graft_entry__.py``), and 2 LM iterations x 5 CG on the FF net against JAX's
``refine_lm`` (rtol 2e-2, the LM band).  Inputs are unscaled, as the curriculum
runs them."""

import jax
import numpy as np
import pytest
import torch

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.problems.analytic import contaminant_transport_2d as jax_contaminant
from varnet_tpu_torch import VarNet, params_from_jax
from varnet_tpu_torch.problems.analytic import contaminant_transport_2d
from varnet_tpu_torch.train.causal import train_causal
from _torch_threads import _one_intra_op_thread  # noqa: F401


NET = dict(layer_width=(16, 16), disc_num=8, b_disc_num=4, t_disc_num=4,
           fourier_features=8, fourier_scale=[0.5, 2.0], input_scaling=False)
W = (1.0, 10.0, 10.0)
TRAIN = dict(epoch_num=20, weight=W, save_freq=1, verbose=False, error_disc=8, error_times=2)
LM = dict(steps=2, weight=W, cg_iters=5, k_chunks=2, save_freq=1, verbose=False)
SMALL = dict(layer_width=(8, 8), disc_num=4, b_disc_num=4, fourier_features=8,
             fourier_scale="0.5,2.0", device="cpu")


def _pde(t_end):
    return contaminant_transport_2d(t_final=t_end)["pde"]


@pytest.mark.parametrize("windows,match", [((0.5, 0.9), "final window"),
                                           ((0.5, 0.5, 1.0), "increasing"),
                                           ((0.0, 1.0), "positive"), ((), "final window")])
def test_window_checks(windows, match):
    with pytest.raises(ValueError, match=match):
        train_causal(_pde, windows=windows, epoch_num=1, varnet_kwargs=SMALL)


@pytest.mark.parametrize("kw,err", [({"resume": True}, "folderpath"),
                                    ({"train_kwargs": {"weight": W}}, "train_kwargs"),
                                    ({"train_kwargs": {"folderpath": "x"}}, "train_kwargs")])
def test_unported_and_colliding_options_raise(kw, err):
    with pytest.raises(ValueError, match=err):
        train_causal(_pde, windows=(1.0,), epoch_num=1, varnet_kwargs=SMALL, **kw)


def test_stages_warm_start_with_fixed_dt(tmp_path):
    """Stage w uses t_disc max(4, round(t_disc_full w)) and starts from the
    previous stage's theta (through stage_transfer); the B of every stage is
    the same draw; each stage writes its log under {folderpath}_w{w}."""
    seen = []

    def transfer(theta, w_prev, w_next):
        seen.append((w_prev, w_next, [{k: v.clone() for k, v in l.items()} for l in theta]))
        return theta

    def hook(vn, w, res):
        return {"t_disc": vn.t_disc_num, "theta": vn.theta, "b": vn.fourier_b,
                "scaled": vn.input_scaling}

    vn, stages = train_causal(_pde, windows=(0.25, 0.5, 1.0), epoch_num=2, weight=W,
                              t_disc_full=10, varnet_kwargs=SMALL, stage_hook=hook,
                              stage_transfer=transfer, verbose=False,
                              folderpath=str(tmp_path / "run"),
                              train_kwargs=dict(error_disc=4, error_times=2))
    assert [s["t_disc"] for s in stages] == [4, 5, 10]
    assert [s["t_end"] for s in stages] == [0.25, 0.5, 1.0]
    assert all(np.isfinite(s["final_loss"]) for s in stages)
    assert not any(s["scaled"] for s in stages)
    for (w_prev, w_next, theta), prev in zip(seen, stages):
        assert w_prev == prev["t_end"]
        for a, b in zip(theta, prev["theta"]):
            assert torch.equal(a["w"], b["w"])
    assert all(torch.equal(s["b"], stages[0]["b"]) for s in stages)
    assert vn.pde.t_interval == contaminant_transport_2d()["pde"].t_interval
    for w in ("0.25", "0.5", "1"):
        assert (tmp_path / f"run_w{w}" / "train_log.jsonl").exists()


@pytest.fixture(scope="module")
def jax_window():
    """One causal window (t in [0, 0.25 T]) of the FF contaminant net in JAX:
    its B and initial theta, its 20-epoch Adam result, and 2 LM iterations."""
    vn = JaxVarNet(jax_contaminant(t_final=0.25)["pde"], n_devices=1, **NET)
    b = np.asarray(vn.fourier_b)
    theta0 = jax.tree_util.tree_map(np.asarray, vn.theta)
    res = vn.train(**TRAIN)
    theta1 = jax.tree_util.tree_map(np.asarray, vn.theta)
    return b, theta0, res, theta1, vn.refine_lm(**LM)


def _port(b, theta, **kw):
    vn = VarNet(_pde(0.25), device="cpu", fourier_b=b, **{**NET, **kw})
    vn.theta = params_from_jax(theta)
    return vn


@pytest.mark.parametrize("fused", [True, False], ids=["k2ff", "general"])
def test_window_adam_trajectory_matches_jax(jax_window, fused):
    b, theta0, jres, _, _ = jax_window
    res = _port(b, theta0, use_fused_residual=fused).train(**TRAIN)
    assert res.epochs == jres.epochs
    for key in ("loss", "loss_int", "loss_bc", "loss_ic"):
        np.testing.assert_allclose([r[key] for r in res.losses],
                                   [r[key] for r in jres.losses], rtol=2e-4, err_msg=key)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel_fn", "general"])
def test_lm_on_the_ff_net_matches_jax(jax_window, use_pallas):
    b, _, _, theta1, jres = jax_window
    res = _port(b, theta1, use_pallas=use_pallas).refine_lm(**LM)
    for key in ("loss", "lam"):
        np.testing.assert_allclose([r[key] for r in res.losses],
                                   [r[key] for r in jres.losses], rtol=2e-2, err_msg=key)


def test_input_scaling_off_feeds_raw_coordinates(jax_window):
    """With input_scaling=False the port keeps no scale/shift, evaluate equals
    ff_apply at the raw points, and it equals JAX's evaluate."""
    b, theta0, _, _, _ = jax_window
    vn = _port(b, theta0)
    assert vn.scale is None and vn.shift is None
    jvn = JaxVarNet(jax_contaminant(t_final=0.25)["pde"], n_devices=1, **NET)
    jvn.theta = jax.tree_util.tree_map(np.asarray, theta0)
    x = np.random.default_rng(0).random((50, 2)) * np.array([2.0, 1.0])
    t = np.random.default_rng(1).random(50) * 0.25
    np.testing.assert_allclose(vn.evaluate(x, t), np.asarray(jvn.evaluate(x, t)), rtol=1e-5,
                               atol=1e-6)


def test_train_causal_resume(tmp_path):
    """The counterpart of ``tests/test_causal.py::test_train_causal_resume``: a
    completed window is restored and skipped, a partly trained one trains only
    its remaining epochs, and ``resume`` inside ``train_kwargs`` is refused."""
    import shutil

    from varnet_tpu_torch.train.checkpoint import list_checkpoint_steps

    folder = str(tmp_path / "case")
    kw = dict(windows=(0.5, 1.0), epoch_num=8, weight=W, t_disc_full=8,
              varnet_kwargs=dict(SMALL, seed=3), train_kwargs=dict(save_freq=4, error_disc=4,
                                                                   error_times=2),
              folderpath=folder, verbose=False)
    vn1, _ = train_causal(_pde, **kw)
    w1 = f"{folder}_w1"
    assert list_checkpoint_steps(w1) == [4, 8]
    shutil.rmtree(f"{w1}/ckpt_{8:010d}")   # a death halfway through window 2

    vn2, st2 = train_causal(_pde, resume=True, **kw)
    assert st2[0] == {"t_end": 0.5, "resumed": True, "epochs_done": 8}
    assert st2[1]["result"].epochs == [8]   # only epochs 5..8 ran
    assert list_checkpoint_steps(w1)[-1] == 8
    # the resumed run lands where the uninterrupted one did
    for a, b in zip(vn1.theta, vn2.theta):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    with pytest.raises(ValueError, match="train_kwargs"):
        train_causal(_pde, **dict(kw, train_kwargs=dict(save_freq=4, resume=True)))
