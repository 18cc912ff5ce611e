"""Fault recovery in the port (``varnet_tpu_torch/train/fault.py`` and the retry
loops of ``VarNet.train`` / ``VarNet.refine_lm``), one to one with
``tests/test_fault_recovery.py``: the classification of constructed torch and
CUDA errors, the LM retry resuming from its checkpoint with ``k_chunks``
doubled, program and sticky errors propagating, the cross-process LM resume
with lam from the meta sidecar, ``train``'s retry before and after its first
checkpoint, and resume on an empty folder.  Then an LM run cut after one
iteration and resumed equal to the uninterrupted run bit for bit (theta and
lam), and the same resume against the JAX package's ``refine_lm`` within the LM
band, rtol 2e-2.

Faults are injected by wrapping the real implementations, so the retry loops
under test are the production code paths."""

import jax
import numpy as np
import pytest
import torch

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.problems.analytic import steady_ad_1d as jax_steady_ad_1d
from varnet_tpu.train import checkpoint as jax_checkpoint
from varnet_tpu_torch import VarNet, params_from_jax
from varnet_tpu_torch.problems.analytic import steady_ad_1d
from varnet_tpu_torch.train.checkpoint import list_checkpoint_steps, load_meta
from varnet_tpu_torch.train.fault import CudaKernelError, cuda_error_name, is_transient_device_error

NET = dict(layer_width=(8, 8), disc_num=12)
LM = dict(save_freq=1, cg_iters=3, verbose=False, error_disc=16)
K_SLOT = 8   # k_chunks' position in _refine_lm_impl's arguments after ``steps``


def _flat(theta):
    return np.concatenate([np.ravel(np.asarray(layer[k])) for layer in theta
                           for k in ("w", "b")])


def _fresh():
    return VarNet(steady_ad_1d(kappa=0.1)["pde"], device="cpu", **NET)


@pytest.fixture(scope="module")
def trained_theta():
    vn = _fresh()
    vn.train(epoch_num=50, weight=(1.0, 10.0), save_freq=50, verbose=False, error_disc=16)
    return vn.theta


def _tiny_vn(theta):
    vn = _fresh()
    vn.theta = [{k: v.clone() for k, v in layer.items()} for layer in theta]
    return vn


def _accel(text):
    """The error torch raises for a failed CUDA call (``torch.AcceleratorError``
    where the installed torch has it)."""
    cls = getattr(torch, "AcceleratorError", RuntimeError)
    return cls(f"CUDA error: {text}\nCUDA kernel errors might be asynchronously reported")


CASES = [
    # (error, transient, transient with include_oom)
    (torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 80.00 GiB"),
     False, True),
    (CudaKernelError("ff_vj_fwd", 2), False, True),
    (RuntimeError("CUDA error: CUBLAS_STATUS_ALLOC_FAILED when calling `cublasCreate(handle)`"),
     False, True),
    (CudaKernelError("dir_residual_fwd", 46), True, True),
    (_accel("CUDA-capable device(s) is/are busy or unavailable"), True, True),
    (_accel("system not yet initialized"), True, True),
    # sticky: the context is dead, never retried in-process
    (_accel("an illegal memory access was encountered"), False, False),
    (CudaKernelError("vj_bwd", 719), False, False),
    (_accel("uncorrectable ECC error encountered"), False, False),
    (_accel("the launch timed out and was terminated"), False, False),
    (CudaKernelError("vj_jvp", 700), False, False),
    # program errors
    (CudaKernelError("dir_residual_fwd", 9), False, False),
    (ValueError("ff_mlp.cu: hidden width 512 > 256"), False, False),
    (NotImplementedError("not ported"), False, False),
    (RuntimeError("nvcc failed:\nerror: identifier undefined"), False, False),
    (RuntimeError("device busy, but not a CUDA error"), False, False),
]


@pytest.mark.parametrize("err,transient,with_oom", CASES,
                         ids=[f"{type(c[0]).__name__}-{i}" for i, c in enumerate(CASES)])
def test_transient_classification(err, transient, with_oom):
    assert is_transient_device_error(err) is transient
    assert is_transient_device_error(err, include_oom=True) is with_oom


def test_error_names():
    assert cuda_error_name(CudaKernelError("x", 719)) == "cudaErrorLaunchFailure"
    assert cuda_error_name(_accel("an illegal memory access was encountered")) == \
        "cudaErrorIllegalAddress"
    assert cuda_error_name(RuntimeError("illegal memory access somewhere")) is None
    assert "cudaErrorLaunchFailure" in str(CudaKernelError("vj_bwd", 719))


def test_lm_retry_resumes_from_checkpoint(tmp_path, monkeypatch, trained_theta):
    """The first attempt does 2 real LM iterations, then runs out of memory;
    the retry resumes at global step 2 with k_chunks doubled and runs to 4."""
    vn = _tiny_vn(trained_theta)
    real = VarNet._refine_lm_impl
    seen = {"n": 0, "k": []}

    def flaky(self, steps, *args):
        seen["n"] += 1
        seen["k"].append(args[K_SLOT])
        if seen["n"] == 1:
            real(self, 2, *args)
            raise torch.cuda.OutOfMemoryError("CUDA out of memory (injected)")
        return real(self, steps, *args)

    monkeypatch.setattr(VarNet, "_refine_lm_impl", flaky)
    r = vn.refine_lm(steps=4, folderpath=str(tmp_path), max_retries=1, retry_backoff=0.0,
                     **LM)
    lm_dir = str(tmp_path / "lm")
    assert seen["n"] == 2 and seen["k"] == [1, 2]
    assert r.epochs == [3, 4] and r.total_steps == 4
    assert list_checkpoint_steps(lm_dir) == [2, 3, 4]
    meta = load_meta(lm_dir, 4)
    assert meta["phase"] == "lm" and meta["lam"] > 0 and np.isfinite(meta["loss"])


@pytest.mark.parametrize("err", [RuntimeError("nvcc failed: injected"),
                                 _accel("an illegal memory access was encountered"),
                                 torch.cuda.OutOfMemoryError("injected")],
                         ids=["program", "sticky", "oom_no_retries"])
def test_nontransient_propagates(tmp_path, monkeypatch, trained_theta, err):
    vn = _tiny_vn(trained_theta)
    seen = {"n": 0}

    def broken(self, *args):
        seen["n"] += 1
        raise err

    monkeypatch.setattr(VarNet, "_refine_lm_impl", broken)
    retries = 0 if isinstance(err, torch.cuda.OutOfMemoryError) else 3
    with pytest.raises(type(err)):
        vn.refine_lm(steps=2, folderpath=str(tmp_path), max_retries=retries,
                     retry_backoff=0.0, verbose=False)
    assert seen["n"] == 1


def test_lm_cross_process_resume(tmp_path, trained_theta):
    """resume=True picks up theta and lam from the newest LM checkpoint and runs
    only the remaining iterations (global step numbering)."""
    vn = _tiny_vn(trained_theta)
    vn.refine_lm(steps=2, folderpath=str(tmp_path), **LM)
    lm_dir = str(tmp_path / "lm")
    theta_ckpt = _flat(vn.theta)
    lam_ckpt = load_meta(lm_dir, 2)["lam"]
    vn2 = _fresh()
    r = vn2.refine_lm(steps=4, folderpath=str(tmp_path), resume=True, **LM)
    assert r.epochs == [3, 4] and r.total_steps == 4
    assert np.isfinite(lam_ckpt) and lam_ckpt > 0
    vn3 = _fresh()
    step3, lam3 = vn3._restore_theta(lm_dir)
    assert step3 == 4 and lam3 == load_meta(lm_dir, 4)["lam"]
    np.testing.assert_array_equal(_flat(vn3.theta), _flat(vn2.theta))
    assert not np.allclose(_flat(vn3.theta), theta_ckpt)
    r2 = vn2.refine_lm(steps=4, folderpath=str(tmp_path), resume=True, verbose=False)
    assert r2.epochs == [] and r2.total_steps == 4


def test_lm_fresh_run_clears_stale_checkpoints(tmp_path, trained_theta):
    _tiny_vn(trained_theta).refine_lm(steps=3, folderpath=str(tmp_path), **LM)
    assert list_checkpoint_steps(str(tmp_path / "lm")) == [1, 2, 3]
    _tiny_vn(trained_theta).refine_lm(steps=1, folderpath=str(tmp_path), **LM)
    assert list_checkpoint_steps(str(tmp_path / "lm")) == [1]


def test_lm_resume_requires_folderpath(trained_theta):
    with pytest.raises(ValueError, match="folderpath"):
        _tiny_vn(trained_theta).refine_lm(steps=1, resume=True, verbose=False)


def test_lm_cut_and_resumed_equals_uninterrupted_bit_for_bit(tmp_path, trained_theta):
    full = _tiny_vn(trained_theta)
    r_full = full.refine_lm(steps=2, folderpath=str(tmp_path / "full"), **LM)
    _tiny_vn(trained_theta).refine_lm(steps=1, folderpath=str(tmp_path / "cut"), **LM)
    resumed = _fresh()
    r_res = resumed.refine_lm(steps=2, folderpath=str(tmp_path / "cut"), resume=True, **LM)
    np.testing.assert_array_equal(_flat(resumed.theta), _flat(full.theta))
    assert r_res.epochs == [2] and r_res.losses == r_full.losses[1:]
    assert load_meta(str(tmp_path / "cut" / "lm"), 2) == load_meta(
        str(tmp_path / "full" / "lm"), 2)


def test_train_retry_without_checkpoints(tmp_path, monkeypatch, trained_theta):
    """A fault before the first checkpoint restarts clean (resume would find an
    empty folder)."""
    vn = _tiny_vn(trained_theta)
    real = VarNet._train_impl
    seen = {"n": 0, "resume": []}

    def flaky(self, epoch_num, weight, batch_num, save_freq, folderpath, resume, *args):
        seen["n"] += 1
        seen["resume"].append(resume)
        if seen["n"] == 1:
            raise CudaKernelError("dir_residual_fwd (injected)", 46)
        return real(self, epoch_num, weight, batch_num, save_freq, folderpath, resume, *args)

    monkeypatch.setattr(VarNet, "_train_impl", flaky)
    r = vn.train(epoch_num=20, weight=(1.0, 10.0), save_freq=20, verbose=False,
                 error_disc=16, folderpath=str(tmp_path), max_retries=1, retry_backoff=0.0)
    assert seen["n"] == 2 and seen["resume"] == [False, False]
    assert r.epochs == [20] and np.isfinite(r.losses[-1]["loss"])


def test_train_retry_resumes_mid_run(tmp_path, monkeypatch, trained_theta):
    """A fault after checkpoints exist resumes from the newest epoch and asks
    only for the remainder."""
    vn = _tiny_vn(trained_theta)
    real = VarNet._train_impl
    seen = {"n": 0}

    def flaky(self, epoch_num, weight, batch_num, save_freq, folderpath, resume, *args):
        seen["n"] += 1
        if seen["n"] == 1:
            real(self, 10, weight, batch_num, 10, folderpath, resume, *args)
            raise CudaKernelError("dir_residual_bwd (injected)", 46)
        assert resume, "a retry with checkpoints present must resume"
        assert epoch_num == 10, "a retry must ask only for the remainder"
        return real(self, epoch_num, weight, batch_num, save_freq, folderpath, resume, *args)

    monkeypatch.setattr(VarNet, "_train_impl", flaky)
    r = vn.train(epoch_num=20, weight=(1.0, 10.0), save_freq=10, verbose=False,
                 error_disc=16, folderpath=str(tmp_path), max_retries=1, retry_backoff=0.0)
    assert seen["n"] == 2 and r.epochs[-1] == 20
    assert list_checkpoint_steps(str(tmp_path)) == [10, 20]


def test_train_sticky_error_propagates(tmp_path, monkeypatch, trained_theta):
    seen = {"n": 0}

    def broken(self, *args):
        seen["n"] += 1
        raise CudaKernelError("dir_residual_fwd (injected)", 700)

    monkeypatch.setattr(VarNet, "_train_impl", broken)
    with pytest.raises(CudaKernelError, match="cudaErrorIllegalAddress"):
        _tiny_vn(trained_theta).train(epoch_num=4, folderpath=str(tmp_path), max_retries=2,
                                      retry_backoff=0.0, verbose=False)
    assert seen["n"] == 1


def test_train_resume_on_empty_folder_starts_fresh(tmp_path):
    vn = VarNet(steady_ad_1d(kappa=0.2)["pde"], layer_width=(8,), disc_num=8, device="cpu")
    folder = str(tmp_path / "fresh")
    res = vn.train(epoch_num=6, save_freq=3, verbose=False, folderpath=folder, resume=True,
                   error_disc=16)
    assert res.epochs[-1] == 6
    res2 = vn.train(epoch_num=9, save_freq=3, verbose=False, folderpath=folder, resume=True,
                    error_disc=16)
    assert res2.epochs == [9]


def test_lm_resume_matches_jax(tmp_path):
    """The JAX package and the port each run 1 LM iteration from the same theta
    into a folder, then a fresh VarNet of each resumes to 3: the same
    checkpoint steps, losses and lam within the LM band, rtol 2e-2."""
    jvn = JaxVarNet(jax_steady_ad_1d(kappa=0.1)["pde"], n_devices=1, **NET)
    jvn.train(epoch_num=50, weight=(1.0, 10.0), save_freq=50, verbose=False, error_disc=16)
    theta = jax.tree_util.tree_map(np.asarray, jvn.theta)
    jfolder, pfolder = str(tmp_path / "jax"), str(tmp_path / "port")
    lm = dict(LM, matmul_precision="highest")
    jvn.refine_lm(steps=1, folderpath=jfolder, **lm)
    port = _fresh()
    port.theta = params_from_jax(theta)
    port.refine_lm(steps=1, folderpath=pfolder, **lm)
    jres = JaxVarNet(jax_steady_ad_1d(kappa=0.1)["pde"], n_devices=1, **NET).refine_lm(
        steps=3, folderpath=jfolder, resume=True, **lm)
    pres = _fresh().refine_lm(steps=3, folderpath=pfolder, resume=True, **lm)
    assert pres.epochs == jres.epochs == [2, 3]
    assert list_checkpoint_steps(pfolder + "/lm") == jax_checkpoint.list_checkpoint_steps(
        jfolder + "/lm") == [1, 2, 3]
    for key in ("loss", "lam"):
        np.testing.assert_allclose([r[key] for r in pres.losses],
                                   [r[key] for r in jres.losses], rtol=2e-2, err_msg=key)
    np.testing.assert_allclose(pres.errors, jres.errors, rtol=2e-2)
