"""The pinned contaminant net through the port on the CPU: the committed B
(``varnet_tpu_torch/data/contaminant_causal_fourier_b.npy``) equals the JAX
package's draw, the pinned theta with that B re-scores below 2.0% against the
shipped CN-FDM field (t > 0 slices, as ``benchmarks/fdm_scoring.py``), and the
port's ``evaluate`` equals JAX's at that theta within rtol 1e-4 (f32 evaluation
at angles of tens of radians)."""

import os

import numpy as np
import pytest

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.problems.analytic import contaminant_transport_2d as jax_contaminant
from varnet_tpu_torch import VarNet, load_theta_npz
from varnet_tpu_torch.problems.analytic import contaminant_transport_2d
from varnet_tpu_torch.utils.helpers import rel_l2_error
from varnet_tpu_torch.utils.io import CONTAMINANT_CAUSAL_FOURIER_B

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "benchmarks")
THETA = os.path.join(ROOT, "results", "theta_contaminant_causal.npz")
FDM = os.path.join(ROOT, "data", "contaminant_fdm.npz")
NET = dict(layer_width=(96, 96, 96), disc_num=8, t_disc_num=4, b_disc_num=4, seed=0,
           input_scaling=False)


@pytest.fixture(scope="module")
def jax_vn():
    vn = JaxVarNet(jax_contaminant()["pde"], n_devices=1, fourier_features=128,
                   fourier_scale=[0.5, 2.0], **NET)
    vn.theta = load_theta_npz(THETA)
    return vn


@pytest.fixture(scope="module")
def port_vn():
    vn = VarNet(contaminant_transport_2d()["pde"], device="cpu",
                fourier_b=np.load(CONTAMINANT_CAUSAL_FOURIER_B), **NET)
    vn.theta = load_theta_npz(THETA)
    return vn


def test_committed_b_is_the_jax_draw(jax_vn):
    b = np.load(CONTAMINANT_CAUSAL_FOURIER_B)
    assert b.dtype == np.float32 and b.shape == (3, 128)
    np.testing.assert_array_equal(b, np.asarray(jax_vn.fourier_b))


def test_pinned_theta_rescores_below_two_percent(port_vn):
    z = np.load(FDM)
    x = z["x"].astype(np.float64)
    preds, trues = [], []
    for s, tval in enumerate(z["times"]):
        if tval <= 0:
            continue
        preds.append(port_vn.evaluate(x, t=np.full(x.shape[0], tval)))
        trues.append(z["u"][s].astype(np.float64))
    overall = rel_l2_error(np.concatenate(preds), np.concatenate(trues))
    assert overall < 0.020, f"expected ~1.52e-2, got {overall:.4e}"


def test_evaluate_matches_jax_at_the_pinned_theta(jax_vn, port_vn):
    rng = np.random.default_rng(0)
    x = rng.random((2000, 2)) * np.array([2.0, 1.0])
    t = rng.random(2000)
    ref = np.asarray(jax_vn.evaluate(x, t))
    np.testing.assert_allclose(port_vn.evaluate(x, t), ref, rtol=1e-4,
                               atol=1e-4 * float(np.abs(ref).max()))
