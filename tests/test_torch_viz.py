"""The port's solution plots (``varnet_tpu_torch/viz/plot.py``, a copy of the
reference's, and ``VarNet.sim_res``) against the JAX package's on the CPU: from
the same theta, 1-D (steady, transient), 2-D (steady, transient) and 3-D
problems write the same file names, and the error table the same times with the
same rel-L2 (rtol 1e-5: the nets evaluate in f32).  Without matplotlib
``sim_res`` raises an ``ImportError`` naming it."""

import json
import os
import sys

import jax
import numpy as np
import pytest

from varnet_tpu.api import VarNet as JaxVarNet
from varnet_tpu.problems import analytic as jax_analytic
from varnet_tpu_torch import VarNet, params_from_jax
from varnet_tpu_torch.problems import analytic
from _torch_threads import _one_intra_op_thread  # noqa: F401


CASES = {  # factory name, mesh
    "1d_steady": ("steady_ad_1d", dict(disc_num=8)),
    "1d_transient": ("transient_ad_1d", dict(disc_num=6, t_disc_num=3)),
    "2d_steady": ("steady_ad_2d", dict(disc_num=4, b_disc_num=4)),
    "2d_transient": ("transient_ad_2d", dict(disc_num=4, b_disc_num=4, t_disc_num=3)),
    "3d_steady": ("steady_ad_3d", dict(disc_num=3, b_disc_num=3)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sim_res_writes_jax_files(case, tmp_path):
    factory, mesh = CASES[case]
    jvn = JaxVarNet(getattr(jax_analytic, factory)()["pde"], layer_width=(6, 6), n_devices=1,
                    **mesh)
    vn = VarNet(getattr(analytic, factory)()["pde"], layer_width=(6, 6), device="cpu", **mesh)
    vn.theta = params_from_jax(jax.tree_util.tree_map(np.asarray, jvn.theta))
    if case == "2d_steady":   # a training history adds history.png
        for v in (jvn, vn):
            v.train(epoch_num=2, save_freq=1, verbose=False, error_disc=4)
        vn.theta = params_from_jax(jax.tree_util.tree_map(np.asarray, jvn.theta))
    ours = vn.sim_res(str(tmp_path / "port"), disc=8, n_times=2)
    ref = jvn.sim_res(str(tmp_path / "jax"), disc=8, n_times=2)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in ref]
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert ("history.png" in os.listdir(tmp_path / "port")) == (case == "2d_steady")
    with open(tmp_path / "port" / "error_table.json") as f:
        table = json.load(f)
    with open(tmp_path / "jax" / "error_table.json") as f:
        jtable = json.load(f)
    assert list(table) == list(jtable)
    np.testing.assert_allclose(list(table.values()), list(jtable.values()), rtol=1e-5)


def test_sim_res_without_matplotlib_names_it(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "varnet_tpu_torch.viz.plot", raising=False)
    vn = VarNet(analytic.steady_ad_1d()["pde"], layer_width=(4, 4), disc_num=4, device="cpu")
    with pytest.raises(ImportError, match="matplotlib"):
        vn.sim_res(str(tmp_path))
