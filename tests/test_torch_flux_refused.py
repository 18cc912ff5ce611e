"""The port refuses Neumann/Robin boundary data until it carries the flux rows.

The JAX package adds ``w_bc * loss_neu`` to the loss (``train/loss.py``) and the
flux rows to the LM residual (``train/gauss_newton.py``).  The port has neither
yet, so ``VarNet`` raises ``NotImplementedError`` for a problem with flux data,
in penalty mode as in hard mode, instead of training a problem without its
flux condition.  A Dirichlet problem still builds.
"""

import dataclasses

import pytest

from varnet_tpu.fem.assembly import build_fixed_data as jax_build_fixed_data
from varnet_tpu.problems import analytic as jax_analytic
from varnet_tpu_torch import VarNet
from varnet_tpu_torch.fem.assembly import build_fixed_data
from varnet_tpu_torch.problems import analytic
from varnet_tpu_torch.problems.adpde import RobinBC

MESH = dict(disc_num=4, b_disc_num=4, device="cpu")
FLUX = ["steady_ad_1d_neumann", "steady_ad_2d_neumann"]


@pytest.mark.parametrize("hard", [False, True], ids=["penalty", "hard"])
@pytest.mark.parametrize("factory", FLUX)
def test_flux_problems_are_refused(factory, hard):
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        VarNet(getattr(analytic, factory)()["pde"], hard_bc=hard, **MESH)


@pytest.mark.parametrize("hard", [False, True], ids=["penalty", "hard"])
def test_robin_problem_is_refused(hard):
    pde = analytic.steady_ad_1d_neumann()["pde"]
    robin = dataclasses.replace(pde, bcs=[0.0, RobinBC(alpha=1.0, flux=0.5)])
    with pytest.raises(NotImplementedError, match="Neumann/Robin"):
        VarNet(robin, hard_bc=hard, **MESH)


@pytest.mark.parametrize("factory", FLUX)
def test_refused_problems_have_flux_rows_in_the_reference(factory):
    """What the port refuses is exactly what has flux rows: both packages
    build them for these problems (the rows the loss would drop)."""
    kw = dict(b_disc_num=4)
    ours = build_fixed_data(getattr(analytic, factory)()["pde"], 4, **kw)
    ref = jax_build_fixed_data(getattr(jax_analytic, factory)()["pde"], 4, **kw)
    assert ours.neu is not None and ref.neu is not None
    assert ours.neu.coords.shape == ref.neu.coords.shape


@pytest.mark.parametrize("hard", [False, True], ids=["penalty", "hard"])
@pytest.mark.parametrize("factory", ["steady_ad_1d", "steady_ad_2d"])
def test_dirichlet_problems_still_build(factory, hard):
    vn = VarNet(getattr(analytic, factory)()["pde"], layer_width=(8, 8), hard_bc=hard,
                **MESH)
    assert vn.fixed.neu is None
    assert (vn.hard is not None) == hard
    assert vn.evaluate(vn.fixed.quad.coords.reshape(-1, vn.static.n_inputs)[:5]).shape[0] == 5
