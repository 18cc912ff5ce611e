"""The PyTorch port's copied host side builds fixed data BIT-EQUAL to the
JAX package's (varnet_tpu_torch.fem.assembly vs varnet_tpu.fem.assembly)."""

import numpy as np
import pytest

from varnet_tpu.fem.assembly import build_fixed_data as jax_build
from varnet_tpu.problems import analytic as jax_analytic
from varnet_tpu_torch.fem.assembly import build_fixed_data as port_build
from varnet_tpu_torch.problems import analytic as port_analytic

CASES = [
    ("transient_ad_2d", 8, dict(b_disc_num=6, t_disc_num=4)),
    ("steady_ad_1d", 16, dict()),
    ("steady_ad_2d", 6, dict(b_disc_num=5)),
    ("transient_ad_1d", 10, dict(t_disc_num=5)),
]


def _assert_tuple_equal(a, b, what):
    assert type(a).__name__ == type(b).__name__
    for field, x, y in zip(a._fields, a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=f"{what}.{field}")
        assert np.asarray(x).dtype == np.asarray(y).dtype, f"{what}.{field} dtype"


@pytest.mark.parametrize("name,disc,kw", CASES, ids=[c[0] for c in CASES])
def test_fixed_data_bit_equal(name, disc, kw):
    ref = jax_build(getattr(jax_analytic, name)()["pde"], disc, **kw)
    port = port_build(getattr(port_analytic, name)()["pde"], disc, **kw)
    _assert_tuple_equal(port.quad, ref.quad, "quad")
    _assert_tuple_equal(port.bc, ref.bc, "bc")
    assert (port.ic is None) == (ref.ic is None)
    if ref.ic is not None:
        _assert_tuple_equal(port.ic, ref.ic, "ic")
    for field in ref.static.__dataclass_fields__:
        np.testing.assert_array_equal(np.asarray(getattr(port.static, field)),
                                      np.asarray(getattr(ref.static, field)),
                                      err_msg=f"static.{field}")


def test_exact_solution_bit_equal():
    """The analytic solutions the error reports score against agree too."""
    ref = jax_analytic.transient_ad_2d()["pde"]
    port = port_analytic.transient_ad_2d()["pde"]
    rng = np.random.default_rng(0)
    x = rng.uniform(0.0, 1.0, (64, 2))
    t = rng.uniform(*ref.t_interval, 64)
    np.testing.assert_array_equal(port.eval_exact(x, t, None), ref.eval_exact(x, t, None))
