"""varnet_tpu_torch -- the PyTorch/CUDA port of varnet_tpu.

The same variational (weak-form) neural PDE solver, run eagerly in PyTorch on
one device.  On an NVIDIA Hopper GPU the interior weak residual and its
parameter gradient run through a hand-written CUDA kernel
(``csrc/dir_residual.cu``, built at first use); on the CPU through its plain
PyTorch version.  The JAX package ``varnet_tpu`` is the reference this port is
tested against; this package imports no JAX.
"""

from .api import VarNet
from .fem.assembly import FixedData, PointData, ProblemStatic, QuadData, build_fixed_data
from .fem.element import HatQuadrature, MasterElement
from .geometry.domain import Domain1D, RectangleDomain2D
from .models.mlp import (
    init_mlp,
    make_input_scaling,
    mlp_apply,
    mlp_value_and_jac,
    params_from_jax,
    params_to_numpy,
)
from .problems.adpde import ADPDE, MORVar
from .train.loss import make_loss_fn
from .train.optim import OptimizerConfig, make_optimizer
from .train.trainer import TrainResult
from .utils.io import load_theta_npz, save_theta_npz

__all__ = [
    "VarNet",
    "ADPDE",
    "MORVar",
    "Domain1D",
    "RectangleDomain2D",
    "MasterElement",
    "HatQuadrature",
    "build_fixed_data",
    "FixedData",
    "QuadData",
    "PointData",
    "ProblemStatic",
    "init_mlp",
    "make_input_scaling",
    "mlp_apply",
    "mlp_value_and_jac",
    "params_from_jax",
    "params_to_numpy",
    "make_loss_fn",
    "OptimizerConfig",
    "make_optimizer",
    "TrainResult",
    "load_theta_npz",
    "save_theta_npz",
]
