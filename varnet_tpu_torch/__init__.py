"""varnet_tpu_torch -- the PyTorch/CUDA port of varnet_tpu.

The same variational (weak-form) neural PDE solver, run eagerly in PyTorch on
one device: Adam training (``VarNet.train``) and Levenberg-Marquardt refinement
(``VarNet.refine_lm``).  On an NVIDIA Hopper GPU the Adam step's interior weak
residual and its parameter gradient run through a hand-written CUDA kernel
(``csrc/dir_residual.cu``), and LM's value + jacobian evaluation, its parameter
backward and its parameter-tangent JVP through three more
(``csrc/value_and_jac.cu``), all built at first use; on the CPU through their
plain PyTorch versions.  A net behind a fixed random-Fourier-feature embedding
(``VarNet(fourier_features=...)``, the contaminant recipe of
``train/causal.py::train_causal``) runs through the kernels of
``csrc/ff_mlp.cu`` (K2-FF, K7, K8).  The JAX package ``varnet_tpu`` is the
reference this port is tested against; this package imports no JAX.
"""

from .api import VarNet
from .fem.assembly import FixedData, PointData, ProblemStatic, QuadData, build_fixed_data
from .fem.element import HatQuadrature, MasterElement
from .geometry.domain import Domain1D, RectangleDomain2D
from .models.mlp import (
    ff_apply,
    ff_value_and_jac,
    init_mlp,
    make_fourier_features,
    make_input_scaling,
    mlp_apply,
    mlp_value_and_jac,
    params_from_jax,
    params_to_numpy,
    ravel_params,
)
from .problems.adpde import ADPDE, MORVar
from .train.loss import make_loss_fn
from .train.causal import train_causal
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
    "make_fourier_features",
    "ff_apply",
    "ff_value_and_jac",
    "train_causal",
    "make_input_scaling",
    "mlp_apply",
    "mlp_value_and_jac",
    "params_from_jax",
    "params_to_numpy",
    "ravel_params",
    "make_loss_fn",
    "OptimizerConfig",
    "make_optimizer",
    "TrainResult",
    "load_theta_npz",
    "save_theta_npz",
]
