from .mlp import (
    init_mlp,
    init_siren,
    make_input_scaling,
    mlp_apply,
    mlp_value_and_jac,
    param_count,
    params_from_jax,
    params_to_numpy,
)
from .source import make_gaussian_source, make_mlp_source, make_mlp_source_xt
