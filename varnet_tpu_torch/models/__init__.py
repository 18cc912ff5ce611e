from .mlp import (
    init_mlp,
    make_input_scaling,
    mlp_apply,
    mlp_value_and_jac,
    params_from_jax,
    params_to_numpy,
)
