from .helpers import (
    cartesian_grid,
    hstack,
    is_empty,
    is_none,
    matmul_precision_scope,
    pair_mats,
    rel_l2_error,
    vstack,
)
from .io import load_theta_npz, save_solution_csv, save_theta_npz, theta_npz_dict
