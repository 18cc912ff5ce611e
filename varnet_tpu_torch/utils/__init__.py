from .helpers import cartesian_grid, matmul_precision_scope, pair_mats, rel_l2_error
from .io import load_theta_npz, save_theta_npz, theta_npz_dict
