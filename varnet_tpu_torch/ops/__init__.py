from .residual import masked_mse, masked_sum_sq, weak_residual
