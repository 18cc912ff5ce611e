from .adpde import ADPDE, MORVar, NeumannBC, RobinBC, eval_field
from .analytic import (
    steady_ad_1d,
    steady_ad_2d,
    steady_adr_1d,
    transient_ad_1d,
    transient_ad_2d,
)
