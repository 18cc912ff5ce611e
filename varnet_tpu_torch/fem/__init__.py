from .assembly import FixedData, PointData, ProblemStatic, QuadData, build_fixed_data, pad_points, pad_quad
from .element import HatQuadrature, MasterElement, gauss_legendre
