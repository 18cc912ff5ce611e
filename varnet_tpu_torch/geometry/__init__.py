from .domain import (
    BoxDomain3D,
    BoxDomainND,
    Domain1D,
    Mesh,
    PolygonDomain2D,
    PrismDomain3D,
    RectangleDomain2D,
)
