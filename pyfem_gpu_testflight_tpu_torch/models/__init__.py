from .base import FEModel, ramp, ramp_deriv
from .elasticity import LinearElasticity

__all__ = ["FEModel", "LinearElasticity", "ramp", "ramp_deriv"]
