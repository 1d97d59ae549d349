from .base import FEModel, ramp, ramp_deriv
from .elasticity import LinearElasticity
from .poisson import LinearPoisson

__all__ = ["FEModel", "LinearElasticity", "LinearPoisson", "ramp",
           "ramp_deriv"]
