from .base import FEModel, ramp, ramp_deriv
from .elasticity import LinearElasticity
from .helmholtz import Helmholtz
from .poisson import LinearPoisson

__all__ = ["FEModel", "Helmholtz", "LinearElasticity", "LinearPoisson",
           "ramp", "ramp_deriv"]
