from .base import FEModel, ramp, ramp_deriv
from .elasticity import LinearElasticity
from .helmholtz import Helmholtz
from .nonlinear_poisson import NonlinearPoisson, NonlinearPoisson2D
from .poisson import LinearPoisson

__all__ = ["FEModel", "Helmholtz", "LinearElasticity", "LinearPoisson",
           "NonlinearPoisson", "NonlinearPoisson2D", "ramp", "ramp_deriv"]
