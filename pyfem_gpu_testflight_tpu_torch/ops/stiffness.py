"""Material constants (port of ``lame_params`` from the JAX package).

The Lamé-form element stiffness einsums belong to a later slice; the
structured GMG path builds its unit matrices on the host in NumPy
(``multigrid.GMGAssembler.unit_matrices``).
"""

from __future__ import annotations

__all__ = ["lame_params"]


def lame_params(E, nu, ndims):
    """(mu, lam) for 3D isotropic or 2D plane stress.

    Plane stress uses the effective lambda = E nu / (1 - nu^2) so that
    2 mu e + lam tr(e) I reproduces the reference's plane-stress C0
    (pyfem.py:1746-1750); 3D matches pyfem.py:1752-1757.
    """
    mu = E / (2.0 * (1.0 + nu))
    if ndims == 2:
        lam = E * nu / (1.0 - nu**2)
    else:
        lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    return mu, lam
