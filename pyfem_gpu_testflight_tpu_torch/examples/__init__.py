"""The reference's example scripts, run on this package.

Copies of the JAX package's ``examples/``: ``block_3d``,
``heat_conduction``, ``helmholtz_filter``, ``nonlinear_poisson_ex``,
``quad_tri``, ``element_plot``, ``topo`` and ``performance_study``
(each a ``main(argv)`` that takes ``--device``, the CUDA card by
default), and the ones that synthesize unstructured meshes:
``torque_arm``, ``torque_arm_topo`` and ``bracket3d_topo`` — for the
same arguments the synthesizers write byte-identical Abaqus ``.inp``
files, and ``build_problem`` sets up the same topology problems (AMG
state solves, unstructured Helmholtz filter, MMA).
"""
