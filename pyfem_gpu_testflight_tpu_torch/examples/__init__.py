"""Examples that synthesize unstructured meshes and run the port on them.

Copies of the JAX package's ``examples/torque_arm.py``,
``torque_arm_topo.py`` and ``bracket3d_topo.py`` built on this package:
for the same arguments the synthesizers write byte-identical Abaqus
``.inp`` files, and ``build_problem`` sets up the same topology
problems (AMG state solves, unstructured Helmholtz filter, MMA).
"""
