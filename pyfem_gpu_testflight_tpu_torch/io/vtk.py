"""Legacy ASCII VTK export (NumPy copy of the JAX package's ``io/vtk.py``).

The topology-optimization loops write their designs with it.  Host
NumPy only; torch tensors are taken through ``np.asarray`` after a move
to the host.

Reference parity: ``utils.to_vtk`` (utils.py:302-426) — unstructured-grid
files with POINTS / CELLS / CELL_TYPES / POINT_DATA sections, 2D points
padded to 3D, mixed-element connectivity dictionaries, bare arrays
auto-typed by node count, and the same element-type -> VTK-cell-type map
(including brick20 written as linear hex, vtk type 12).
"""

from __future__ import annotations

import numpy as np

__all__ = ["to_vtk", "VTK_CELL_TYPES"]

VTK_CELL_TYPES = {
    # name: (nnodes, vtk cell type)
    "tri3": (3, 5),
    "quad4": (4, 9),
    "hex8": (8, 12),
    "tet10": (10, 24),
    "brick20": (20, 12),  # downgraded to linear hex like the reference
    # reference/Abaqus spellings
    "tri": (3, 5),
    "quad": (4, 9),
    "block": (8, 12),
    "tet": (10, 24),
    "CPS3": (3, 5),
    "C3D8R": (8, 12),
    "C3D10": (10, 24),
}

_BY_NNODES = {3: "tri3", 4: "quad4", 8: "hex8", 10: "tet10", 20: "brick20"}


def _host(a):
    """A torch tensor (any device) or array-like as a NumPy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def to_vtk(conn, X, nodal_sol=None, vtk_name="problem.vtk"):
    """Write a legacy ASCII VTK unstructured grid.

    Args:
        conn: (nelems, nn) array, or dict {etype_name: conn_array} for
            mixed meshes.
        X: (nnodes, 2|3) coordinates.
        nodal_sol: optional dict {name: (nnodes,) array} of scalars.
        vtk_name: output path.
    """
    X = np.asarray(_host(X), dtype=float)
    if not isinstance(conn, dict):
        conn = _host(conn)
        conn = {_BY_NNODES[conn.shape[1]]: conn}
    if X.shape[1] == 2:
        X = np.hstack([X, np.zeros((X.shape[0], 1))])

    nnodes = X.shape[0]
    nelems = sum(len(np.asarray(c)) for c in conn.values())
    size = sum(
        len(np.asarray(c)) * (1 + VTK_CELL_TYPES[t][0]) for t, c in conn.items()
    )

    with open(vtk_name, "w") as fh:
        fh.write("# vtk DataFile Version 3.0\n")
        fh.write("pyfem_gpu_testflight_tpu mesh\n")
        fh.write("ASCII\n")
        fh.write("DATASET UNSTRUCTURED_GRID\n")
        fh.write(f"POINTS {nnodes} double\n")
        for x in X:
            fh.write(" ".join(repr(float(v)) for v in x) + "\n")
        fh.write(f"CELLS {nelems} {size}\n")
        for etype, econn in conn.items():
            npts = VTK_CELL_TYPES[etype][0]
            for c in np.asarray(econn):
                fh.write(f"{npts} " + " ".join(str(int(n)) for n in c) + "\n")
        fh.write(f"CELL_TYPES {nelems}\n")
        for etype, econn in conn.items():
            vtk_type = VTK_CELL_TYPES[etype][1]
            fh.write("".join(f"{vtk_type}\n" for _ in range(len(np.asarray(econn)))))
        if nodal_sol:
            fh.write(f"POINT_DATA {nnodes}\n")
            for name, data in nodal_sol.items():
                fh.write(f"SCALARS {name} float 1\n")
                fh.write("LOOKUP_TABLE default\n")
                for val in _host(data).reshape(-1):
                    fh.write(f"{float(val)}\n")
    print(f"[Info] Done generating {vtk_name}")
