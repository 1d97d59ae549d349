"""Structured mesh generation and canned problem factories.

NumPy copy of ``pyfem_gpu_testflight_tpu.mesh`` (outputs bit-equal).

Reference parity: ``ProblemCreator`` (pyfem.py:2426-2773) — identical node
numbering (x fastest), element orderings, default physical dimensions,
and the three problem factories (Poisson, linear elasticity, Helmholtz).
The reference's Python triple loops are replaced by vectorized index
arithmetic; connectivities are bit-identical.

Supported element types: quad4 ("quad"), tri3 ("tri"), hex8 ("block"),
tet10 ("tet", 6 tets per 2x2x2 super-cell => even element counts), and
brick20 ("brick20", odd node counts).
"""

from __future__ import annotations

import numpy as np

__all__ = ["ProblemCreator", "structured_mesh", "fix_orientation"]


def fix_orientation(conn, X):
    """Flip negatively-oriented simplices (tri3/tet10 corners) in place.

    FEM integrals assume positive Jacobians; meshes from external tools
    (.inp imports) may carry clockwise winding, which silently negates
    the element contributions (K -> -K on a fully-flipped mesh).

    Returns:
        (conn_fixed, n_flipped).
    """
    conn = np.array(conn, copy=True)
    X = np.asarray(X)
    nn = conn.shape[1]
    if nn == 3 and X.shape[1] >= 2:  # tri3
        a = X[conn[:, 1], :2] - X[conn[:, 0], :2]
        b = X[conn[:, 2], :2] - X[conn[:, 0], :2]
        neg = (a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]) < 0
        conn[neg] = conn[neg][:, [0, 2, 1]]
        return conn, int(neg.sum())
    if nn in (4, 10) and X.shape[1] == 3:  # tet4 / tet10 corner swap
        a = X[conn[:, 1]] - X[conn[:, 0]]
        b = X[conn[:, 2]] - X[conn[:, 0]]
        c = X[conn[:, 3]] - X[conn[:, 0]]
        det = np.einsum("ij,ij->i", np.cross(a, b), c)
        neg = det < 0
        if nn == 4:
            conn[neg] = conn[neg][:, [0, 2, 1, 3]]
        else:  # tet10: swap corners 1<->2 and the affected mid-edges
            conn[neg] = conn[neg][:, [0, 2, 1, 3, 6, 5, 4, 7, 9, 8]]
        return conn, int(neg.sum())
    return conn, 0


def _grid_coords(nx, ny, nz, Lx, Ly, Lz):
    x = np.linspace(0, Lx, nx)
    y = np.linspace(0, Ly, ny)
    z = np.linspace(0, Lz, nz)
    zz, yy, xx = np.meshgrid(z, y, x, indexing="ij")  # (nz, ny, nx)
    X = np.stack([xx.ravel(), yy.ravel(), zz.ravel()], axis=-1)
    return X


def _quad_conn(nodes3d, nex, ney):
    n = nodes3d[0]
    c0 = n[:-1, :-1].ravel()
    c1 = n[:-1, 1:].ravel()
    c2 = n[1:, 1:].ravel()
    c3 = n[1:, :-1].ravel()
    return np.stack([c0, c1, c2, c3], axis=-1)


def _tri_conn(nodes3d, nex, ney):
    n = nodes3d[0]
    a = n[:-1, :-1].ravel()
    b = n[:-1, 1:].ravel()
    c = n[1:, 1:].ravel()
    d = n[1:, :-1].ravel()
    t0 = np.stack([a, b, c], axis=-1)
    t1 = np.stack([c, d, a], axis=-1)
    conn = np.empty((2 * t0.shape[0], 3), dtype=np.int64)
    conn[0::2] = t0
    conn[1::2] = t1
    return conn


def _hex_conn(nodes3d):
    n = nodes3d
    parts = [
        n[:-1, :-1, :-1], n[:-1, :-1, 1:], n[:-1, 1:, 1:], n[:-1, 1:, :-1],
        n[1:, :-1, :-1], n[1:, :-1, 1:], n[1:, 1:, 1:], n[1:, 1:, :-1],
    ]
    return np.stack([p.ravel() for p in parts], axis=-1)


# 6 tetrahedra per 2x2x2 super-cell; corner offsets in node units
# ("MATLAB Guide to Finite Elements", p. 365 decomposition; matches the
# reference's table pyfem.py:2546-2616).
_TET_CORNERS = np.array(
    [
        [[0, 0, 0], [2, 0, 0], [2, 2, 0], [2, 2, 2]],
        [[0, 0, 0], [2, 0, 0], [2, 2, 2], [0, 0, 2]],
        [[2, 0, 0], [2, 2, 2], [0, 0, 2], [2, 0, 2]],
        [[0, 0, 0], [0, 2, 0], [0, 2, 2], [2, 2, 0]],
        [[0, 0, 0], [0, 2, 2], [0, 0, 2], [2, 2, 2]],
        [[0, 0, 0], [2, 2, 2], [2, 2, 0], [0, 2, 2]],
    ]
)
# mid-edge node p (4..9) = midpoint of corner pair (pyfem.py:2625-2671)
_TET_EDGES = [(0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3)]


def _tet10_offsets():
    """(6, 10, 3) node offsets (x, y, z) within a 2x2x2 super-cell."""
    off = np.zeros((6, 10, 3), dtype=np.int64)
    off[:, :4] = _TET_CORNERS
    for p, (a, b) in enumerate(_TET_EDGES):
        off[:, 4 + p] = (_TET_CORNERS[:, a] + _TET_CORNERS[:, b]) // 2
    return off


def _tet_conn(nodes3d, nex, ney, nez, nx, ny):
    assert nex % 2 == 0 and ney % 2 == 0 and nez % 2 == 0, (
        "tet10 meshes need even element counts (odd node counts) per axis"
    )
    off = _tet10_offsets()  # (6, 10, 3)
    sx, sy, sz = nex // 2, ney // 2, nez // 2
    k0, j0, i0 = np.meshgrid(
        2 * np.arange(sz), 2 * np.arange(sy), 2 * np.arange(sx), indexing="ij"
    )
    base = np.stack([i0.ravel(), j0.ravel(), k0.ravel()], axis=-1)  # (S, 3)
    pos = base[:, None, None, :] + off[None, :, :, :]  # (S, 6, 10, 3)
    ids = pos[..., 0] + pos[..., 1] * nx + pos[..., 2] * nx * ny
    return ids.reshape(-1, 10)


_BRICK20_OFFSETS = np.array(
    [
        [0, 0, 0], [2, 0, 0], [2, 2, 0], [0, 2, 0],
        [0, 0, 2], [2, 0, 2], [2, 2, 2], [0, 2, 2],
        [1, 0, 0], [2, 1, 0], [1, 2, 0], [0, 1, 0],
        [1, 0, 2], [2, 1, 2], [1, 2, 2], [0, 1, 2],
        [0, 0, 1], [2, 0, 1], [2, 2, 1], [0, 2, 1],
    ],
    dtype=np.int64,
)


def _brick20_conn(nodes3d, nex, ney, nez, nx, ny):
    sx, sy, sz = nex // 2, ney // 2, nez // 2
    assert sx > 0 and sy > 0 and sz > 0, "brick20 meshes need odd node counts"
    k0, j0, i0 = np.meshgrid(
        2 * np.arange(sz), 2 * np.arange(sy), 2 * np.arange(sx), indexing="ij"
    )
    base = np.stack([i0.ravel(), j0.ravel(), k0.ravel()], axis=-1)
    pos = base[:, None, :] + _BRICK20_OFFSETS[None, :, :]
    ids = pos[..., 0] + pos[..., 1] * nx + pos[..., 2] * nx * ny
    return ids.reshape(-1, 20)


def structured_mesh(nnodes_x, nnodes_y, nnodes_z=None, Lx=None, Ly=None, Lz=None,
                    element_type="quad"):
    """Build (conn, X) for a structured mesh; see :class:`ProblemCreator`."""
    creator = ProblemCreator(nnodes_x, nnodes_y, nnodes_z, Lx, Ly, Lz, element_type)
    return creator.conn, creator.X


class ProblemCreator:
    """Structured mesh + canned problem factory (pyfem.py:2426-2773)."""

    def __init__(
        self,
        nnodes_x,
        nnodes_y,
        nnodes_z=None,
        Lx=None,
        Ly=None,
        Lz=None,
        element_type="quad",
    ):
        if nnodes_z is None:
            self.ndims = 2
            nnodes_z = 1
            assert element_type in ("quad", "tri")
        else:
            self.ndims = 3
            assert element_type in ("block", "tet", "brick20")

        nx, ny, nz = nnodes_x, nnodes_y, nnodes_z
        # Default aspect-ratio dims (pyfem.py:2470-2478)
        if Lx is None:
            Lx = (nx - 1) / (ny - 1)
        if Ly is None:
            Ly = 1.0
        if Lz is None:
            Lz = (nz - 1) / (ny - 1) if nz > 1 else 0.0

        X = _grid_coords(nx, ny, nz, Lx, Ly, Lz)
        nodes3d = np.arange(nx * ny * nz).reshape(nz, ny, nx)
        nex, ney, nez = nx - 1, ny - 1, nz - 1

        if element_type == "quad":
            conn = _quad_conn(nodes3d, nex, ney)
        elif element_type == "tri":
            conn = _tri_conn(nodes3d, nex, ney)
        elif element_type == "block":
            conn = _hex_conn(nodes3d)
        elif element_type == "tet":
            conn = _tet_conn(nodes3d, nex, ney, nez, nx, ny)
        elif element_type == "brick20":
            conn = _brick20_conn(nodes3d, nex, ney, nez, nx, ny)
        else:
            raise ValueError(f"unknown element_type: {element_type}")

        self.element_type = element_type
        self.nnodes_x, self.nnodes_y, self.nnodes_z = nx, ny, nz
        self.nnodes = nx * ny * nz
        self.nodes3d = nodes3d
        self.conn = conn
        self.X = X[:, : self.ndims]

    # -- problem factories ---------------------------------------------------

    def create_poisson_problem(self):
        """Fix u on the x=0 face (pyfem.py:2727-2734)."""
        dof_fixed = self.nodes3d[:, :, 0].ravel()
        return self.conn, self.X, dof_fixed

    def create_linear_elasticity_problem(self):
        """Clamp the x=0 face; unit downward tip force (pyfem.py:2736-2755)."""
        left = self.nodes3d[:, :, 0].ravel()
        dof_fixed = (self.ndims * left[:, None] + np.arange(self.ndims)).ravel()
        force = [0.0, -1.0, 0.0][: self.ndims]
        nodal_force = {int(n): list(force) for n in self.nodes3d[:, 0, -1].ravel()}
        return self.conn, self.X, dof_fixed, nodal_force

    def create_helmholtz_problem(self):
        """Checkerboard-ish density field (pyfem.py:2757-2773)."""
        nx, ny, nz = self.nnodes_x, self.nnodes_y, self.nnodes_z
        i = np.arange(nx)[None, None, :]
        j = np.arange(ny)[None, :, None]
        k = np.arange(nz)[:, None, None]
        inside = (i < nx / 2) & (j < ny / 2) & (k < nz / 2)
        x = np.where(inside, 0.95, 1e-3).ravel()
        return self.conn, self.X, x

    # Reference spelling kept for drop-in compatibility (pyfem.py:2757)
    create_helmhotz_problem = create_helmholtz_problem
