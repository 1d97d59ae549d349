"""2D stencil operator for structured quad grids (plain PyTorch).

Port of ``Stencil2D`` from ``pyfem_gpu_testflight_tpu/ops/stencil.py``.
The assembled matrix of a quad4 discretization couples each node only
to its 3x3 grid neighborhood, so the operator is fully described by
coefficient *planes* ``coeff[c, c', dy, dx][ny, nx]`` (c/c' = dof
components, dy/dx in {0,1,2} indexing the neighbor offset - 1):

    y[c] = sum_{c', dy, dx} coeff[c, c', dy, dx] * shift(u[c'], dy, dx)

This module is the plain reference both hand kernels are held against
(``fused_assemble`` for the coefficient planes, ``fused_smooth`` for the
sweeps), and assembles the planes from element matrices on the 2D
``elem_path="einsum" | "cuda"`` routes (``assemble``,
``assemble_transposed``); state vectors live as (nd, ny, nx) component
planes.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Stencil2D"]

# local node (dy, dx) offsets in the structured quad element ordering
_QUAD4_LOCAL = ((0, 0), (0, 1), (1, 1), (1, 0))


class Stencil2D:
    """Stencil form of a quad4-assembled operator on an (ny, nx) grid.

    coeff layout: (nd, nd, 3, 3, ny, nx) — indexed [c_row, c_col,
    dy+1, dx+1, iy, ix].
    """

    def __init__(self, nx: int, ny: int, nd: int):
        self.nx, self.ny, self.nd = int(nx), int(ny), int(nd)
        ndpe = 4 * nd
        plan = []
        for r in range(ndpe):
            a, ca = divmod(r, nd)
            ay, ax = _QUAD4_LOCAL[a]
            for s in range(ndpe):
                b, cb = divmod(s, nd)
                by, bx = _QUAD4_LOCAL[b]
                dy, dx = by - ay + 1, bx - ax + 1
                plan.append((ca, cb, dy, dx, ay, ax, r, s))
        self.plan = tuple(plan)

    def _assemble_blocks(self, block, like):
        """Coefficient planes from element-matrix entries ``block(r, s)``
        (each (ney, nex)): every plane is a sum of zero-padded element
        planes, in plan order — scatter-free and deterministic."""
        ny, nx, nd = self.ny, self.nx, self.nd
        table = {}
        for (ca, cb, dy, dx, ay, ax, r, s) in self.plan:
            table.setdefault((ca, cb, dy, dx), []).append((ay, ax, r, s))
        planes = []
        for ca in range(nd):
            for cb in range(nd):
                for dy in range(3):
                    for dx in range(3):
                        p = like.new_zeros((ny, nx))
                        for (ay, ax, r, s) in table.get((ca, cb, dy, dx), ()):
                            p = p + F.pad(block(r, s),
                                          (ax, 1 - ax, ay, 1 - ay))
                        planes.append(p)
        return torch.stack(planes).reshape(nd, nd, 3, 3, ny, nx)

    def assemble(self, Ke):
        """(nelems, ndpe, ndpe) element matrices (raster element order)
        -> coefficient planes (nd, nd, 3, 3, ny, nx)."""
        ney, nex = self.ny - 1, self.nx - 1
        Kg = Ke.reshape(ney, nex, Ke.shape[-2], Ke.shape[-1])
        return self._assemble_blocks(lambda r, s: Kg[:, :, r, s], Ke)

    def assemble_transposed(self, KeT):
        """(ndpe*ndpe, nelems) element-minor layout (kernel K7's output)
        -> coefficient planes."""
        ndpe = 4 * self.nd
        Kg = KeT.reshape(ndpe * ndpe, self.ny - 1, self.nx - 1)
        return self._assemble_blocks(lambda r, s: Kg[r * ndpe + s], KeT)

    def assemble_uniform(self, Cq_grid, Kq):
        """Uniform-geometry assembly: Ke[e] = sum_q Cq[e,q] Kq[q].

        Args:
            Cq_grid: (nquads, ney, nex) material factor at quad points.
            Kq: (nquads, ndpe, ndpe) unit element matrices.
        """
        ny, nx, nd = self.ny, self.nx, self.nd
        Kqh = np.asarray(torch.as_tensor(Kq).cpu())
        nq = Cq_grid.shape[0]
        # per-plane contribution table: (ca,cb,dy,dx) -> {(ay,ax): w[q]}
        table = {}
        for (ca, cb, dy, dx, ay, ax, r, s) in self.plan:
            table.setdefault((ca, cb, dy, dx), {}).setdefault(
                (ay, ax), np.zeros(nq)
            )
            table[(ca, cb, dy, dx)][(ay, ax)] += Kqh[:, r, s]
        planes = []
        for ca in range(nd):
            for cb in range(nd):
                for dy in range(3):
                    for dx in range(3):
                        p = Cq_grid.new_zeros((ny, nx))
                        for (ay, ax), w in table.get(
                            (ca, cb, dy, dx), {}
                        ).items():
                            t = sum(
                                float(w[q]) * Cq_grid[q]
                                for q in range(nq) if w[q] != 0.0
                            )
                            p = p + F.pad(t, (ax, 1 - ax, ay, 1 - ay))
                        planes.append(p)
        return torch.stack(planes).reshape(nd, nd, 3, 3, ny, nx)

    def matvec(self, coeff, u):
        """u: (..., nd, ny, nx) -> y: (..., nd, ny, nx).

        Leading batch dimensions broadcast against the coefficients
        (the coarse dense factor applies it to an identity batch).
        """
        nd, ny, nx = self.nd, self.ny, self.nx
        up = F.pad(u, (1, 1, 1, 1))
        ys = []
        for c in range(nd):
            acc = None
            for cp in range(nd):
                for dy in range(3):
                    for dx in range(3):
                        t = coeff[c, cp, dy, dx] * up[
                            ..., cp, dy : dy + ny, dx : dx + nx
                        ]
                        acc = t if acc is None else acc + t
            ys.append(acc)
        return torch.stack(ys, dim=-3)

    def bc_matvec(self, coeff, mask, u):
        """Dirichlet mask semantics on (nd, ny, nx) fields."""
        uz = torch.where(mask, 0.0, u)
        y = self.matvec(coeff, uz)
        return torch.where(mask, u, y)

    def bc_eliminate(self, coeff, mask):
        """Fold Dirichlet elimination into the coefficients.

        Returns coeff' with masked rows/columns zeroed and a unit
        diagonal at masked dofs, so the plain ``matvec(coeff', u)``
        equals ``bc_matvec(coeff, mask, u)`` exactly (the reference's
        symmetric row+column elimination, pyfem.py:780-835).
        """
        nd, ny, nx = self.nd, self.ny, self.nx
        mp = F.pad(mask, (1, 1, 1, 1))
        # colm[cb, dy, dx, iy, ix] = mask[cb, iy+dy-1, ix+dx-1]
        colm = torch.stack(
            [
                torch.stack(
                    [mp[:, dy : dy + ny, dx : dx + nx] for dx in range(3)],
                    dim=1,
                )
                for dy in range(3)
            ],
            dim=1,
        )
        rowm = mask[:, None, None, None]
        ce = torch.where(rowm | colm[None], 0.0, coeff)
        for c in range(nd):
            ce[c, c, 1, 1] = torch.where(mask[c], 1.0, ce[c, c, 1, 1])
        return ce

    def diagonal(self, coeff):
        return torch.stack([coeff[c, c, 1, 1] for c in range(self.nd)])


# hex8 local node (dz, dy, dx) offsets (mesh._hex_conn ordering)
_HEX8_LOCAL = (
    (0, 0, 0), (0, 0, 1), (0, 1, 1), (0, 1, 0),
    (1, 0, 0), (1, 0, 1), (1, 1, 1), (1, 1, 0),
)


def _neighbour_stack(mp, nz, ny, nx):
    """(..., nz+2, ny+2, nx+2) padded -> (..., 3, 3, 3, nz, ny, nx) views
    indexed [dz, dy, dx] = value at (iz+dz-1, iy+dy-1, ix+dx-1)."""
    return torch.stack([
        torch.stack([
            torch.stack([
                mp[..., dz : dz + nz, dy : dy + ny, dx : dx + nx]
                for dx in range(3)
            ], dim=-4)
            for dy in range(3)
        ], dim=-5)
        for dz in range(3)
    ], dim=-6)


class Stencil3D:
    """Stencil form of a hex8-assembled operator on an (nz, ny, nx) grid.

    Port of ``Stencil3D`` from the JAX package.  coeff layout:
    (nd, nd, 3, 3, 3, nz, ny, nx) — indexed [c_row, c_col, dz+1, dy+1,
    dx+1, iz, iy, ix]; state fields are (nd, nz, ny, nx).
    """

    def __init__(self, nx: int, ny: int, nz: int, nd: int):
        self.nx, self.ny, self.nz, self.nd = int(nx), int(ny), int(nz), int(nd)
        ndpe = 8 * nd
        plan = []
        for r in range(ndpe):
            a, ca = divmod(r, nd)
            az, ay, ax = _HEX8_LOCAL[a]
            for s in range(ndpe):
                b, cb = divmod(s, nd)
                bz, by, bx = _HEX8_LOCAL[b]
                plan.append(
                    (ca, cb, bz - az + 1, by - ay + 1, bx - ax + 1,
                     az, ay, ax, r, s)
                )
        self.plan = tuple(plan)

    def assemble(self, Ke):
        """(nelems, ndpe, ndpe) element matrices (raster element order)
        -> coefficient planes (nd, nd, 3, 3, 3, nz, ny, nx): every plane
        a sum of zero-padded element planes, in plan order (scatter-free
        and deterministic, as ``Stencil2D.assemble``)."""
        nz, ny, nx, nd = self.nz, self.ny, self.nx, self.nd
        Kg = Ke.reshape(nz - 1, ny - 1, nx - 1, Ke.shape[-2], Ke.shape[-1])
        table = {}
        for (ca, cb, dz, dy, dx, az, ay, ax, r, s) in self.plan:
            table.setdefault((ca, cb, dz, dy, dx), []).append(
                (az, ay, ax, r, s))
        planes = []
        for key in itertools.product(range(nd), range(nd), range(3),
                                     range(3), range(3)):
            p = Ke.new_zeros((nz, ny, nx))
            for (az, ay, ax, r, s) in table.get(key, ()):
                p = p + F.pad(Kg[..., r, s], (ax, 1 - ax, ay, 1 - ay,
                                              az, 1 - az))
            planes.append(p)
        return torch.stack(planes).reshape(nd, nd, 3, 3, 3, nz, ny, nx)

    def assemble_uniform(self, Cq_grid, Kq):
        """Uniform-geometry assembly: Ke[e] = sum_q Cq[e,q] Kq[q].

        Args:
            Cq_grid: (nquads, nez, ney, nex) material factor at quad points.
            Kq: (nquads, ndpe, ndpe) unit element matrices.
        """
        nz, ny, nx, nd = self.nz, self.ny, self.nx, self.nd
        Kqh = np.asarray(torch.as_tensor(Kq).cpu())
        nq = Cq_grid.shape[0]
        table = {}
        for (ca, cb, dz, dy, dx, az, ay, ax, r, s) in self.plan:
            table.setdefault((ca, cb, dz, dy, dx), {}).setdefault(
                (az, ay, ax), np.zeros(nq)
            )
            table[(ca, cb, dz, dy, dx)][(az, ay, ax)] += Kqh[:, r, s]
        planes = []
        for ca in range(nd):
            for cb in range(nd):
                for dz in range(3):
                    for dy in range(3):
                        for dx in range(3):
                            p = Cq_grid.new_zeros((nz, ny, nx))
                            for (az, ay, ax), w in table.get(
                                (ca, cb, dz, dy, dx), {}
                            ).items():
                                t = sum(
                                    float(w[q]) * Cq_grid[q]
                                    for q in range(nq) if w[q] != 0.0
                                )
                                p = p + F.pad(t, (ax, 1 - ax, ay, 1 - ay,
                                                  az, 1 - az))
                            planes.append(p)
        return torch.stack(planes).reshape(nd, nd, 3, 3, 3, nz, ny, nx)

    def matvec(self, coeff, u):
        """u: (..., nd, nz, ny, nx) -> y: (..., nd, nz, ny, nx).

        Leading batch dimensions broadcast against the coefficients
        (the coarse dense factor applies it to an identity batch).
        """
        nd, nz, ny, nx = self.nd, self.nz, self.ny, self.nx
        up = F.pad(u, (1, 1, 1, 1, 1, 1))
        ys = []
        for c in range(nd):
            acc = None
            for cp in range(nd):
                for dz in range(3):
                    for dy in range(3):
                        for dx in range(3):
                            t = coeff[c, cp, dz, dy, dx] * up[
                                ..., cp, dz : dz + nz, dy : dy + ny,
                                dx : dx + nx
                            ]
                            acc = t if acc is None else acc + t
            ys.append(acc)
        return torch.stack(ys, dim=-4)

    def bc_matvec(self, coeff, mask, u):
        """Dirichlet mask semantics on (nd, nz, ny, nx) fields."""
        uz = torch.where(mask, 0.0, u)
        y = self.matvec(coeff, uz)
        return torch.where(mask, u, y)

    def bc_eliminate(self, coeff, mask):
        """3D analogue of :meth:`Stencil2D.bc_eliminate`."""
        nd, nz, ny, nx = self.nd, self.nz, self.ny, self.nx
        colm = _neighbour_stack(F.pad(mask, (1, 1, 1, 1, 1, 1)), nz, ny, nx)
        rowm = mask[:, None, None, None, None]
        ce = torch.where(rowm | colm[None], 0.0, coeff)
        for c in range(nd):
            ce[c, c, 1, 1, 1] = torch.where(mask[c], 1.0, ce[c, c, 1, 1, 1])
        return ce

    def diagonal(self, coeff):
        return torch.stack([coeff[c, c, 1, 1, 1] for c in range(self.nd)])
