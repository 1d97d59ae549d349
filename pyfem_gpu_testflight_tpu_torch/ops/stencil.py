"""2D stencil operator for structured quad grids (plain PyTorch).

Port of ``Stencil2D`` from ``pyfem_gpu_testflight_tpu/ops/stencil.py``.
The assembled matrix of a quad4 discretization couples each node only
to its 3x3 grid neighborhood, so the operator is fully described by
coefficient *planes* ``coeff[c, c', dy, dx][ny, nx]`` (c/c' = dof
components, dy/dx in {0,1,2} indexing the neighbor offset - 1):

    y[c] = sum_{c', dy, dx} coeff[c, c', dy, dx] * shift(u[c'], dy, dx)

This module is the plain reference both hand kernels are held against
(``fused_assemble`` for the coefficient planes, ``fused_smooth`` for the
sweeps); state vectors live as (nd, ny, nx) component planes.
"""

from __future__ import annotations

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
