"""DIA (diagonal / stencil) sparse operator, and dof-vector reorderings.

Port of ``pyfem_gpu_testflight_tpu/ops/dia.py``.  A mesh with banded dof
numbering (structured grids from ``ProblemCreator``, or any mesh after a
bandwidth-reducing reordering) has a small fixed set of
column-minus-row offsets — 2D quad4 elasticity has 21.  Stored as dense
diagonals, the product is

    y = sum_k  dia[k, :] * u_padded[off_k : off_k + ndof]

which here is kernel U2 (``ops.spmv.dia_matvec``: one launch for all
diagonals; its plain version on CPU tensors).  Two assembly routes:

* general meshes: one deterministic segment sum
  (``assembly.SortedSegments``) over slot ids ``off_idx * ndof + row``;
* structured 2D grids: analytic offsets and scatter-free strided
  slice-adds (:class:`StructuredDia2D`), in the interleaved or the planar
  dof layout.

On an unstructured mesh the band's diagonals are mostly zero, so the
port's AMG (``unstructured``) keeps its levels as CSR; this operator
serves its own API and structured grids.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device

__all__ = ["DiaOperator", "StructuredDia2D", "build_dia", "structured_dia_2d",
           "interleave_to_planar", "planar_to_interleave"]


class DiaOperator:
    """Assembled-diagonal operator with BC mask semantics.

    Construct either from an explicit offsets list
    (``DiaOperator.from_offsets`` — O(1) host work; pairs with
    :class:`StructuredDia2D` assembly) or from ``conn_dof`` (general
    path; builds the segment-sum slot map).

    Attributes:
        offsets: (noffs,) sorted int column-minus-row offsets (host).
        segments: ``assembly.SortedSegments`` of the slots
            ``off_idx * ndof + row`` of every flattened element-matrix
            entry, on ``device`` (None for from_offsets).
    """

    def __init__(self, conn_dof=None, ndof=None, max_offsets: int = 256,
                 _offsets=None, device=None):
        self.ndof = int(ndof)
        self.segments = None
        if _offsets is not None:
            offsets = np.asarray(sorted(int(o) for o in set(_offsets)))
        else:
            from ..assembly import SortedSegments

            conn_dof = np.asarray(conn_dof, dtype=np.int64)
            ndpe = conn_dof.shape[1]
            rows = np.repeat(conn_dof, ndpe, axis=1).ravel()
            cols = np.tile(conn_dof, (1, ndpe)).ravel()
            offs = cols - rows
            # offsets span a small range (the bandwidth): an O(n)
            # bincount and a lookup table instead of a sort
            omin, omax = int(offs.min()), int(offs.max())
            span = omax - omin + 1
            if span <= 1 << 22:
                present = np.bincount(offs - omin, minlength=span) > 0
                offsets = np.nonzero(present)[0] + omin
                lut = np.full(span, -1, dtype=np.int64)
                lut[offsets - omin] = np.arange(offsets.size)
                off_idx = lut[offs - omin]
            else:  # pathological numbering: sort-based unique
                offsets, off_idx = np.unique(offs, return_inverse=True)
            if offsets.size <= max_offsets:
                self.segments = SortedSegments(
                    off_idx * self.ndof + rows, offsets.size * self.ndof,
                    device=resolve_device(device))
        if offsets.size > max_offsets:
            raise ValueError(
                f"mesh numbering yields {offsets.size} diagonals "
                f"(> {max_offsets}); use the segment_sum path or reorder "
                f"the mesh"
            )
        self.offsets = offsets
        self.noffs = int(offsets.size)
        # padding that keeps every shifted slice in bounds (JAX layout)
        self.lo = int(-min(offsets.min(), 0))
        self.hi = int(max(offsets.max(), 0))
        self._dev_offsets = {}

    @classmethod
    def from_offsets(cls, offsets, ndof, max_offsets: int = 256):
        return cls(None, ndof, max_offsets, _offsets=offsets)

    def assemble(self, Ke):
        """(noffs, ndof) diagonal array from element matrices."""
        if self.segments is None:
            raise ValueError(
                "operator built from_offsets has no segment map; use a "
                "StructuredDia2D assembler"
            )
        return self.segments.sum(Ke).reshape(self.noffs, self.ndof)

    def offsets_on(self, device):
        """The offsets as an int32 tensor on ``device`` (cached)."""
        device = torch.device(device)
        if device not in self._dev_offsets:
            self._dev_offsets[device] = torch.as_tensor(
                self.offsets.astype(np.int32), device=device)
        return self._dev_offsets[device]

    def matvec(self, dia, u):
        """y = A u (kernel U2 on a CUDA tensor)."""
        from .spmv import dia_matvec

        return dia_matvec(self.offsets_on(u.device), dia, u)

    def bc_matvec(self, dia, mask, u):
        """Dirichlet-constrained matvec (same algebra as bcs.py), U2's
        masked form."""
        from .spmv import dia_matvec

        return dia_matvec(self.offsets_on(u.device), dia, u, mask)

    def diagonal(self, dia):
        zero_idx = int(np.searchsorted(self.offsets, 0))
        if zero_idx >= self.noffs or self.offsets[zero_idx] != 0:
            raise ValueError("the operator has no main diagonal")
        return dia[zero_idx]


def build_dia(conn_dof, ndof, Ke=None, max_offsets: int = 256, device=None):
    """Convenience: operator (+ assembled diagonals if Ke given)."""
    op = DiaOperator(conn_dof, ndof, max_offsets,
                     device=Ke.device if Ke is not None and device is None
                     else device)
    if Ke is None:
        return op
    return op, op.assemble(Ke)


# local node (dy, dx) offsets in the structured quad element ordering
# n0=(j,i), n1=(j,i+1), n2=(j+1,i+1), n3=(j+1,i) — mesh._quad_conn
_QUAD4_LOCAL = ((0, 0), (0, 1), (1, 1), (1, 0))


def _structured_plan(nx, ny, nd, layout):
    """[(offset, ay, ax, ca, r, s)] for every element-matrix entry.

    layout "interleaved": dof = (iy*nx + ix)*nd + c (matches
    assembly.make_conn_dof).  layout "planar": dof = c*nx*ny + iy*nx + ix
    — component-major planes.
    """
    ndpe = 4 * nd
    plan = []
    for r in range(ndpe):
        a, ca = divmod(r, nd)
        ay, ax = _QUAD4_LOCAL[a]
        for s in range(ndpe):
            b, cb = divmod(s, nd)
            by, bx = _QUAD4_LOCAL[b]
            node_off = (by - ay) * nx + (bx - ax)
            if layout == "interleaved":
                off = nd * node_off + (cb - ca)
            else:
                off = (cb - ca) * nx * ny + node_off
            plan.append((off, ay, ax, ca, r, s))
    return plan


def structured_dia_2d(nx, ny, nd, max_offsets: int = 256,
                      layout="interleaved"):
    """(DiaOperator, StructuredDia2D) for an (ny, nx) quad grid.

    Offsets derived analytically — no index arrays, O(ndpe^2) host work.
    """
    plan = _structured_plan(nx, ny, nd, layout)
    op = DiaOperator.from_offsets(
        [p[0] for p in plan], nd * nx * ny, max_offsets
    )
    return op, StructuredDia2D(op, nx, ny, nd, layout)


def interleave_to_planar(u, nd):
    """dof reorder (node-major, comp-minor) -> (comp, node) planes."""
    return u.reshape(-1, nd).t().reshape(-1)


def planar_to_interleave(u, nd):
    return u.reshape(nd, -1).t().reshape(-1)


class StructuredDia2D:
    """Scatter-free DIA assembly on structured 2D quad grids.

    On a structured row-major quad mesh every (local row, local col)
    pair of the element matrix lands on a fixed diagonal and a
    contiguous (ney, nex) window of the dof grid, so assembly is ndpe^2
    strided slice-adds, no scatter.  Produces values equal (up to the
    order of additions) to ``DiaOperator.assemble`` for the same mesh.
    """

    def __init__(self, op: DiaOperator, nx: int, ny: int, nd: int,
                 layout="interleaved"):
        self.op = op
        self.nx, self.ny, self.nd = int(nx), int(ny), int(nd)
        self.layout = layout
        off_lookup = {int(o): i for i, o in enumerate(op.offsets)}
        self.plan = tuple(
            (off_lookup[off], ay, ax, ca, r, s)
            for (off, ay, ax, ca, r, s) in _structured_plan(nx, ny, nd, layout)
        )

    def _assemble(self, entry, dtype, device):
        ny, nx, nd = self.ny, self.nx, self.nd
        ney, nex = ny - 1, nx - 1
        if self.layout == "interleaved":
            dia = torch.zeros((self.op.noffs, ny, nx, nd), dtype=dtype,
                              device=device)
            for (oi, ay, ax, ca, r, s) in self.plan:
                dia[oi, ay:ay + ney, ax:ax + nex, ca] += entry(r, s)
        else:  # planar: (ny, nx) slices per component
            dia = torch.zeros((self.op.noffs, nd, ny, nx), dtype=dtype,
                              device=device)
            for (oi, ay, ax, ca, r, s) in self.plan:
                dia[oi, ca, ay:ay + ney, ax:ax + nex] += entry(r, s)
        return dia.reshape(self.op.noffs, self.op.ndof)

    def assemble(self, Ke):
        """(nelems, ndpe, ndpe) -> (noffs, ndof)."""
        Kg = Ke.reshape(self.ny - 1, self.nx - 1, Ke.shape[1], Ke.shape[2])
        return self._assemble(lambda r, s: Kg[:, :, r, s], Ke.dtype,
                              Ke.device)

    def assemble_transposed(self, KeT):
        """(ndpe*ndpe, nelems) layout (the element kernels' KeT)."""
        ndpe = 4 * self.nd
        Kg = KeT.reshape(ndpe * ndpe, self.ny - 1, self.nx - 1)
        return self._assemble(lambda r, s: Kg[r * ndpe + s], KeT.dtype,
                              KeT.device)
