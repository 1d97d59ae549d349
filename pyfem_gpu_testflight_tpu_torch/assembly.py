"""Global assembly: dof numbering, sparsity pattern, segment sums, SpMV.

Port of ``pyfem_gpu_testflight_tpu/assembly.py``.

* Every scatter is a deterministic segment sum over a static, sorted
  index computed once (:class:`SortedSegments`): the entries are
  permuted into segment order and reduced by ``torch.segment_reduce``.
  No ``index_add_`` / ``scatter_add_``, whose CUDA form sums with float
  atomics in a run-dependent order, so two applications to the same
  input are bit-identical on the card.
* The Krylov path never forms the global matrix: the operator is
  gather -> batched element product -> segment sum (:func:`elem_matvec`);
  its sorted index has one entry per element dof.
* :class:`SparsityPattern` (rows, cols, CSR indptr of the assembled
  matrix) is built on the host (``native`` or NumPy) and serves the
  scipy export of the ``direct`` and ``amg`` solves (:func:`assemble_values`,
  :func:`scipy_csr`); models build it lazily.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "make_conn_dof",
    "SortedSegments",
    "segment_sum",
    "SparsityPattern",
    "assemble_values",
    "scipy_csr",
    "elem_matvec",
    "bc_elem_matvec",
    "elem_diagonal",
    "assemble_vector",
]


def make_conn_dof(conn: np.ndarray, ndof_per_node: int) -> np.ndarray:
    """Element dof connectivity with interleaved components.

    dof = node * ndof_per_node + component (the reference's
    utils.py:268-298).

    Returns:
        (nelems, nnodes_per_elem * ndof_per_node) int32 array.
    """
    conn = np.asarray(conn)
    if ndof_per_node == 1:
        return conn.astype(np.int32)
    nelems, nn = conn.shape
    conn_dof = np.empty((nelems, nn * ndof_per_node), dtype=np.int32)
    for axis in range(ndof_per_node):
        conn_dof[:, axis::ndof_per_node] = ndof_per_node * conn + axis
    return conn_dof


class SortedSegments:
    """A static segment-id array prepared for deterministic sums.

    ``sum(data)[s] = sum of data[i] over i with ids[i] == s``, taken in
    a fixed order (the stable sort of ``ids``), so the result does not
    depend on the run.  Built once per index (one sort), on the device
    the data will live on.

    Args:
        ids: integer segment id per entry (any shape; flattened).
        num_segments: number of output segments; segments no entry
            names sum to 0.
    """

    def __init__(self, ids, num_segments: int, device=None):
        ids = torch.as_tensor(ids, device=device).reshape(-1).long()
        self.num_segments = int(num_segments)
        self.size = int(ids.numel())
        self.order = torch.argsort(ids, stable=True)
        self.lengths = torch.bincount(ids, minlength=self.num_segments)

    def sum(self, data):
        """Segment sums of ``data`` (``size`` entries) -> (num_segments,).

        Complex data (the complex-step probes) is summed as its real
        view, ``torch.segment_reduce`` having no complex kernel: the real
        and imaginary parts in the same fixed order as real data.
        """
        flat = data.reshape(-1)
        if flat.numel() != self.size:
            raise ValueError(f"{flat.numel()} entries for {self.size} ids")
        if not flat.is_complex():
            return torch.segment_reduce(flat[self.order], "sum",
                                        lengths=self.lengths, unsafe=True)
        parts = torch.view_as_real(flat[self.order])  # (size, 2)
        out = torch.segment_reduce(parts, "sum", lengths=self.lengths,
                                   axis=0, unsafe=True)
        return torch.view_as_complex(out.contiguous())


def segment_sum(data, segment_ids, num_segments):
    """``jax.ops.segment_sum`` with a deterministic order.

    ``segment_ids`` is an integer tensor (sorted here, on every call)
    or a prebuilt :class:`SortedSegments` (the hot path).
    """
    if not isinstance(segment_ids, SortedSegments):
        segment_ids = SortedSegments(segment_ids, num_segments,
                                     device=data.device)
    if segment_ids.num_segments != int(num_segments):
        raise ValueError(f"segments built for {segment_ids.num_segments}, "
                         f"asked for {num_segments}")
    return segment_ids.sum(data)


class SparsityPattern:
    """Static CSR pattern of the global sparse matrix (host, NumPy).

    Built once per (mesh, ndof_per_node); ``seg_ids`` maps each
    flattened element-matrix entry (row-major within each element, as
    ``Ke.reshape(-1)``, pyfem.py:838-858) to its unique nonzero slot.
    The expansion and the sorted unique run in the native C++ helper
    (``native``: OpenMP, a row-bucketed unique), or in NumPy where it
    cannot be built, with identical results, as in the JAX package
    (``assembly.py:69-79``); every diagonal entry gets a slot, so
    unreferenced dofs (brick20 super-cell centers, pyfem.py:683) keep BC
    application and Jacobi well defined.
    """

    def __init__(self, conn_dof: np.ndarray, ndof_total: int):
        from . import native

        conn_dof = np.ascontiguousarray(conn_dof, dtype=np.int64)
        ii, jj = native.expand_pattern(conn_dof)
        unique_keys, seg_ids = native.unique_inverse(
            ii * ndof_total + jj, rows=ii, nrows=ndof_total)
        seg_ids = seg_ids.reshape(-1)
        diag_keys = np.arange(ndof_total, dtype=np.int64) * (ndof_total + 1)
        # diagonal keys absent from the sorted unique keys (a binary
        # search, not setdiff1d's sort of both)
        pos = np.minimum(np.searchsorted(unique_keys, diag_keys),
                         max(unique_keys.size - 1, 0))
        missing = (diag_keys if unique_keys.size == 0
                   else diag_keys[unique_keys[pos] != diag_keys])
        if missing.size:
            merged = np.concatenate([unique_keys, missing])
            order = np.argsort(merged, kind="stable")
            rank = np.empty_like(order)
            rank[order] = np.arange(merged.shape[0])
            seg_ids = rank[seg_ids]
            unique_keys = merged[order]
        self.ndof_total = int(ndof_total)
        self.nnz = int(unique_keys.shape[0])
        self.rows = (unique_keys // ndof_total).astype(np.int32)
        self.cols = (unique_keys % ndof_total).astype(np.int32)
        self.seg_ids = seg_ids.astype(np.int64)
        self.diag_pos = np.searchsorted(unique_keys, diag_keys).astype(np.int32)
        self.indptr = np.zeros(ndof_total + 1, dtype=np.int64)
        self.indptr[1:] = np.cumsum(np.bincount(self.rows,
                                                minlength=ndof_total))
        self._segments = {}

    def segments(self, device):
        """:class:`SortedSegments` of ``seg_ids`` on ``device`` (cached)."""
        device = torch.device(device)
        if device not in self._segments:
            self._segments[device] = SortedSegments(self.seg_ids, self.nnz,
                                                    device=device)
        return self._segments[device]


def assemble_values(Ke, pattern: SparsityPattern):
    """Sum element matrices (nelems, ndpe, ndpe) into the (nnz,) values
    aligned with ``pattern.rows`` / ``pattern.cols``."""
    return pattern.segments(Ke.device).sum(Ke)


def scipy_csr(values, pattern: SparsityPattern):
    """Host scipy CSR matrix from assembled values (the direct path)."""
    from scipy import sparse

    vals = values.detach().cpu().numpy() if torch.is_tensor(values) else \
        np.asarray(values)
    return sparse.csr_matrix(
        (vals, pattern.cols, pattern.indptr),
        shape=(pattern.ndof_total, pattern.ndof_total),
    )


def elem_matvec(Ke, conn_dof, u, ndof_total: int, segments=None):
    """Matrix-free SpMV y = K u: gather -> batched element product ->
    deterministic segment sum.

    Args:
        Ke: (nelems, ndpe, ndpe).
        conn_dof: (nelems, ndpe) integer tensor.
        u: (ndof_total,).
        segments: :class:`SortedSegments` of ``conn_dof`` (built here
            when None).
    """
    fe = torch.bmm(Ke, u[conn_dof].unsqueeze(-1))
    return segment_sum(fe, conn_dof if segments is None else segments,
                       ndof_total)


def bc_elem_matvec(data, u):
    """Dirichlet-constrained matrix-free operator.

    ``data = (Ke, conn_dof, mask[, segments])``; fixed rows/cols act as
    the identity (see bcs.py for the algebra).
    """
    Ke, conn_dof, mask = data[:3]
    segments = data[3] if len(data) > 3 else None
    uz = torch.where(mask, 0.0, u)
    y = elem_matvec(Ke, conn_dof, uz, u.shape[0], segments)
    return torch.where(mask, u, y)


def elem_diagonal(Ke, conn_dof, ndof_total: int, segments=None):
    """Diagonal of the assembled matrix, computed matrix-free."""
    return segment_sum(torch.diagonal(Ke, dim1=1, dim2=2),
                       conn_dof if segments is None else segments,
                       ndof_total)


def assemble_vector(fe, conn_dof, ndof_total: int, segments=None):
    """Sum element vectors (nelems, ndpe) into the global vector.

    Deterministic replacement for the reference's ``np.add.at`` loop
    (pyfem.py:860-875); like the JAX package it scatters every element
    column (right where nquads != nnodes_per_elem).
    """
    return segment_sum(fe, conn_dof if segments is None else segments,
                       ndof_total)
