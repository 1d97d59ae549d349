"""Accelerated solves on unstructured (.inp) meshes (PyTorch port).

Port of ``pyfem_gpu_testflight_tpu/unstructured.py``: the reference's
pyamg smoothed-aggregation preconditioner (pyfem.py:2392-2400) as a host
set-up and a device V-cycle inside a device PCG.

* **RCM band reordering** (scipy reverse_cuthill_mckee on the node
  graph, expanded to dofs so components stay interleaved);
* **smoothed aggregation** (Vanek/Mandel/Brezina): greedy node
  aggregation (``native``), tentative prolongator from a per-aggregate
  QR of the near-nullspace (rigid-body modes — translations + rotations
  — when node coordinates are given), prolongator smoothing
  P = (I - (4/3 / lambda_max) D^-1 A) T, Galerkin products in scipy.
  The host set-up follows the JAX package's step for step, so one matrix
  gives both packages the same hierarchy (``n``, ``J_dof``, ``Tv``,
  ``lam``, ``w_sm`` on every level);
* the **V-cycle runs on the device**: Chebyshev (or damped-Jacobi)
  smoothing, T as one gather and a row contraction, T^T as one
  deterministic segment sum (``assembly.SortedSegments``, never
  ``index_add_``), P and P^T through the level's own product, and a
  dense Cholesky factor at the coarsest level (factored once per set-up
  by ``torch.linalg.cholesky_ex``, which does not sync the host);
* **AMG-preconditioned CG** on the device (:func:`amg_pcg`), in blocks
  of ``solvers.CHECK_EVERY`` iterations with one flag read back per
  block and the iterations past convergence masked, so its iterates
  and count are the JAX ``lax.while_loop``'s.

Level storage differs from the JAX package's: every level's operator is
CSR on the device (int32 ``indptr`` / ``indices``, values in the
cycle's dtype) for kernel U1 (``ops.spmv.csr_matvec``).  The JAX DIA
layout suits a TPU, where gathers are slow, but after RCM an
unstructured band is 0.3-2% full (the 1M-dof torque arm: 1,031
diagonals, ~14 nonzeros a row), so a DIA product would read 30-80 times
the bytes.  Each level's diagonals are still counted, and the JAX
``max_offsets`` refusal is kept for parity: both packages accept and
refuse the same inputs.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from . import solvers
from .assembly import SortedSegments
from .device import resolve_device
from .ops.dia import DiaOperator
from .ops.spmv import csr_matvec

__all__ = ["AMGPreconditioner", "amg_pcg", "rcm_permutation", "csr_to_dia",
           "rigid_body_modes"]

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _torch_dtype(dtype):
    """A torch dtype from a torch or numpy dtype (or None)."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.float32): torch.float32,
            np.dtype(np.float64): torch.float64}[np.dtype(dtype)]


def rcm_permutation(A_csr):
    """Reverse Cuthill-McKee ordering of a symmetric sparsity graph."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    return np.asarray(reverse_cuthill_mckee(A_csr, symmetric_mode=True))


def _unique_offsets(offs):
    """np.unique of column-minus-row offsets: a bincount over their span
    (at most 2n - 1) in O(nnz), the band being narrow after RCM."""
    if offs.size == 0:
        return offs
    omin, omax = int(offs.min()), int(offs.max())
    if omax - omin > 4 * offs.size:
        return np.unique(offs)
    return np.flatnonzero(np.bincount(offs - omin)) + omin


def _offsets_of(A, max_offsets, offsets=None):
    """(offsets, offs, coo) of a host matrix: its sorted diagonal offsets,
    each entry's offset and the matrix as COO, refusing more than
    ``max_offsets`` diagonals (the JAX ``csr_to_dia`` gate)."""
    A = A.tocoo()
    offs = A.col.astype(np.int64) - A.row
    if offsets is None:
        offsets = _unique_offsets(offs)
    else:
        offsets = np.asarray(offsets)
        if not np.isin(offs, offsets).all():
            raise AssertionError("matrix pattern changed: new diagonals "
                                 "not in the cached offset set")
    if offsets.size > max_offsets:
        raise ValueError(
            f"matrix has {offsets.size} diagonals (> {max_offsets}); "
            "reorder (RCM) first or raise max_offsets"
        )
    return offsets, offs, A


def csr_to_dia(A_csr, dtype, max_offsets=2048, offsets=None, device=None):
    """(DiaOperator, values (noffs, n), offsets) from a host CSR matrix.

    Pass ``offsets`` from a previous call to reuse the (sparsity-
    determined) diagonal pattern.  The values land on ``device`` (None:
    the CUDA card) in ``dtype``.
    """
    # duplicates summed first (the JAX np.add.at), then one assignment
    A_csr = A_csr.tocsr(copy=True)
    A_csr.sum_duplicates()
    offsets, offs, A = _offsets_of(A_csr, max_offsets, offsets)
    n = A.shape[0]
    op = DiaOperator.from_offsets(offsets, n, max_offsets=max_offsets)
    vals = np.zeros((offsets.size, n), dtype=_NP_DTYPES[_torch_dtype(dtype)])
    vals[np.searchsorted(offsets, offs), A.row] = A.data
    return op, torch.as_tensor(vals, device=resolve_device(device)), offsets


def rigid_body_modes(coords, nd):
    """Near-nullspace basis B (ndof, m): translations + rotations.

    2D (nd=2): [e_x, e_y, (-y, x)] -> m=3; 3D (nd=3): 3 translations +
    3 rotations -> m=6; scalar problems: the constant -> m=1.
    """
    coords = np.asarray(coords, dtype=np.float64)
    n = coords.shape[0]
    if nd == 1:
        return np.ones((n, 1))
    c = coords - coords.mean(axis=0)
    if nd == 2:
        B = np.zeros((n, 2, 3))
        B[:, 0, 0] = 1.0
        B[:, 1, 1] = 1.0
        B[:, 0, 2] = -c[:, 1]
        B[:, 1, 2] = c[:, 0]
        return B.reshape(2 * n, 3)
    B = np.zeros((n, 3, 6))
    for k in range(3):
        B[:, k, k] = 1.0
    B[:, 0, 3], B[:, 1, 3] = -c[:, 1], c[:, 0]   # rot z
    B[:, 1, 4], B[:, 2, 4] = -c[:, 2], c[:, 1]   # rot x
    B[:, 0, 5], B[:, 2, 5] = c[:, 2], -c[:, 0]   # rot y
    return B.reshape(3 * n, 6)


def _greedy_aggregate(A_csr):
    """Greedy BFS aggregation on the matrix graph -> agg id per node.

    The native C++ pass (``native.greedy_aggregate``) when it builds,
    else the Python loop; results are identical.
    """
    n = A_csr.shape[0]
    indptr, indices = A_csr.indptr, A_csr.indices
    from .native import greedy_aggregate

    native = greedy_aggregate(indptr, indices, n)
    if native is not None:
        return native
    agg = np.full(n, -1, dtype=np.int64)
    next_id = 0
    for i in range(n):  # pass 1: roots with unaggregated neighborhoods
        if agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        if (agg[nbrs] >= 0).any():
            continue
        agg[i] = next_id
        agg[nbrs] = next_id
        next_id += 1
    for i in range(n):  # pass 2: attach leftovers
        if agg[i] >= 0:
            continue
        nbrs = indices[indptr[i]:indptr[i + 1]]
        done = nbrs[agg[nbrs] >= 0]
        if done.size:
            agg[i] = agg[done[0]]
        else:
            agg[i] = next_id
            next_id += 1
    return agg, next_id


def _tentative(agg_node, nd, B, n):
    """Per-aggregate QR tentative prolongator.

    Args:
        agg_node: (nnodes,) aggregate id per node.
        nd: dofs per node; B: (n, m) near-nullspace on the dofs.

    Returns:
        (J_dof, Tv, B_c): J_dof (n,) aggregate id per dof, Tv (n, m)
        row coefficients (T[i, J_dof[i]*m + c] = Tv[i, c]), and the
        coarse nullspace B_c (n_agg*m, m).

    The JAX package factors one aggregate at a time; here the aggregates
    of one size are factored together by ``np.linalg.qr`` on a stack,
    which runs the same LAPACK routine on each matrix.
    """
    m = B.shape[1]
    n_agg = int(agg_node.max()) + 1
    J_dof = np.repeat(agg_node, nd)
    Tv = np.zeros((n, m))
    B_c = np.zeros((n_agg * m, m))
    order = np.argsort(J_dof, kind="stable")
    bounds = np.searchsorted(J_dof[order], np.arange(n_agg + 1))
    sizes = np.diff(bounds)
    for k in np.unique(sizes):
        if k == 0:
            continue
        aggs = np.flatnonzero(sizes == k)
        rows = order[bounds[aggs][:, None] + np.arange(k)]  # (count, k)
        # rank-deficient aggregates (e.g. BC-isolated single nodes with
        # fewer dofs than modes): unused coarse dofs get zero T columns
        # and are regularized to identity in the Galerkin product
        Q, R = np.linalg.qr(B[rows])  # (count, k, kk), (count, kk, m)
        kk = Q.shape[2]
        Tv[rows, :kk] = Q
        cols = (aggs * m)[:, None] + np.arange(kk)
        B_c[cols] = R
    return J_dof, Tv, B_c


def _on_pattern(A, indptr, indices):
    """A's values laid out on a cached CSR pattern (a superset of A's).

    The same pattern (the rule in a loop over densities) is one
    comparison; otherwise A's entries are placed by their (row, col)
    keys and an entry outside the pattern raises.
    """
    A = A.tocsr().sorted_indices()
    if np.array_equal(A.indptr, indptr) and np.array_equal(A.indices,
                                                           indices):
        return A.data
    n = A.shape[0]
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    keys = rows * n + indices
    a_rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(A.indptr))
    a_keys = a_rows * n + A.indices
    pos = np.searchsorted(keys, a_keys)
    if not (pos < keys.size).all() or not (keys[np.minimum(
            pos, keys.size - 1)] == a_keys).all():
        raise AssertionError("matrix pattern changed: entries outside the "
                             "cached pattern")
    vals = np.zeros(keys.size, dtype=A.data.dtype)
    vals[pos] = A.data
    return vals


class _CSR:
    """A level's operator on the device: int32 pattern + values."""

    def __init__(self, indptr, indices, vals):
        self.indptr, self.indices, self.vals = indptr, indices, vals
        self.n = int(indptr.shape[0]) - 1
        self.nnz = int(indices.shape[0])

    def matvec(self, u):
        return csr_matvec(self.indptr, self.indices, self.vals, u)


def _on_device(t, device):
    """True when tensor ``t`` lies on ``device`` ("cuda" is the current
    card, whatever its index)."""
    return t.device.type == device.type and (
        device.index is None or t.device.index == device.index)


def _device_csr(A, sl, key, dtype, device):
    """A (host CSR, left unchanged) on the device, its pattern cached in
    ``sl[key]``: a value-only rebuild uploads the values only.  Returns
    (operator, whether A has the cached pattern)."""
    same = key in sl and _on_device(sl[key][0], device)
    if same:
        data = _on_pattern(A, sl[key][2], sl[key][3])
        same = data is not None and data.size == A.nnz
    else:
        A = A.tocsr().sorted_indices()
        sl[key] = (torch.as_tensor(A.indptr.astype(np.int32), device=device),
                   torch.as_tensor(A.indices.astype(np.int32), device=device),
                   A.indptr, A.indices)
        data = A.data
    ip, ix = sl[key][:2]
    vals = torch.as_tensor(data.astype(_NP_DTYPES[dtype]), device=device)
    return _CSR(ip, ix, vals), same


class AMGPreconditioner:
    """Smoothed-aggregation AMG V-cycle: host setup + device apply.

    Args:
        K_csr: BC-applied symmetric host CSR matrix.
        nd: dofs per node of the *fine* problem (components stay
            interleaved through RCM and aggregation).
        coords: optional (nnodes, dim) node coordinates — enables
            rigid-body-mode tentative prolongators (recommended for
            elasticity; scalar problems use the constant).
        dtype: device dtype of the cycle (float32 preconditioning works
            under a float64 outer CG).
        nu: damped-Jacobi smoothing sweeps (pre and post).
        coarse_n: stop coarsening below this size (dense Cholesky).
        max_offsets: the most diagonals a level may have.  The levels
            are stored as CSR; the gate is the JAX package's (whose
            levels are DIA), kept so that both refuse the same inputs.
        structure: a previous instance's ``.structure`` — reuses every
            rho-independent piece of the set-up (RCM permutations,
            aggregations, tentative-prolongator QRs, offset sets and the
            device CSR patterns); only the value-dependent work
            (Galerkin products, smoothing weights, coarse factor, the
            values' upload) reruns.
        device: where the cycle runs (None: the CUDA card).
    """

    #: fresh structural setups performed (test/diagnostic observability)
    n_structure_setups = 0

    def __init__(self, K_csr, nd=1, coords=None, dtype=torch.float32, nu=2,
                 coarse_n=800, max_levels=12, max_offsets=2048,
                 smoother="chebyshev", cheb_degree=3, structure=None,
                 device=None):
        from scipy import sparse

        self.dtype = _torch_dtype(dtype)
        self.device = resolve_device(device)
        self.nu = int(nu)
        self.smoother = smoother
        self.cheb_degree = int(cheb_degree)
        self.w_sm = []
        self.w_jac = []
        self.lam = []  # per-level rho(D^-1 A) estimate
        fresh = structure is None
        if fresh:
            structure = {"levels": []}
            AMGPreconditioner.n_structure_setups += 1
        self.structure = structure
        dev, npdt = self.device, _NP_DTYPES[self.dtype]

        def slevel(li):
            if fresh:
                structure["levels"].append({})
            return structure["levels"][li]

        def node_graph(A, nd):
            if nd == 1:
                return A.tocsr()
            C = A.tocoo()
            return sparse.csr_matrix(
                (np.ones(C.nnz), (C.row // nd, C.col // nd)),
                shape=(A.shape[0] // nd,) * 2,
            )

        def expand_perm(perm_node, nd):
            return (nd * perm_node[:, None] + np.arange(nd)).ravel()

        def lam_max(A, inv_diag, iters=12):
            rng = np.random.RandomState(0)
            v = rng.rand(A.shape[0])
            lam = 2.0
            for _ in range(iters):
                v = inv_diag * (A @ v)
                nv = np.linalg.norm(v)
                if nv == 0:
                    break
                lam, v = nv, v / nv
            return max(lam, 1e-12)

        def scalar(v):
            return torch.tensor(v, dtype=self.dtype, device=dev)

        A = K_csr.tocsr()
        if fresh:
            if coords is not None:
                B = rigid_body_modes(coords, nd)
            else:
                B = np.tile(np.eye(nd), (A.shape[0] // nd, 1))
            perm0 = expand_perm(rcm_permutation(node_graph(A, nd)), nd)
            structure["perm0"] = perm0
            structure["B0"] = B
        else:
            perm0 = structure["perm0"]
            B = structure["B0"]
        A = A[perm0][:, perm0].tocsr()
        #: the permuted fine matrix (host), amg_pcg's operator
        self.A0 = A
        B = B[perm0]
        self.perm_host = perm0
        self.perm = torch.as_tensor(perm0, device=dev)
        iperm0 = np.empty_like(perm0)
        iperm0[perm0] = np.arange(perm0.size)
        self.iperm = torch.as_tensor(iperm0, device=dev)

        levels = []
        while True:
            n = A.shape[0]
            sl = slevel(len(levels))
            op, same = _device_csr(A, sl, "csr", self.dtype, dev)
            if not same:  # a fresh or changed pattern: count its diagonals
                sl["offsets"] = _offsets_of(A, max_offsets,
                                            sl.get("offsets"))[0]
            diag = np.asarray(A.diagonal())
            inv_diag = 1.0 / np.where(diag == 0, 1.0, diag)
            lam = lam_max(A, inv_diag)
            self.lam.append(float(lam))
            self.w_sm.append(float((4.0 / 3.0) / lam))
            self.w_jac.append(float((4.0 / 3.0) / lam))
            level = {
                "op": op, "n": n,
                "inv_diag": torch.as_tensor(inv_diag.astype(npdt),
                                            device=dev),
                "lam": scalar(self.lam[-1]), "w_sm": scalar(self.w_sm[-1]),
                "w_jac": scalar(self.w_jac[-1]),
            }
            level["cheb"] = self._cheb_coeffs(level["lam"])
            if n <= coarse_n or len(levels) >= max_levels - 1:
                level["dense"] = torch.as_tensor(A.toarray().astype(npdt),
                                                 device=dev)
                levels.append(level)
                break
            m = B.shape[1]
            if fresh:
                sl["agg"] = _greedy_aggregate(node_graph(A, nd))
            agg_node, n_agg = sl["agg"]
            nc = n_agg * m
            if nc >= n:
                level["dense"] = (
                    torch.as_tensor(A.toarray().astype(npdt), device=dev)
                    if n <= 4096 else None
                )
                levels.append(level)
                break
            if fresh:
                J_dof, Tv, B_c = _tentative(agg_node, nd, B, n)
                T = sparse.csr_matrix(
                    (
                        Tv.ravel(),
                        (
                            np.repeat(np.arange(n), m),
                            (m * J_dof[:, None] + np.arange(m)).ravel(),
                        ),
                    ),
                    shape=(n, nc),
                )
                sl["tent"] = (J_dof, Tv, B_c, T)
            J_dof, Tv, B_c, T = sl["tent"]
            D_inv = sparse.diags(inv_diag)
            P = (T - self.w_sm[-1] * (D_inv @ (A @ T))).tocsr()
            Ac = (P.T @ A @ P).tocsr().sorted_indices()  # JAX: via LIL
            dz = np.where(np.asarray(Ac.diagonal()) == 0.0)[0]
            if dz.size:  # decoupled coarse dofs from zero T columns
                # scipy's products store no zeros, so a zero diagonal is
                # a missing entry: adding a unit there is the JAX
                # package's LIL assignment Ac[dz, dz] = 1
                Ac = (Ac + sparse.csr_matrix(
                    (np.ones(dz.size), (dz, dz)), shape=Ac.shape)).tocsr()
            # re-band the coarse level (aggregates = coarse "nodes" with
            # m dofs each); compose the permutation into the maps
            if fresh:
                sl["permc"] = expand_perm(
                    rcm_permutation(node_graph(Ac, m)), m
                )
            permc = sl["permc"]
            if "J_dev" not in sl or not _on_device(sl["J_dev"], dev):
                agg_perm = np.empty(n_agg, dtype=np.int64)
                agg_perm[permc[::m] // m] = np.arange(n_agg)
                Jp = agg_perm[J_dof]
                sl["J_dev"] = torch.as_tensor(Jp, device=dev)
                # T^T's deterministic segment sum: entry (i, c) of the
                # (n, m) contributions lands on coarse dof J[i]*m + c
                sl["TT"] = SortedSegments(
                    (Jp[:, None] * m + np.arange(m)).ravel(), nc,
                    device=dev)
            level["J_dof"] = sl["J_dev"]
            level["TT"] = sl["TT"]
            level["Tv"] = torch.as_tensor(Tv.astype(npdt), device=dev)
            level["n_agg"], level["m"] = n_agg, m
            levels.append(level)
            A = Ac[permc][:, permc].tocsr()
            B = B_c[permc]
            nd = m  # coarse levels have m dofs per aggregate

        # the coarsest dense level: factored once per set-up, without a
        # host sync (an indefinite factor shows as a failed solve)
        last = levels[-1]
        if last.get("dense") is not None:
            last["chol"] = torch.linalg.cholesky_ex(last["dense"])[0]
        self.levels = levels

    # -- device pieces -------------------------------------------------------

    def apply(self, r):
        """V-cycle z = M^-1 r (r in level-0 RCM ordering, cycle dtype)."""
        return self._cycle(0, r)

    def _matvec(self, k, u):
        return self.levels[k]["op"].matvec(u)

    def _smooth(self, k, x, b, niter, x0_zero=False):
        if self.smoother == "chebyshev":
            return self._cheb_smooth(k, x, b)
        lv = self.levels[k]
        inv_diag, w = lv["inv_diag"], lv["w_jac"]
        if x0_zero and niter > 0:
            # the first sweep from x = 0 is elementwise (skips one
            # product with the operator)
            x = w * inv_diag * b
            niter -= 1
        for _ in range(niter):
            x = x + w * inv_diag * (b - self._matvec(k, x))
        return x

    def _cheb_coeffs(self, lam):
        """Chebyshev recurrence scalars of a level (device, cycle dtype):
        theta and, per further degree, (rho * rho_old, 2 rho / delta) —
        the JAX cycle's own expressions, evaluated once per set-up."""
        hi = 1.1 * lam
        lo = lam / 30.0
        theta = 0.5 * (hi + lo)
        delta = 0.5 * (hi - lo)
        sigma = theta / delta
        rho_old = 1.0 / sigma
        steps = []
        for _ in range(self.cheb_degree - 1):
            rho = 1.0 / (2.0 * sigma - rho_old)
            steps.append((rho * rho_old, 2.0 * rho / delta))
            rho_old = rho
        return theta, steps

    def _cheb_smooth(self, k, x, b):
        """Chebyshev polynomial smoothing on D^-1 A (pyamg convention:
        target interval [rho/30, 1.1 rho]); one product per degree."""
        lv = self.levels[k]
        inv_diag = lv["inv_diag"]
        theta, steps = lv["cheb"]
        r = inv_diag * (b - self._matvec(k, x))
        d = r / theta
        x = x + d
        for c1, c2 in steps:
            r = inv_diag * (b - self._matvec(k, x))
            d = c1 * d + c2 * r
            x = x + d
        return x

    def _T(self, k, xc):
        """Tentative prolongation: one gather + a row-wise contraction."""
        lv = self.levels[k]
        Xc = xc.reshape(lv["n_agg"], lv["m"])
        return torch.sum(lv["Tv"] * Xc[lv["J_dof"]], dim=1)

    def _TT(self, k, s):
        lv = self.levels[k]
        return lv["TT"].sum(lv["Tv"] * s[:, None])

    def _P(self, k, xc):
        """Smoothed prolongation: (I - w D^-1 A) T xc."""
        lv = self.levels[k]
        t = self._T(k, xc)
        return t - lv["w_sm"] * (lv["inv_diag"] * self._matvec(k, t))

    def _PT(self, k, r):
        """P^T r = T^T (r - w A D^-1 r)."""
        lv = self.levels[k]
        s = r - lv["w_sm"] * self._matvec(k, lv["inv_diag"] * r)
        return self._TT(k, s)

    def _cycle(self, k, b):
        lv = self.levels[k]
        if k == len(self.levels) - 1:
            if lv.get("dense") is None:
                # smooth-to-death fallback: damped Jacobi, many sweeps
                x = torch.zeros_like(b)
                for _ in range(24):
                    x = x + lv["w_jac"] * lv["inv_diag"] * (
                        b - self._matvec(k, x))
                return x
            return torch.cholesky_solve(b[:, None], lv["chol"])[:, 0]
        x = self._smooth(k, torch.zeros_like(b), b, self.nu, x0_zero=True)
        r = b - self._matvec(k, x)
        xc = self._cycle(k + 1, self._PT(k, r))
        x = x + self._P(k, xc)
        return self._smooth(k, x, b, self.nu)


def _make_run(maxiter, dtype):
    """The PCG runner of one (maxiter, dtype, precond_dtype) key.

    ``run(A0, amg, bp, rtol, atol) -> (x, iters, resnorm)``: the JAX
    ``lax.while_loop`` (iterate while ``r.r > max(rtol*||b||, atol)^2``
    and ``k < maxiter``) in blocks of ``solvers.CHECK_EVERY`` iterations,
    one flag read back per block, the updates past convergence masked.
    """
    def run(A0, amg, bp, rtol, atol):
        normb = torch.linalg.norm(bp)
        tol2 = torch.clamp(rtol * normb, min=atol) ** 2

        def precond(r):
            return amg.apply(r.to(amg.dtype)).to(dtype)

        x = torch.zeros_like(bp)
        r = bp  # b - A 0
        z = precond(r)
        p = z
        rz = torch.dot(r, z)
        k = torch.zeros((), dtype=torch.int64, device=bp.device)
        done = False
        while not done:
            for _ in range(solvers.CHECK_EVERY):
                active = (torch.dot(r, r) > tol2) & (k < maxiter)
                Ap = A0.matvec(p)
                alpha = rz / torch.dot(p, Ap)
                x = torch.where(active, x + alpha * p, x)
                r = torch.where(active, r - alpha * Ap, r)
                z = precond(r)
                rz2 = torch.dot(r, z)
                p = torch.where(active, z + (rz2 / rz) * p, p)
                rz = torch.where(active, rz2, rz)
                k = k + active.long()
            solvers.readbacks["amg"] += 1
            done = not bool((torch.dot(r, r) > tol2) & (k < maxiter))
        return x, k, torch.sqrt(torch.dot(r, r))

    return run


def amg_pcg(K_csr, b, nd=1, coords=None, dtype=None, rtol=1e-8, atol=0.0,
            maxiter=1000, precond_dtype=None, cache=None, device=None,
            **amg_kw):
    """AMG-preconditioned CG on the device for a host-assembled CSR system.

    The pyamg-CG replacement for unstructured meshes
    (pyfem.py:2402-2422): host hierarchy set-up, device iterations.

    Args:
        dtype: the CG's dtype (default: b's); ``precond_dtype`` the
            V-cycle's (default: ``dtype``).
        cache: optional mutable dict reused across solves on the same
            mesh/pattern: ``"structure"`` (RCM, aggregates, tentative
            QRs, offset sets, device CSR patterns), ``"offsets0"`` and
            ``"pattern0"`` (the fine operator's diagonals and device
            pattern) and the PCG runner under ``"run"`` (keyed by
            ``(maxiter, dtype, precond_dtype)`` in ``"run_key"``), so
            repeated solves (topology loops) pay only the value update;
            each call leaves its host-clock seconds in ``"times"``:
            ``setup`` (hierarchy set-up and uploads) and ``pcg`` (the
            iterations, ended by the last flag's read-back), and its
            hierarchy and fine operator in ``"amg"`` and ``"A0"`` for
            inspection (replaced by the next call's).
        device: where the solve runs (None: b's device when b is a
            tensor, else the CUDA card).
        amg_kw: :class:`AMGPreconditioner` options.

    Returns:
        (x, iters, resnorm) in the original (unpermuted) ordering, device
        tensors.
    """
    if device is None and torch.is_tensor(b):
        device = b.device
    device = resolve_device(device)
    t0 = time.perf_counter()
    if dtype is None:
        dtype = b.dtype if torch.is_tensor(b) else np.asarray(b).dtype
    dtype = _torch_dtype(dtype)
    precond_dtype = _torch_dtype(precond_dtype) or dtype
    structure = cache.get("structure") if cache is not None else None
    if cache is not None:  # the last solve's hierarchy is not needed now
        cache.pop("amg", None)
        cache.pop("A0", None)
    amg = AMGPreconditioner(K_csr, nd=nd, coords=coords,
                            dtype=precond_dtype, structure=structure,
                            device=device, **amg_kw)
    if cache is None:
        cache = {}
    cache["structure"] = amg.structure
    cache["offsets0"] = _offsets_of(amg.A0, amg_kw.get("max_offsets", 2048),
                                    cache.get("offsets0"))[0]
    A0, _same = _device_csr(amg.A0, cache, "pattern0", dtype, device)

    run_key = (int(maxiter), str(dtype), str(precond_dtype))
    if cache.get("run_key") != run_key:
        cache["run"], cache["run_key"] = _make_run(int(maxiter), dtype), \
            run_key
    bp = torch.as_tensor(b, device=device).to(dtype)[amg.perm]
    t1 = time.perf_counter()
    x, k, rn = cache["run"](A0, amg, bp, rtol, atol)
    cache["times"] = {"setup": t1 - t0, "pcg": time.perf_counter() - t1}
    cache["amg"], cache["A0"] = amg, A0
    return x[amg.iperm], k, rn
