"""SPMD element-axis sharding over a ``torch.distributed`` process group.

Port of ``pyfem_gpu_testflight_tpu/parallel/sharding.py``.  The JAX
package shards over a 1D device ``Mesh`` with ``shard_map`` and lets XLA
emit the collectives.  Here the same SPMD program is one process per
rank of a process group, and :class:`Mesh` names the collectives it
uses:

=====================  ==========================================
JAX collective         port (:class:`Mesh`)
=====================  ==========================================
``psum``               :meth:`Mesh.all_reduce`
``ppermute`` to a      :meth:`Mesh.exchange` / :meth:`Mesh.halo`:
neighbour              one ``batch_isend_irecv`` per exchange;
                       ranks at the global ends receive zeros
``all_gather(tiled)``  :meth:`Mesh.all_gather`
                       (``all_gather_into_tensor``)
=====================  ==========================================

The transport is fixed by the backend when the mesh is built: NCCL
sends device tensors; gloo, whose point-to-point calls take CPU tensors
only, stages every exchanged slab and scalar through host buffers and
back (``Mesh.transport``).

The element-sharded models (:class:`ShardedPoisson`,
:class:`ShardedElasticity`) follow the JAX ones:

* ``conn``/``Xe``/``Ke`` are split contiguously over the ranks (padded
  to a multiple of the rank count with zero-stiffness ghost elements
  wired to dof 0);
* dof vectors stay replicated; the matrix-free product is the port's
  gather -> ``torch.bmm`` -> deterministic segment sum on the rank's
  elements, then one ``all_reduce``;
* element matrices come from the einsum route (``ops.stiffness``);
  the solve is Jacobi-PCG (``solvers.cg_loop``).
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch
import torch.distributed as dist

from ..assembly import SortedSegments, make_conn_dof
from ..elements import get_element
from ..ops import geometry, stiffness

__all__ = ["Mesh", "make_mesh", "pad_elements", "ShardedPoisson",
           "ShardedElasticity"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


class Mesh:
    """One rank's view of a 1D mesh of ranks (built by :func:`make_mesh`).

    Attributes:
        group: the process group; rank, size, backend: this rank, the
            rank count and the group's backend.
        device: this rank's device.
        axis_names: ``(axis,)``, the JAX mesh's axis name.
        transport: "device" (NCCL sends device tensors) or "host" (gloo:
            slabs and scalars staged through host buffers).
        counts: collective calls issued so far, by kind ("all_reduce",
            "exchange", "all_gather"); :meth:`reset_counts` zeroes them.
    """

    def __init__(self, group, axis, device):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.backend = str(dist.get_backend(group))
        self.device = torch.device(device)
        self.axis_names = (axis,)
        self.transport = "device" if self.backend == "nccl" else "host"
        self.counts = {"all_reduce": 0, "exchange": 0, "all_gather": 0}

    def reset_counts(self):
        for k in self.counts:
            self.counts[k] = 0

    def _send_buf(self, t):
        """A contiguous copy of ``t`` in the transport's memory."""
        t = t.detach()
        if self.transport == "host":
            return t.to("cpu", copy=True).contiguous()
        return t.clone(memory_format=torch.contiguous_format)

    def _back(self, buf, like):
        return buf.to(like.device) if self.transport == "host" else buf

    def all_reduce(self, t, op="sum"):
        """The all-rank sum (or "max") of ``t``, on ``t``'s device (the
        JAX ``psum`` / ``pmax``)."""
        buf = self._send_buf(t)
        dist.all_reduce(buf, op=_OPS[op], group=self.group)
        self.counts["all_reduce"] += 1
        return self._back(buf, t)

    def exchange(self, up, down):
        """Neighbour exchange along the rank axis (a ``ppermute`` pair).

        ``up`` goes to rank + 1 and ``down`` to rank - 1.  Returns
        ``(lo, hi)``: rank - 1's ``up`` and rank + 1's ``down``, zeros at
        the global ends (as ``ppermute`` gives them).
        """
        sup, sdown = self._send_buf(up), self._send_buf(down)
        lo, hi = torch.zeros_like(sup), torch.zeros_like(sdown)
        ops = []
        if self.rank + 1 < self.size:
            peer = dist.get_global_rank(self.group, self.rank + 1)
            ops += [dist.P2POp(dist.isend, sup, peer, self.group),
                    dist.P2POp(dist.irecv, hi, peer, self.group)]
        if self.rank > 0:
            peer = dist.get_global_rank(self.group, self.rank - 1)
            ops += [dist.P2POp(dist.isend, sdown, peer, self.group),
                    dist.P2POp(dist.irecv, lo, peer, self.group)]
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        self.counts["exchange"] += 1
        return self._back(lo, up), self._back(hi, down)

    def halo(self, a, dim, h=1):
        """``a`` extended by ``h`` slabs each side along ``dim``: the last
        ``h`` of rank - 1's block below, the first ``h`` of rank + 1's
        above (zeros at the global ends)."""
        n = a.shape[dim]
        lo, hi = self.exchange(a.narrow(dim, n - h, h), a.narrow(dim, 0, h))
        return torch.cat([lo, a, hi], dim=dim)

    def all_gather(self, t, dim=0):
        """Every rank's ``t`` concatenated along ``dim`` in rank order (the
        JAX ``all_gather(..., tiled=True)``)."""
        x = self._send_buf(t.movedim(dim, 0))
        out = x.new_empty((self.size * x.shape[0],) + tuple(x.shape[1:]))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", FutureWarning)
            dist.all_gather_into_tensor(out, x, group=self.group)
        self.counts["all_gather"] += 1
        return self._back(out, t).movedim(0, dim)


def make_mesh(n_devices=None, axis="elems", device=None, group=None):
    """The 1D mesh of an initialized process group.

    Never creates a process group: call
    ``torch.distributed.init_process_group`` first (or run under
    ``parallel.launch.run_ranks`` / ``torchrun``).

    Args:
        n_devices: the rank count expected (None: the group's); the JAX
            argument, which took the first n devices, must equal the
            group's size here.
        axis: the mesh axis name.
        device: this rank's device; None: the CUDA card
            ``cuda:(LOCAL_RANK % device_count)``, on NCCL or on gloo with
            a card; pass "cpu" to run the ranks on the CPU (gloo).
        group: the process group (default: the world).
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_mesh needs an initialized process group "
            "(torch.distributed.init_process_group)")
    group = dist.group.WORLD if group is None else group
    size = dist.get_world_size(group)
    if n_devices is not None and int(n_devices) != size:
        raise ValueError(f"n_devices={n_devices} but the process group has "
                         f"{size} ranks")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA card; pass device='cpu' to run the "
                "ranks on the CPU (gloo)")
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank(group)))
        device = torch.device("cuda", local % torch.cuda.device_count())
    device = torch.device(device)
    if str(dist.get_backend(group)) == "nccl" and device.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    return Mesh(group, axis, device)


def pad_elements(arr, n_shards, pad_value=0):
    """Pad the leading (element) axis to a multiple of ``n_shards``."""
    arr = np.asarray(arr)
    rem = (-arr.shape[0]) % n_shards
    if rem == 0:
        return arr
    pad = np.full((rem,) + arr.shape[1:], pad_value, dtype=arr.dtype)
    return np.concatenate([arr, pad], axis=0)


class _ShardedModel:
    """This rank's block of the elements; replicated dof vectors."""

    def __init__(self, mesh, X, conn, fixed_mask, ndof_per_node, etype,
                 dtype=torch.float64):
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        n = mesh.size
        self.ndof_per_node = int(ndof_per_node)
        self.nnodes = np.asarray(X).shape[0]
        self.ndof = self.nnodes * self.ndof_per_node
        self.etype = get_element(etype)
        self.dtype = dtype
        dev = mesh.device

        conn = np.asarray(conn, dtype=np.int64)
        self.nelems = conn.shape[0]
        conn_p = pad_elements(conn, n, pad_value=0)
        emask = pad_elements(np.ones((self.nelems, 1)), n, pad_value=0.0)
        ne = conn_p.shape[0] // n
        mine = slice(mesh.rank * ne, (mesh.rank + 1) * ne)
        conn_dof = make_conn_dof(conn_p, self.ndof_per_node)
        t = lambda a, dt=None: torch.as_tensor(np.asarray(a), dtype=dt,
                                               device=dev)
        self.conn = t(conn_p[mine])
        self.conn_dof = t(conn_dof[mine], torch.int64)
        self.emask = t(emask[mine], dtype)
        self.Xe = t(np.asarray(X, np.float64)[conn_p[mine]], dtype)
        self.mask = t(np.asarray(fixed_mask, bool))
        self.N = t(self.etype.shape_vals, dtype)
        self.dN = t(self.etype.shape_grads, dtype)
        self.wq = t(self.etype.quad_wts, dtype)
        self._segments = SortedSegments(self.conn_dof, self.ndof, device=dev)

    # subclasses define the per-rank element assembly
    def _local_assemble(self, rho_q):
        raise NotImplementedError

    def element_jacobian(self, rho):
        """This rank's element stiffness matrices (zero on ghosts)."""
        rho = torch.as_tensor(rho, dtype=self.dtype, device=self.mesh.device)
        rho_q = geometry.interp_to_quads(self.N, rho[self.conn])
        return self._local_assemble(rho_q) * self.emask[:, :, None]

    def _matvec(self, Ke, u):
        uz = torch.where(self.mask, 0.0, u)
        fe = torch.bmm(Ke, uz[self.conn_dof].unsqueeze(-1))
        y = self.mesh.all_reduce(self._segments.sum(fe))
        return torch.where(self.mask, u, y)

    def solve(self, rho, rhs, rtol=1e-8, maxiter=None):
        """Assemble + BC + Jacobi-PCG on every rank.

        Returns:
            (u, iters): the replicated solution and the iteration count.
        """
        from .. import solvers

        if maxiter is None:
            maxiter = 10 * self.ndof
        dev = self.mesh.device
        Ke = self.element_jacobian(rho)
        rhs = torch.as_tensor(rhs, dtype=self.dtype, device=dev)
        b = torch.where(self.mask, 0.0, rhs)
        diag = self.mesh.all_reduce(
            self._segments.sum(torch.diagonal(Ke, dim1=1, dim2=2)))
        inv_diag = 1.0 / torch.where(self.mask | (diag == 0), 1.0, diag)
        x, k, _ = solvers.cg_loop(lambda u: self._matvec(Ke, u), b,
                                  inv_diag=inv_diag, rtol=rtol,
                                  maxiter=maxiter)
        return x, k


class ShardedPoisson(_ShardedModel):
    """Element-sharded RAMP-Poisson assemble+solve (SPMD)."""

    def __init__(self, mesh, X, conn, fixed_mask, etype, p=0.0,
                 dtype=torch.float64):
        self.p = float(p)
        super().__init__(mesh, X, conn, fixed_mask, 1, etype, dtype)

    def _local_assemble(self, rho_q):
        from ..models.base import ramp

        return stiffness.poisson_stiffness(self.Xe, self.dN, self.wq,
                                           ramp(rho_q, self.p))


class ShardedElasticity(_ShardedModel):
    """Element-sharded isotropic elasticity assemble+solve (SPMD)."""

    def __init__(self, mesh, X, conn, fixed_mask, etype, E=10.0, nu=0.3,
                 p=0.0, dtype=torch.float64):
        ndims = np.asarray(X).shape[1]
        self.mu, self.lam = stiffness.lame_params(E, nu, ndims)
        self.p = float(p)
        super().__init__(mesh, X, conn, fixed_mask, ndims, etype, dtype)

    def _local_assemble(self, rho_q):
        from ..models.base import ramp

        return stiffness.elasticity_stiffness(
            self.Xe, self.dN, self.wq, ramp(rho_q, self.p), self.mu,
            self.lam)
