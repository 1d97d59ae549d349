"""Two-level p-multigrid for structured quadratic meshes (PyTorch port).

Port of ``pyfem_gpu_testflight_tpu/pmg.py``.  The quadratic operator
(tet10/brick20) is applied element by element — one batched ``Ke @ ue``
product — smoothed by Chebyshev polynomials in D^-1 A, and corrected on
the linear corner sub-grid by the 3D geometric multigrid of
``multigrid.py`` (kernel K3 assembles every corner level, K5 runs its
Jacobi smoothing calls; with ``gmg_options=dict(smoother="chebyshev")``
K4 runs the Chebyshev residual passes instead).

The corner lattice of a ``ProblemCreator`` tet10/brick20 mesh (nodes at
even (i, j, k)) is a 2:1 coarsening of the full node lattice, so the
quadratic -> linear transfer is the tent pair ``multigrid.restrict3d_il``
/ ``prolong3d_il``, and the coarse preconditioner is a hex8 GMG hierarchy
on the corner grid.  One preconditioner application is

    pre-smooth (Chebyshev-nu on the quadratic operator)
    -> residual -> restrict to corners -> one GMG V-cycle -> prolong
    -> post-smooth

driving a flexible PCG (``multigrid.pcg(flexible=True)``) on the
BC-eliminated matrix-free operator.  brick20 lattices leave nodes with
two or more odd coordinates unused; their zero rows are masked like
Dirichlet dofs throughout.

On the creator's lattice numbering the element -> node sum is
scatter-free (:meth:`PMG._lattice_matvec`): each local-node offset of
the 2x2x2 super-cell is a stride-2 view of the node grid, and the
element products are added into those views one offset after another —
no atomics, so two applications are bit-identical on the card.  Any
other numbering takes the model's ``assembly.elem_matvec``
(deterministic segment sum).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["PMG"]


class PMG:
    """p-multigrid preconditioned CG for a structured quadratic model.

    Args:
        model: ``LinearElasticity`` / ``LinearPoisson`` on a
            ``ProblemCreator`` tet10 or brick20 grid (zero Dirichlet
            values only).
        nnodes_x/y/z: node-lattice extents (odd, ``nx*ny*nz == nnodes``).
        nu: Chebyshev smoothing degree per pre/post leg.
        cheb_lam: spectral bound of D^-1 A; measured by a power
            iteration on the first solve when None.
        cheb_frac: the smoothing interval is [cheb_lam/cheb_frac,
            1.1 cheb_lam].
        gmg_options: forwarded to the corner-grid ``GMGAssembler3D``
            (``omega``, ``smoother``, ``smoother_dtype``, ``sym``, ...).
            The JAX package's TPU knobs (``pallas_smooth``,
            ``pallas_tz``, ...) are not taken: passing one raises
            ``TypeError``.

    Raises:
        ValueError: where the JAX package asserts (element type, lattice
            extents, even extents, nonzero Dirichlet values), with its
            messages.
    """

    def __init__(self, model, nnodes_x, nnodes_y, nnodes_z, nu=3,
                 cheb_lam=None, cheb_frac=30.0, gmg_options=None):
        from .multigrid import GMGAssembler3D

        nx, ny, nz = int(nnodes_x), int(nnodes_y), int(nnodes_z)
        if model.etype.name not in ("tet10", "brick20"):
            raise ValueError(model.etype.name)
        if nx * ny * nz != model.nnodes:
            raise ValueError((nx * ny * nz, model.nnodes))
        if not (nx % 2 and ny % 2 and nz % 2):
            raise ValueError("corner lattice needs odd n")
        if bool(model.bc.values.any()):
            raise ValueError("pmg supports zero Dirichlet values only")
        self.model = model
        self.nd = nd = model.ndof_per_node
        self.shape = (nz, ny, nx)
        self.cshape = ((nz + 1) // 2, (ny + 1) // 2, (nx + 1) // 2)
        self.nu = int(nu)
        self.cheb_frac = float(cheb_frac)
        self._cheb_lam = cheb_lam

        # dead lattice dofs (brick20: nodes with >= 2 odd coordinates are
        # unreferenced) fold into the Dirichlet mask
        used = np.zeros(model.nnodes, bool)
        used[model.conn_host.ravel()] = True
        mask_np = model.bc.mask.cpu().numpy() | np.repeat(~used, nd)
        self.mask_all = torch.as_tensor(mask_np, device=model.device)
        corner_mask = mask_np.reshape(nz * ny * nx, nd).T.reshape(
            nd, nz, ny, nx)[:, ::2, ::2, ::2]
        physics = "elasticity" if nd == 3 else "poisson"
        kw = dict(p=model.p, dtype=model.dtype, device=model.device,
                  fine_mask=corner_mask)
        if physics == "elasticity":
            kw.update(E=model.E, nu=model.nu)
        kw.update(gmg_options or {})
        X = model.X_host
        self.asm = GMGAssembler3D(
            *self.cshape[::-1], float(X[:, 0].max()), float(X[:, 1].max()),
            float(X[:, 2].max()), physics, **kw,
        )
        # scatter-free lattice matvec when conn matches the creator
        # stride-2 pattern (None -> the generic segment-sum route)
        self._lat_off = self._lattice_offsets()

    # -- operator pieces ----------------------------------------------------

    def _lattice_offsets(self):
        """(ncls, nnpe, 3) lattice offsets (x, y, z) when the model's conn
        IS the ProblemCreator stride-2 lattice pattern (brick20: one
        element per super-cell, tet10: six), else None."""
        from .mesh import _BRICK20_OFFSETS, _tet10_offsets

        brick = self.model.etype.name == "brick20"
        off = _BRICK20_OFFSETS[None] if brick else _tet10_offsets()
        nz, ny, nx = self.shape
        k0, j0, i0 = np.meshgrid(
            2 * np.arange((nz - 1) // 2), 2 * np.arange((ny - 1) // 2),
            2 * np.arange((nx - 1) // 2), indexing="ij",
        )
        base = np.stack([i0.ravel(), j0.ravel(), k0.ravel()], axis=-1)
        pos = base[:, None, None, :] + off[None]
        ids = (pos[..., 0] + pos[..., 1] * nx
               + pos[..., 2] * nx * ny).reshape(-1, off.shape[1])
        if not np.array_equal(self.model.conn_host, ids):
            return None
        return np.asarray(off)

    def _lattice_matvec(self, Ke, v):
        """Scatter-free element matvec on the structured lattice.

        The element gather is the model's ``conn_dof`` (on the creator
        lattice, element e = super-cell s * ncls + class t), the product
        one ``torch.bmm`` of (nelems, m, m) by (nelems, m, 1), and the
        element -> node sum adds each local node's products into its
        stride-2 view of the (nz, ny, nx, nd) node grid, offset after
        offset: every launch writes each node once, so the sum has a
        fixed order and no atomics.

        Args:
            Ke: (nelems, m, m) element matrices, m = nnpe * nd.
            v: (ndof,) interleaved vector.

        Returns:
            (ndof,) ``K v``.
        """
        nd = self.nd
        nz, ny, nx = self.shape
        sz, sy, sx = (nz - 1) // 2, (ny - 1) // 2, (nx - 1) // 2
        off = self._lat_off
        ncls, nnpe, _ = off.shape
        ye = torch.bmm(Ke, v[self.model.conn_dof].unsqueeze(-1))
        ye = ye.view(sz, sy, sx, ncls, nnpe, nd)
        y = torch.zeros((nz, ny, nx, nd), dtype=v.dtype, device=v.device)
        for t in range(ncls):
            for n in range(nnpe):
                ox, oy, oz = (int(w) for w in off[t, n])
                y[oz:oz + 2 * sz:2, oy:oy + 2 * sy:2,
                  ox:ox + 2 * sx:2].add_(ye[:, :, :, t, n])
        return y.view(-1)

    def _afree(self, Ke, v):
        """Free-dof operator: rows/cols of masked dofs dropped."""
        vz = torch.where(self.mask_all, 0.0, v)
        if self._lat_off is not None:
            y = self._lattice_matvec(Ke, vz)
        else:
            y = self.model.matvec(Ke, vz)
        return torch.where(self.mask_all, 0.0, y)

    def _inv_diag(self, Ke):
        diag = self.model.diagonal(Ke)
        return 1.0 / torch.where(self.mask_all | (diag == 0), 1.0, diag)

    def _power_lam(self, Ke, inv_diag, iters=20):
        """lam_max(D^-1 A) by power iteration: every step on the device,
        the estimate read back once."""
        v0 = torch.where(
            self.mask_all, 0.0,
            torch.sin(1.7 * torch.arange(self.model.ndof, dtype=Ke.dtype,
                                         device=Ke.device)) + 1.1,
        )
        v = v0 / torch.linalg.norm(v0)
        for _ in range(iters):
            w = inv_diag * self._afree(Ke, v)
            v = w / torch.linalg.norm(w)
        w = inv_diag * self._afree(Ke, v)
        return float(torch.dot(v, w) / torch.dot(v, v))

    def _cheb(self, Ke, inv_diag, lam, z, r, degree):
        """Chebyshev smoothing for A z ~= r; ``z`` None starts from
        z = 0, whose residual is r itself (no operator apply)."""
        hi = 1.1 * lam
        lo = lam / self.cheb_frac
        theta = 0.5 * (hi + lo)
        delta = 0.5 * (hi - lo)
        sigma = theta / delta
        mask = self.mask_all

        def resid(z):
            rz = r if z is None else r - self._afree(Ke, z)
            return inv_diag * torch.where(mask, 0.0, rz)

        d = resid(z) / theta
        z = d if z is None else z + d
        rho_old = 1.0 / sigma
        for _ in range(int(degree) - 1):
            rho = 1.0 / (2.0 * sigma - rho_old)
            d = rho * rho_old * d + (2.0 * rho / delta) * resid(z)
            z = z + d
            rho_old = rho
        return z

    # -- solve --------------------------------------------------------------

    def operators(self, rho=None):
        """(afree, precond) of one density: the free-dof operator ``v ->
        A v`` and the preconditioner ``r -> M^-1 r`` (pre-smooth,
        residual, restriction, one corner V-cycle, prolongation,
        post-smooth).

        One element-matrix computation; the first call also measures
        ``cheb_lam`` (cached, as in the JAX package).  The corner
        hierarchy is assembled from the injected nodal density.
        """
        from . import multigrid
        from .ops.dia import interleave_to_planar, planar_to_interleave

        model, nd, mask = self.model, self.nd, self.mask_all
        rho_n = model._as_nodal(1.0 if rho is None else rho)
        Ke = model.element_jacobian(rho_n)
        inv_diag = self._inv_diag(Ke)
        if self._cheb_lam is None:
            self._cheb_lam = self._power_lam(Ke, inv_diag)
        lam = self._cheb_lam
        gmg, clv0 = self.asm.assemble(rho_n.reshape(self.shape)[::2, ::2,
                                                                ::2])

        def afree(v):
            return self._afree(Ke, v)

        def precond(r):
            z = self._cheb(Ke, inv_diag, lam, None, r, self.nu)
            rr = torch.where(mask, 0.0, r - afree(z))
            rg = interleave_to_planar(rr, nd).reshape((nd,) + self.shape)
            bc = multigrid.restrict3d_il(rg, self.cshape)
            zc = gmg.apply(torch.where(clv0.mask, 0.0, bc))
            corr = multigrid.prolong3d_il(zc, self.shape)
            corr_v = planar_to_interleave(corr.reshape(-1), nd)
            z = z + torch.where(mask, 0.0, corr_v)
            return self._cheb(Ke, inv_diag, lam, z, r, self.nu)

        return afree, precond

    def solve(self, rho=None, rhs=None, rtol=1e-8, maxiter=400):
        """(u, b, iters, resnorm) for K(rho) u = rhs with zero-Dirichlet
        elimination, by flexible PCG with :meth:`operators`; ``resnorm``
        is a 0-d tensor."""
        from . import multigrid

        model = self.model
        if rhs is None:
            rhs = model.compute_rhs()
        rhs = torch.as_tensor(rhs, dtype=model.dtype, device=model.device)
        afree, precond = self.operators(rho)
        b = torch.where(self.mask_all, 0.0, rhs)
        x, k, rn = multigrid.pcg(afree, precond, b, rtol=rtol,
                                 maxiter=maxiter, flexible=True)
        return x, b, k, rn
