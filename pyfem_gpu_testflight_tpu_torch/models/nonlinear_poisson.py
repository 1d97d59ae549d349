"""Nonlinear Poisson: -div( h(x) (1 + u^2) grad u ) = g, Newton-solved.

Port of ``pyfem_gpu_testflight_tpu/models/nonlinear_poisson.py``
(reference ``NonlinearPoisson2D``, pyfem.py:1332-1664): the manufactured
source term g (pyfem.py:1427-1448), the Bernstein-polynomial design
field h(xdv) (pyfem.py:1450-1472), the element residual and consistent
tangent, and the Newton contract of ``Assembler.solve_nonlinear``
(pyfem.py:2319-2355).

On a structured quad grid (:meth:`NonlinearPoisson.attach_structured_grid`)
each tangent system is solved by GMRES on the exact tangent stencil
(kernel K9 the operator), right-preconditioned by a V-cycle whose levels
kernel K1 assembles from the nodal coefficient ``c = h(x)(1 + u^2)`` and
whose smoothing calls run kernel K2.  The float32 route measures its
Newton residual with a float64 flux (K9's float64 form on the upcast
float32 coefficient planes), so the convergence test sees the true
residual of the float32-coefficient operator, not ``flux - load``
cancellation; it is the port's counterpart of the JAX package's
double-float matvec (``ops/df64.py``, which is not ported).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import special

from .. import assembly, solvers
from ..ops import geometry
from ..ops.stencil import _QUAD4_LOCAL
from ..ops.stencil_matvec import stencil_matvec_2d
from .base import FEModel, _check_converged

__all__ = ["NonlinearPoisson", "NonlinearPoisson2D"]


def gfunc(Xq):
    """Manufactured source term (pyfem.py:1427-1448); numpy or torch."""
    x, y = Xq[..., 0], Xq[..., 1]
    return (
        1e4 * x * (1.0 - x) * (1.0 - 2.0 * x) * y * (1.0 - y) * (1.0 - 2.0 * y)
    )


def hfunc(xdv, Xq):
    """Bernstein design field h = 1 + sum_k xdv_k B_k(x) 4y(1-y)."""
    x, y = Xq[..., 0], Xq[..., 1]
    n = xdv.shape[0]
    h = torch.ones_like(x)
    yarg = 4.0 * y * (1.0 - y)
    for k in range(n):
        coef = float(special.binom(n - 1, k))
        h = h + xdv[k] * (coef * (1.0 - x) ** (n - 1 - k) * x**k) * yarg
    return h


def _quads(Xe, dN, N, conn, u):
    """(detJ, Ngrad, Xq, ue, uq) of every element and quadrature point."""
    detJ, Ngrad = geometry.shape_gradients(Xe, dN)
    Xq = geometry.interp_to_quads(N, Xe)
    ue = u[conn]
    return detJ, Ngrad, Xq, ue, geometry.interp_to_quads(N, ue)


def _residual_elem(Xe, dN, N, wq, conn, xdv, u):
    """Element residual R_e (pyfem.py:1530-1537)."""
    detJ, Ngrad, Xq, ue, uq = _quads(Xe, dN, N, conn, u)
    h = hfunc(xdv, Xq)
    g = gfunc(Xq)
    c = detJ * h * (1.0 + uq**2) * wq[None, :]
    flux = torch.einsum("eq,eqjl,eqkl,ek->ej", c, Ngrad, Ngrad, ue)
    load = torch.einsum("eq,qn->en", detJ * wq[None, :] * g, N)
    return flux - load


def _tangent_elem(Xe, dN, N, wq, conn, xdv, u):
    """Consistent tangent K_e (pyfem.py:1595-1609)."""
    detJ, Ngrad, Xq, ue, uq = _quads(Xe, dN, N, conn, u)
    h = hfunc(xdv, Xq)
    c1 = detJ * h * (1.0 + uq**2) * wq[None, :]
    Ke = torch.einsum("eq,eqjl,eqkl->ejk", c1, Ngrad, Ngrad)
    c2 = 2.0 * detJ * h * uq * wq[None, :]
    bbu = torch.einsum("eqjl,eqkl,ek->eqj", Ngrad, Ngrad, ue)
    return Ke + torch.einsum("eq,eqj,qi->eji", c2, bbu, N)


def _raster_conn(nx, ny):
    """The ProblemCreator quad4 raster: elements row-major with x
    fastest, local order ``ops.stencil._QUAD4_LOCAL``."""
    nodes = np.arange(ny * nx).reshape(ny, nx)
    return np.stack([nodes[ay : ay + ny - 1, ax : ax + nx - 1].ravel()
                     for (ay, ax) in _QUAD4_LOCAL], axis=-1)


class NonlinearPoisson(FEModel):
    """Newton-solved nonlinear Poisson problem on a 2D mesh.

    ``device=None`` means the CUDA card; ``device="cpu"`` runs kernels
    K1, K2 and K9's plain versions.  ``mark`` (None, or a callable taking
    a stage name) is called at the end of each stage of a Newton
    iteration of :meth:`solve_nonlinear_fused` ("residual", and on the
    ``gmg`` route "tangent", "hierarchy", "gmres", then "update"), so a
    caller can time the stages with CUDA events.
    """

    def __init__(self, etype, X, conn, dof_fixed=(), dof_fixed_vals=None,
                 dtype=torch.float64, device=None):
        super().__init__(
            etype, X, conn, dof_fixed, dof_fixed_vals, ndof_per_node=1,
            dtype=dtype, device=device,
        )
        self._gmg_newton = None
        self._unif = None
        self.mark = None

    def _xdv(self, xdv):
        return torch.as_tensor(np.asarray(xdv) if not torch.is_tensor(xdv)
                               else xdv, dtype=self.dtype, device=self.device)

    def _u(self, u):
        if u is None:
            return torch.zeros(self.ndof, dtype=self.dtype, device=self.device)
        return torch.as_tensor(u, dtype=self.dtype, device=self.device)

    def _stage(self, name):
        if self.mark is not None:
            self.mark(name)

    def element_jacobian(self, xdv, u):
        return _tangent_elem(self.Xe, self.dN, self.N, self.wq, self.conn,
                             self._xdv(xdv), self._u(u))

    def compute_jacobian(self, xdv, u):
        """Assembled host scipy CSR tangent."""
        return self.assemble_scipy(self.element_jacobian(xdv, u))

    def compute_rhs(self, xdv, u):
        """Global Newton residual R(u) (pyfem.py:1375-1388)."""
        re = _residual_elem(self.Xe, self.dN, self.N, self.wq, self.conn,
                            self._xdv(xdv), self._u(u))
        return assembly.assemble_vector(re, self.conn_dof, self.ndof,
                                        self.segments)

    def residual(self, xdv, u):
        """BC-applied residual: fixed dofs zeroed (dof values pinned)."""
        return self.bc.zero_fixed(self.compute_rhs(xdv, u))

    # -- structured grid -----------------------------------------------------

    def attach_structured_grid(self, nnodes_x, nnodes_y, **gmg_options):
        """Enable GMG preconditioning of the Newton tangent solves.

        The tangent (pyfem.py:1595-1609) splits into a dominant SPD
        variable-coefficient Poisson part — coefficient ``c(x, u) =
        h(x)(1 + u^2)`` — plus a low-order nonsymmetric term ``2 h u_q
        (B u_e) N^T``.  On a structured quad grid the SPD part is what
        :class:`multigrid.GMGAssembler` builds for ``physics="poisson"``
        with ``p=0`` (RAMP at p=0 is the identity), fed the nodal
        coefficient field as "density": kernel K1 on every level.
        ``solve_nonlinear(method="gmg")`` and
        ``solve_nonlinear_fused(method="gmg")`` then run
        V-cycle-right-preconditioned GMRES on the exact tangent stencil.

        The node numbering must be the ProblemCreator raster (else
        ``ValueError``: the tangent's stencil assembly reads elements in
        raster order).  The assembler's extents are the mesh's own
        ``X.max() - X.min()``, so a raster off the origin gets element
        matrices of its true size; the scatter-free tables of the
        uniform path are built when every spacing equals extent / (n -
        1), else the tangent comes from the element einsum.  Attaching
        again replaces the assembler and the tables; no solve keeps
        state across calls.
        """
        from ..multigrid import GMGAssembler

        if self.etype.name != "quad4":
            raise ValueError("gmg Newton requires quad4 grids")
        if self.bc._has_vals:
            raise ValueError("the gmg Newton tangent path supports zero "
                             "Dirichlet values only")
        nx, ny = int(nnodes_x), int(nnodes_y)
        if nx * ny != self.nnodes:
            raise ValueError(f"{nx}x{ny} grid != {self.nnodes} nodes")
        if not np.array_equal(self.conn_host, _raster_conn(nx, ny)):
            raise ValueError(
                f"the mesh's node numbering is not the {nx}x{ny} "
                f"ProblemCreator raster (elements row-major, x fastest): "
                f"the gmg tangent cannot be assembled as a stencil"
            )
        xg = self.X_host[:, 0].reshape(ny, nx)
        yg = self.X_host[:, 1].reshape(ny, nx)
        Lx, Ly = float(xg.max() - xg.min()), float(yg.max() - yg.min())
        fine_mask = self.bc.mask.cpu().numpy().reshape(1, ny, nx)
        kw = dict(physics="poisson", p=0.0, dtype=self.dtype,
                  device=self.device, fine_mask=fine_mask)
        kw.update(gmg_options)
        self._gmg_newton = GMGAssembler(nx, ny, Lx, Ly, **kw)
        self._gmg_newton_shape = (ny, nx)
        self._unif = self._uniform_newton_statics(nx, ny, Lx, Ly)
        return self

    def _uniform_newton_statics(self, nx, ny, Lx, Ly):
        """Static tables for the scatter-free uniform-grid Newton path.

        On a raster of congruent elements the element einsum paths
        collapse: the flux IS the variable-coefficient stencil times u
        (element residual pyfem.py:1530-1537 with u_e factored out), and
        the tangent's quadrature coefficients are shifted-slice
        interpolations of the node grid.  Returns None (generic path)
        when a spacing differs from extent / (n - 1).  The load (g has
        no xdv dependence) is assembled once on the host and kept as one
        float64 device tensor.
        """
        X = self.X_host
        xg = X[:, 0].reshape(ny, nx)
        yg = X[:, 1].reshape(ny, nx)
        if not (
            np.allclose(np.diff(xg, axis=1), Lx / (nx - 1), rtol=0,
                        atol=1e-12)
            and np.allclose(np.diff(yg, axis=0), Ly / (ny - 1), rtol=0,
                            atol=1e-12)
            and np.allclose(np.diff(xg, axis=0), 0.0, atol=1e-12)
            and np.allclose(np.diff(yg, axis=1), 0.0, atol=1e-12)
        ):
            return None
        conn = self.conn_host
        host = lambda t: t.cpu().numpy().astype(np.float64)
        N, dN, wq = host(self.N), host(self.dN), host(self.wq)
        xe0 = X[conn[0]]                              # (4, 2)
        Xc = xe0 - xe0.mean(axis=0, keepdims=True)
        J = np.einsum("qnk,ni->qik", dN, Xc)          # (nq, 2, 2)
        detJ = J[:, 0, 0] * J[:, 1, 1] - J[:, 0, 1] * J[:, 1, 0]
        inv = np.empty_like(J)
        inv[:, 0, 0] = J[:, 1, 1]
        inv[:, 1, 1] = J[:, 0, 0]
        inv[:, 0, 1] = -J[:, 0, 1]
        inv[:, 1, 0] = -J[:, 1, 0]
        inv /= detJ[:, None, None]
        G = np.einsum("qnk,qki->qni", dN, inv)        # (nq, 4, 2) Ngrad
        # per-quad physical coordinates of every element, as planes
        offs = np.einsum("qn,ni->qi", N, xe0 - xe0[0])  # (nq, 2)
        x0, y0 = xg[: ny - 1, : nx - 1], yg[: ny - 1, : nx - 1]
        Xq_grid = np.stack([np.stack([x0 + offs[q, 0], y0 + offs[q, 1]],
                                     axis=-1)
                            for q in range(N.shape[0])])  # (nq, ney, nex, 2)
        le = np.einsum("q,qyx,qn->yxn", detJ * wq, gfunc(Xq_grid), N)
        load = np.zeros(ny * nx)
        np.add.at(load, conn.reshape(-1), le.reshape(-1))
        put = lambda a: torch.as_tensor(a, dtype=self.dtype,
                                        device=self.device)
        return dict(
            N=put(N), G=put(G), detJw=put(detJ * wq), Xq=put(Xq_grid),
            load=torch.as_tensor(load, device=self.device),
            # host copy: assemble_uniform folds it on the host (no sync)
            Kq=self._gmg_newton.static_levels[0].Kq.cpu().numpy(),
        )

    def _uniform_tangent_coeffs(self, xdv, u_grid, rank=True,
                                coeff_spd=None):
        """Scatter-free tangent stencil coefficients on the raster.

        Returns (coeff_spd, coeff_rank): the variable-coefficient Poisson
        part assembled via unit matrices (also the exact flux operator:
        flux = coeff_spd . u; taken as given when passed), and the
        low-order nonsymmetric ``2 h u_q (B u_e) N^T`` term's stencil
        (None when ``rank`` is False).
        """
        st0 = self._gmg_newton.static_levels[0].op
        un = self._unif
        N, G, detJw, Xq = un["N"], un["G"], un["detJw"], un["Xq"]
        ny, nx = self._gmg_newton_shape
        ney, nex = ny - 1, nx - 1
        us = [u_grid[ay : ay + ney, ax : ax + nex]
              for (ay, ax) in _QUAD4_LOCAL]
        nq = N.shape[0]
        h_q = hfunc(xdv, Xq)                       # (nq, ney, nex)
        uq = torch.stack(
            [sum(N[q, n] * us[n] for n in range(4)) for q in range(nq)]
        )
        if coeff_spd is None:
            # Kq already carries w_q |J_q| (unit matrices); the material
            # factor is just h (1 + u_q^2)
            coeff_spd = st0.assemble_uniform(h_q * (1.0 + uq * uq),
                                             un["Kq"])
        if not rank:
            return coeff_spd, None
        gradu = [
            [sum(G[q, n, l] * us[n] for n in range(4)) for l in range(2)]
            for q in range(nq)
        ]
        c2 = 2.0 * detJw[:, None, None] * h_q * uq  # (nq, ney, nex)
        # Ke2[e, j, i] = sum_q c2[q] bbu[q, j] N[q, i]
        bbu = [
            [sum(G[q, j, l] * gradu[q][l] for l in range(2)) for j in range(4)]
            for q in range(nq)
        ]
        Ke2 = torch.stack(
            [
                torch.stack(
                    [sum(c2[q] * bbu[q][j] * N[q, i] for q in range(nq))
                     for i in range(4)],
                    dim=-1,
                )
                for j in range(4)
            ],
            dim=-2,
        )  # (ney, nex, 4, 4)
        return coeff_spd, st0.assemble(Ke2.reshape(-1, 4, 4))

    def _uniform_residual(self, xdv, u, coeff_spd=None):
        """R(u) = K_c(u) u - load on the raster (scatter-free), in the
        model's dtype; the flux by kernel K9."""
        ny, nx = self._gmg_newton_shape
        if coeff_spd is None:
            coeff_spd, _ = self._uniform_tangent_coeffs(
                xdv, u.reshape(ny, nx), rank=False)
        flux = stencil_matvec_2d(coeff_spd, u.reshape(1, ny, nx))
        return self.bc.zero_fixed(
            flux.reshape(-1) - self._unif["load"].to(self.dtype))

    def _uniform_residual_f64(self, xdv, u, coeff_spd=None):
        """(r, ||r||): the residual with a float64 flux.

        The coefficient planes (in the model's dtype) and u are upcast
        exactly and multiplied by K9's float64 form, the float64 load is
        subtracted and the fixed dofs masked, so ``||r||`` (float64) is
        the true residual of the model-dtype-coefficient operator, free
        of the float32 ``flux - load`` cancellation (~5.5e-3 relative
        at 1025^2).  The JAX package measures the same quantity with a
        double-float matvec (``ops/df64.py``).  ``r`` is returned in the
        model's dtype.
        """
        ny, nx = self._gmg_newton_shape
        if coeff_spd is None:
            coeff_spd, _ = self._uniform_tangent_coeffs(
                xdv, u.reshape(ny, nx), rank=False)
        mask0 = self._gmg_newton.static_levels[0].mask
        flux = stencil_matvec_2d(coeff_spd.double(),
                                 u.double().reshape(1, ny, nx))
        r = torch.where(mask0, 0.0,
                        flux - self._unif["load"].reshape(1, ny, nx))
        r = r.reshape(-1)
        return r.to(self.dtype), torch.linalg.norm(r)

    def _gmg_tangent_solve_fn(self, maxiter=400):
        """``(xdv, u, res, rtol[, coeff_spd]) -> (du, iters, resnorm,
        |b|)``.

        One tangent solve: assemble the exact (nonsymmetric) tangent into
        stencil coefficient planes (scatter-free on the uniform raster,
        else the element einsum and ``Stencil2D.assemble``) and eliminate
        the Dirichlet dofs, assemble the SPD-part GMG hierarchy from the
        nodal coefficient field (K1 on every level), and run GMRES with
        K9 on the eliminated planes as the operator and one V-cycle (K2
        in every smoothing call) as the right preconditioner.
        ``coeff_spd`` reuses the residual's SPD planes of the same u.
        """
        asm = self._gmg_newton
        st0 = asm.static_levels[0].op
        mask0 = asm.static_levels[0].mask
        ny, nx = self._gmg_newton_shape
        unif = self._unif

        def solve(xdv, u, res, rtol, coeff_spd=None):
            if unif is not None:
                cs, cr = self._uniform_tangent_coeffs(
                    xdv, u.reshape(ny, nx), coeff_spd=coeff_spd)
                ce = st0.bc_eliminate(cs + cr, mask0)
            else:
                Ke = _tangent_elem(self.Xe, self.dN, self.N, self.wq,
                                   self.conn, xdv, u)
                ce = st0.bc_eliminate(st0.assemble(Ke), mask0)
            self._stage("tangent")
            gmg, _ = asm.assemble(hfunc(xdv, self.X) * (1.0 + u * u))
            self._stage("hierarchy")
            b = torch.where(mask0, 0.0, res.reshape(1, ny, nx)).reshape(-1)
            mv = lambda v: stencil_matvec_2d(ce, v.reshape(1, ny, nx)
                                             ).reshape(-1)
            pre = lambda r: gmg.apply(
                torch.where(mask0, 0.0, r.reshape(1, ny, nx))).reshape(-1)
            du, li, lr = solvers.gmres_loop(mv, b, precond=pre, rtol=rtol,
                                            maxiter=maxiter)
            self._stage("gmres")
            return du, li, lr, torch.linalg.norm(b)

        return solve

    def _require_grid(self):
        if self._gmg_newton is None:
            raise RuntimeError(
                "call attach_structured_grid(nx, ny) before method='gmg'")

    # -- Newton --------------------------------------------------------------

    def solve_nonlinear(
        self, method="gmres", xdv=None, u0=None, tol=1e-10, atol=1e-12,
        max_iter=10, verbose=True,
    ):
        """Newton loop with the reference contract (pyfem.py:2319-2355).

        Each tangent system is solved by ``"direct"`` (host scipy),
        ``"cg"`` / ``"gmres"`` (Jacobi, matrix-free, rtol 1e-8) or, after
        :meth:`attach_structured_grid`, ``"gmg"``: V-cycle-preconditioned
        GMRES on the device, checked by ``_check_converged``.
        """
        if method not in ("direct", "cg", "gmres", "gmg"):
            raise ValueError(f"unknown method {method!r}")
        xdv = self._xdv(xdv)
        u = self._u(u0)
        if method == "gmg":
            self._require_grid()
            solve = self._gmg_tangent_solve_fn()
            lin_rtol = 1e-8

            def jac_solve(u_k, res):
                du, li, lr, bnorm = solve(xdv, u_k, res, lin_rtol)
                _check_converged("gmg-gmres", float(lr),
                                 lin_rtol * float(bnorm), iters=li)
                self.last_solve_stats = {"method": "gmg-gmres", "iters": li,
                                         "resnorm": float(lr)}
                if verbose:
                    print(f"        [gmg-gmres: {li} iters, "
                          f"||r|| = {float(lr):.3e}]")
                return du
        else:
            def jac_solve(u_k, res):
                Ke = self.element_jacobian(xdv, u_k)
                du, _ = self._solve_system(Ke, res, method)
                if verbose and method != "direct":
                    st = self.last_solve_stats
                    print(f"        [{st['method']}: {st['iters']} iters, "
                          f"||r|| = {st['resnorm']:.3e}]")
                return du.to(u_k.dtype)

        return solvers.newton(
            lambda u_k: self.residual(xdv, u_k), jac_solve, u, tol=tol,
            atol=atol, max_iter=max_iter, verbose=verbose,
        )

    def solve_nonlinear_fused(
        self, method="gmres", xdv=None, u0=None, tol=1e-10, atol=1e-12,
        max_iter=10, verbose=True, lin_rtol=1e-8, lin_maxiter=None,
    ):
        """Newton with the iteration kept on the device.

        The JAX package runs this as one ``lax.while_loop``; torch has no
        such loop, so the host drives the iterations while every value of
        the iteration stays a device tensor: the residual and its norm
        (float64 on the ``gmg`` float32 route, :meth:`_uniform_residual_f64`),
        the convergence test, the tangent solve (Jacobi-PCG / Jacobi-GMRES
        on the element operator, or with ``method="gmg"`` the
        V-cycle-preconditioned GMRES of :meth:`_gmg_tangent_solve_fn`) and
        the stalled-solve guard, which freezes u.  The host reads back one
        small tensor per Newton iteration (the convergence flag, the
        previous tangent solve's failure flag and the residual norm;
        ``solvers.readbacks["newton"]``) besides GMRES's per-step columns.
        With ``verbose`` the residual table is printed from those values.

        Returns:
            (u, newton_iters, resnorm): the solution, the number of
            Newton iterations (residual evaluations) and the last residual
            norm.  Raises RuntimeError if a tangent solve stalls (the
            guard's slack is ``_check_converged``'s, x10).
        """
        if method not in ("cg", "gmres", "gmg"):
            raise ValueError(f"unknown method {method!r}")
        if method == "gmg":
            self._require_grid()
        xdv = self._xdv(xdv)
        u = self._u(u0)
        maxlin = 10 * self.ndof if lin_maxiter is None else int(lin_maxiter)
        use_unif = method == "gmg" and self._unif is not None
        f64_flux = use_unif and self.dtype == torch.float32
        gmg_solve = (self._gmg_tangent_solve_fn(maxiter=maxlin)
                     if method == "gmg" else None)
        mask = self.bc.mask

        def residual_rn(u):
            if not use_unif:
                r = self.residual(xdv, u)
                return r, torch.linalg.norm(r), None
            ny, nx = self._gmg_newton_shape
            cs, _ = self._uniform_tangent_coeffs(xdv, u.reshape(ny, nx),
                                                 rank=False)
            if f64_flux:
                return (*self._uniform_residual_f64(xdv, u, cs), cs)
            r = self._uniform_residual(xdv, u, cs)
            return r, torch.linalg.norm(r), cs

        def lin_solve(u, res, cs):
            if method == "gmg":
                return gmg_solve(xdv, u, res, lin_rtol, cs)
            Ke = _tangent_elem(self.Xe, self.dN, self.N, self.wq, self.conn,
                               xdv, u)
            b = self.bc.constrain_rhs(res, lambda v: self.matvec(Ke, v))
            diag = self.diagonal(Ke)
            inv_diag = 1.0 / torch.where(mask | (diag == 0), 1.0, diag)
            mv = lambda v: assembly.bc_elem_matvec(
                (Ke, self.conn_dof, mask, self.segments), v)
            loop = solvers.cg_loop if method == "cg" else solvers.gmres_loop
            du, li, lr = loop(mv, b, inv_diag=inv_diag, rtol=lin_rtol,
                              maxiter=maxlin)
            return du, li, lr, torch.linalg.norm(b)

        k, rn0, rn = 0, None, None
        fail = torch.zeros((), dtype=torch.bool, device=self.device)
        lin, rns = [], []  # per tangent solve (iters, resnorm); per rn

        def lin_line():
            li, lr = lin[-1]
            print(f"        [{method}: {int(li)} iters, ||r|| = "
                  f"{float(lr):.3e}]")

        while k < max_iter:
            res, rn, cs = residual_rn(u)
            self._stage("residual")
            rn0 = rn if k == 0 else rn0
            conv = ((rn < tol * rn0) | (rn < atol)) if k > 0 else \
                torch.zeros((), dtype=torch.bool, device=self.device)
            flag = torch.stack([conv.double(), fail.double(), rn.double()])
            solvers.readbacks["newton"] += 1
            conv_h, fail_h, rn_h = flag.cpu().numpy()
            if verbose and lin:
                lin_line()
            if fail_h:  # the last tangent solve stalled; u is frozen
                break
            rns.append(float(rn_h))
            if verbose:
                print(f"pyfem-tpu-fused {k}  {rn_h}")
            k += 1
            if conv_h:
                break
            du, li, lr, bnorm = lin_solve(u, res, cs)
            bad = ~(lr <= 10.0 * lin_rtol * bnorm)
            u = torch.where(bad, u, u - du)
            fail = bad
            lin.append((li, lr))
            self._stage("update")
        else:
            if verbose and lin:
                lin_line()
        self.last_solve_stats = {
            "method": f"fused-{method}", "newton_iters": k,
            "lin_iters": [int(li) for li, _ in lin], "resnorms": rns,
        }
        if bool(fail):  # one host sync at the public solve boundary
            raise RuntimeError(
                f"fused Newton: {method} tangent solve failed to converge "
                f"at Newton iteration {k - 1}"
            )
        return u, k, rn


NonlinearPoisson2D = NonlinearPoisson
