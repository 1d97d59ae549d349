"""Shared model infrastructure (PyTorch port).

Port of ``pyfem_gpu_testflight_tpu/models/base.py``: the constructor's
mesh, element-table and BC state, the lazy host sparsity ``pattern``,
``assemble_scipy``, the matrix-free ``matvec`` / ``diagonal``,
``attach_structured_grid`` in 2D and 3D, ``attach_pmg``,
``attach_sharded_grid``, the ``"gmg"``, ``"sharded_gmg"``, ``"pmg"``,
``"amg"``, ``"cg"``, ``"gmres"`` and ``"direct"`` branches of
``_solve_system`` (every one takes nonzero Dirichlet values but
``"pmg"``, which refuses them as the JAX package does; ``"gmg"`` lifts
the rhs through the fine level's un-eliminated operator), the design
sensitivity ``d(phi^T K psi)/drho`` (the generic einsum route with a
deterministic segment sum, and the scatter-free structured route of an
attached uniform grid) and the volume functionals.

Complex-step probes: a complex density (``rho + 1j*h*p``) keeps its
imaginary part.  It becomes the complex dtype matching ``dtype`` and
takes the einsum route, whose element tables are cast to it
(:meth:`FEModel._tables`); the element kernels and the structured
sensitivity are real-only, and a complex operator is solved only by
``method="direct"`` (host scipy), as in the JAX package.

Reference parity: ModelBase (pyfem.py:634-931) and the RAMP material
helpers (pyfem.py:1278-1329, 1922-1973).
"""

from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from .. import assembly
from ..bcs import DirichletBC
from ..device import resolve_device
from ..elements import get_element
from ..ops import geometry

__all__ = ["FEModel", "ramp", "ramp_deriv"]

# element types the element-stiffness kernels K7 / K8 take
KERNEL_ETYPES = ("quad4", "hex8", "tet10", "brick20")

# solve methods that build their operator from the density themselves,
# so solve/compliance compute no element matrices for them
OWN_OPERATOR = ("gmg", "sharded_gmg", "pmg")


def _check_converged(method, resnorm, tol, iters=None, slack=10.0):
    """Raise on a stalled iterative solve (pyfem.py:1067, 2421-2422).

    The residual norm is checked directly (one host sync at the public
    solve boundary).  ``slack`` tolerates the last-iteration rounding
    between the loop's squared-norm test and this recheck.
    """
    rn = float(resnorm)
    t = float(tol)
    if not np.isfinite(rn) or rn > slack * max(t, 1e-300):
        it = "" if iters is None else f" after {int(iters)} iterations"
        raise RuntimeError(
            f"{method} failed to converge{it}: ||r|| = {rn:.3e} > "
            f"tolerance {t:.3e}"
        )


def _host(v):
    """A tensor or array as a host numpy array."""
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _is_complex(v):
    """True for a complex tensor, array or scalar (a complex-step probe)."""
    return torch.is_complex(v) if torch.is_tensor(v) else bool(
        np.iscomplexobj(v))


def ramp(rho_q, p):
    """RAMP penalization factor rho / (1 + p (1 - rho)) (pyfem.py:1300)."""
    return rho_q / (1.0 + p * (1.0 - rho_q))


def ramp_deriv(rho_q, p):
    """d RAMP / d rho = (1 + p) / (1 + p (1 - rho))^2 (pyfem.py:1325)."""
    return (1.0 + p) / (1.0 + p * (1.0 - rho_q)) ** 2


class FEModel:
    """Base class holding mesh/element/BC state for a physics model.

    ``dtype`` is explicit: torch defaults to float32, while the
    reference package runs with float64 enabled.  ``device=None`` means
    the CUDA card; ``device="cpu"`` runs the kernels' plain versions.
    """

    def __init__(
        self,
        etype,
        X,
        conn,
        dof_fixed=(),
        dof_fixed_vals=None,
        *,
        ndof_per_node: int,
        dtype=torch.float64,
        device=None,
    ):
        self.etype = get_element(etype)
        X_host = np.asarray(X, dtype=np.float64)
        conn_host = np.asarray(conn, dtype=np.int64)
        if X_host.shape[1] != self.etype.ndims:
            raise ValueError(
                f"mesh is {X_host.shape[1]}D but element {self.etype.name} "
                f"is {self.etype.ndims}D"
            )
        if conn_host.shape[1] != self.etype.nnodes:
            raise ValueError(
                f"conn has {conn_host.shape[1]} nodes per element, "
                f"{self.etype.name} has {self.etype.nnodes}"
            )

        self.dtype = dtype
        self.device = resolve_device(device)
        self.ndof_per_node = int(ndof_per_node)
        self.nelems = int(conn_host.shape[0])
        self.nnodes = int(X_host.shape[0])
        self.ndims = int(X_host.shape[1])
        self.nnodes_per_elem = self.etype.nnodes
        self.nquads = self.etype.nquads
        self.ndof = self.nnodes * self.ndof_per_node
        self.X_host = X_host
        self.conn_host = conn_host
        self.conn_dof_host = assembly.make_conn_dof(conn_host,
                                                    self.ndof_per_node)

        # device tensors: mesh, dof map, element tables, element coords
        dev = self.device
        self.X = torch.as_tensor(X_host, dtype=dtype, device=dev)
        self.conn = torch.as_tensor(conn_host, device=dev)
        self.conn_dof = torch.as_tensor(
            self.conn_dof_host.astype(np.int64), device=dev)
        self.N = torch.as_tensor(self.etype.shape_vals, dtype=dtype,
                                 device=dev)
        self.dN = torch.as_tensor(self.etype.shape_grads, dtype=dtype,
                                  device=dev)
        self.wq = torch.as_tensor(self.etype.quad_wts, dtype=dtype,
                                  device=dev)
        self.Xe = geometry.gather_to_elements(self.X, self.conn)
        self._pattern = None
        self._segments = None
        self._node_segments = None
        self.kernel = "einsum"

        # Constrain dofs of unreferenced grid nodes (e.g. brick20 meshes
        # skip super-cell centers, pyfem.py:683) so systems stay regular.
        used = np.zeros(self.nnodes, dtype=bool)
        used[conn_host.ravel()] = True
        unused = np.where(~used)[0]
        dof_fixed = np.asarray(dof_fixed, dtype=np.int64).ravel()
        if unused.size:
            extra = (
                self.ndof_per_node * unused[:, None]
                + np.arange(self.ndof_per_node)
            ).ravel()
            dof_fixed = np.concatenate([dof_fixed, extra])
            if dof_fixed_vals is not None:
                dof_fixed_vals = np.concatenate(
                    [np.asarray(dof_fixed_vals, dtype=float),
                     np.zeros(extra.size)]
                )
        self.bc = DirichletBC(dof_fixed, dof_fixed_vals, self.ndof,
                              device=self.device)

    # -- element-stiffness route --------------------------------------------

    def _init_kernel(self, kernel):
        """Check and set the element-stiffness route.

        ``"einsum"``: the einsum path (any element, any dtype).
        ``"cuda"``: kernels K7 (quad4) / K8 (hex8, tet10, brick20), the
        JAX package's ``kernel="pallas"`` (the reference's A2DWrapper
        role, pyfem.py:2180); float32 only.  On CPU tensors it runs the
        kernels' plain versions.
        """
        if kernel not in ("einsum", "cuda"):
            raise ValueError(f"kernel must be 'einsum' or 'cuda', got "
                             f"{kernel!r} (the JAX 'pallas' kernel is "
                             f"'cuda' here)")
        if kernel == "cuda" and (self.etype.name not in KERNEL_ETYPES
                                 or self.dtype != torch.float32):
            raise ValueError("kernel='cuda' requires quad4/hex8/tet10/"
                             "brick20 + float32")
        self.kernel = kernel
        if kernel != "cuda":
            return
        if self.etype.name in ("tet10", "brick20"):
            # f32 quadratic elements lose ~2 digits on distorted meshes
            # to near-degenerate-element cancellation — equally on the
            # einsum-f32 path (measured by the JAX package, round 3)
            warnings.warn(
                "kernel='cuda' on quadratic elements runs in float32; "
                "distorted meshes lose ~2 digits vs float64 (use the "
                "default einsum kernel with dtype=float64 for "
                "accuracy-critical work)",
                stacklevel=3,
            )
        from ..ops.element_kernels import transpose_xe

        self._XeT = transpose_xe(self.Xe)  # (ndims*nn, nelems)

    def _cq_transposed(self, rho):
        """RAMP material at the quad points, (nquads, nelems)."""
        rho_q = geometry.interp_to_quads(self.N, rho[self.conn])
        return ramp(rho_q, self.p).t().contiguous()

    def _untranspose_ke(self, KeT):
        """Kernel layout (ndpe^2, nelems) -> contiguous (nelems, ndpe,
        ndpe), the layout the matrix-free operator reads.  K8's KeT is
        the transposed view of that buffer on the card, so this copies
        nothing there; K7's KeT and the plain versions' are copied."""
        from ..ops.element_kernels import untranspose

        nn = self.nnodes_per_elem * self.ndof_per_node
        return untranspose(KeT, nn, nn)

    # -- pattern / global matrix (lazy; host) --------------------------------

    @property
    def pattern(self) -> assembly.SparsityPattern:
        """Host sparsity pattern of the global matrix, built on first use
        (only ``assemble_scipy`` and ``method="direct"`` need it)."""
        if self._pattern is None:
            self._pattern = assembly.SparsityPattern(self.conn_dof_host,
                                                     self.ndof)
        return self._pattern

    @property
    def segments(self) -> assembly.SortedSegments:
        """Sorted dof index of ``conn_dof`` for the matrix-free operator
        (one entry per element dof), built on first use."""
        if self._segments is None:
            self._segments = assembly.SortedSegments(
                self.conn_dof, self.ndof, device=self.device)
        return self._segments

    @property
    def node_segments(self) -> assembly.SortedSegments:
        """Sorted node index of ``conn`` (element -> node sums of the
        design sensitivity), built on first use."""
        if self._node_segments is None:
            self._node_segments = assembly.SortedSegments(
                self.conn, self.nnodes, device=self.device)
        return self._node_segments

    def assemble_scipy(self, Ke, apply_bcs=False, enforce_symmetric_K=True,
                       rhs=None):
        """Assemble element matrices into a host scipy CSR matrix."""
        values = assembly.assemble_values(torch.as_tensor(Ke), self.pattern)
        K = assembly.scipy_csr(values, self.pattern)
        if not apply_bcs:
            return K
        if rhs is None:
            rhs = np.zeros(self.ndof)
        return self.bc.apply_scipy(K, _host(rhs), enforce_symmetric_K)

    # -- operator helpers ----------------------------------------------------

    def matvec(self, Ke, u):
        """Unconstrained matrix-free SpMV (deterministic segment sum)."""
        return assembly.elem_matvec(Ke, self.conn_dof, u, self.ndof,
                                    self.segments)

    def diagonal(self, Ke):
        return assembly.elem_diagonal(Ke, self.conn_dof, self.ndof,
                                      self.segments)

    # -- design sensitivity and volume ----------------------------------------

    def _dv_sens_inputs(self, rho, phi, psi):
        """Nodal rho, phi, psi on the device in one working dtype: the
        model's, or its complex form when any of them is complex."""
        cplx = any(_is_complex(v) for v in (rho, phi, psi))
        dt = self.complex_dtype if cplx else self.dtype
        as_dt = lambda v: torch.as_tensor(v, device=self.device).to(dt)
        return as_dt(self._as_nodal(rho)), as_dt(phi), as_dt(psi)

    def _gather_dv(self, rho, phi, psi):
        """Quad-point rho and element-gathered phi/psi of the generic
        route: (rho_q (nelems, nq), phi_e, psi_e (nelems, nn[, nd]))."""
        rho_q = geometry.interp_to_quads(self._tables(rho.dtype)[2],
                                         rho[self.conn])
        nd = self.ndof_per_node
        shape = (self.nelems, self.nnodes_per_elem) + ((nd,) if nd > 1
                                                      else ())
        return (rho_q, phi[self.conn_dof].reshape(shape),
                psi[self.conn_dof].reshape(shape))

    def _k_dv_sens_structured(self, rho, phi, psi):
        """Uniform-grid scatter-free d(phi^T K psi)/drho.

        Valid when ``attach_structured_grid`` has been called (the GMG
        assembler shares this model's physics and uniform geometry);
        dispatched from the models' ``k_dv_sens``.  Same contract as the
        generic einsum + segment-sum route, without the per-element
        gather and scatter.
        """
        from ..ops.dia import interleave_to_planar

        nd = self.ndof_per_node
        shape = self._gmg_shape
        to_planes = lambda v: interleave_to_planar(
            v.to(self.dtype), nd).reshape((nd,) + shape)
        out = self._gmg_asm.dv_sens(rho.to(self.dtype).reshape(shape),
                                    to_planes(phi), to_planes(psi))
        return out.reshape(-1)

    def _use_structured_sens(self, *inputs):
        """True when the scatter-free uniform-grid sensitivity applies:
        a structured grid on the uniform element path is attached and no
        input is complex (complex-step probes keep the einsum route, the
        oracle, as in the JAX package)."""
        asm = getattr(self, "_gmg_asm", None)
        return (asm is not None and asm.elem_path == "uniform"
                and not any(_is_complex(v) for v in inputs))

    def volume(self, rho):
        """Mean nodal density."""
        return torch.sum(torch.as_tensor(rho, device=self.device)) / \
            self.nnodes

    def volume_grad(self, rho):
        return torch.full((self.nnodes,), 1.0 / self.nnodes,
                          dtype=self.dtype, device=self.device)

    def attach_sharded_grid(self, mesh, nnodes_x, nnodes_y, nnodes_z=None,
                            **gmg_options):
        """Enable the multi-rank sharded GMG solve path (2D quad4 or 3D
        hex8 structured grids).

        Shards the GMG-PCG solver over ``mesh`` (``parallel.make_mesh``:
        node planes block-partitioned along the leading axis, halo
        exchange with the neighbour ranks — see
        ``parallel.sharded_gmg``); afterwards ``solve(method=
        "sharded_gmg")`` / ``compliance(solver="sharded_gmg")`` run it on
        every rank.  Nonzero Dirichlet values are applied through a rhs
        lift; ``gmg_options`` go to ``ShardedGMG2D`` / ``ShardedGMG3D``
        (``smoother_dtype``, ``omega``, ``n_sharded``, ...).
        """
        from ..parallel.sharded_gmg import ShardedGMG2D, ShardedGMG3D

        nd = self.ndof_per_node
        X = self.X_host
        dims = ((nnodes_x, nnodes_y) if nnodes_z is None
                else (nnodes_x, nnodes_y, nnodes_z))
        want = "quad4" if nnodes_z is None else "hex8"
        if self.etype.name != want:
            raise ValueError(f"{len(dims)}D sharded gmg requires {want} "
                             f"grids")
        dims = tuple(int(n) for n in dims)
        if int(np.prod(dims)) != self.nnodes:
            raise ValueError(f"{'x'.join(map(str, dims))} grid != "
                             f"{self.nnodes} nodes")
        shape = dims[::-1]
        fine_mask = (self.bc.mask.cpu().numpy()
                     .reshape(self.nnodes, nd).T.reshape((nd,) + shape))
        physics = "elasticity" if nd == len(dims) else "poisson"
        kw = dict(p=self.p, dtype=self.dtype, fine_mask=fine_mask)
        if physics == "elasticity":
            kw.update(E=self.E, nu=self.nu)
        kw.update(gmg_options)
        lengths = [float(X[:, k].max()) for k in range(len(dims))]
        cls = ShardedGMG2D if nnodes_z is None else ShardedGMG3D
        self._sgmg = cls(mesh, *dims, *lengths, physics, **kw)
        self._sgmg_shape = shape
        return self

    def _solve_sharded_gmg(self, rho, rhs, rtol=1e-8, maxiter=400):
        from ..ops.dia import interleave_to_planar, planar_to_interleave

        nd = self.ndof_per_node
        shape = self._sgmg_shape
        planes = lambda v: interleave_to_planar(
            torch.as_tensor(v, device=self.device).to(self.dtype), nd
        ).reshape((nd,) + shape)
        vals = (planes(self.bc.values) if bool(self.bc.values.any())
                else None)
        x, k, rn, b_out = self._sgmg.solve(
            self._as_nodal(rho), planes(rhs), rtol=rtol, maxiter=maxiter,
            vals=vals, return_rhs=True,
        )
        mask0 = self._sgmg.asm.static_levels[0].mask
        _check_converged("sharded-gmg-pcg", rn, rtol * float(
            torch.linalg.norm(torch.where(mask0, 0.0, b_out))), k)
        self.last_solve_stats = {
            "method": "sharded_gmg", "iters": int(k), "resnorm": float(rn),
            "collectives": self._sgmg.last_stats["collectives_solve"],
        }
        to_il = lambda v: planar_to_interleave(v.reshape(-1), nd).to(
            self.device)
        return to_il(x), to_il(b_out)

    # -- structured GMG and p-multigrid -------------------------------------

    def attach_pmg(self, nnodes_x, nnodes_y, nnodes_z, **pmg_options):
        """Enable the p-multigrid path for structured quadratic meshes
        (tet10/brick20 node lattices from ProblemCreator).

        Matrix-free Chebyshev smoothing on the quadratic operator and a
        hex8 GMG V-cycle on the linear corner sub-grid (see pmg.py);
        afterwards ``solve(method="pmg")`` runs flexible PCG with it.
        ``pmg_options`` go to :class:`~..pmg.PMG` (``nu``, ``cheb_lam``,
        ``cheb_frac``, ``gmg_options``).
        """
        from ..pmg import PMG

        self._pmg = PMG(self, nnodes_x, nnodes_y, nnodes_z, **pmg_options)
        return self

    def attach_structured_grid(self, nnodes_x, nnodes_y, nnodes_z=None,
                               **gmg_options):
        """Enable the geometric-multigrid fast path (structured quad/hex).

        Builds a GMG hierarchy (multigrid.GMGAssembler[3D]) using this
        model's physics, dtype, device and Dirichlet mask; afterwards
        ``solve(method="gmg")`` runs V-cycle-preconditioned CG, with
        nonzero Dirichlet values through a rhs lift
        (``GMGAssembler._dirichlet_lift``).
        """
        from ..multigrid import GMGAssembler, GMGAssembler3D

        nd = self.ndof_per_node
        X = self.X_host
        dims = ((nnodes_x, nnodes_y) if nnodes_z is None
                else (nnodes_x, nnodes_y, nnodes_z))
        want = "quad4" if nnodes_z is None else "hex8"
        if self.etype.name != want:
            raise ValueError(f"{len(dims)}D gmg requires {want} grids")
        dims = tuple(int(n) for n in dims)
        if int(np.prod(dims)) != self.nnodes:
            raise ValueError(f"{'x'.join(map(str, dims))} grid != "
                             f"{self.nnodes} nodes")
        shape = dims[::-1]  # (ny, nx) / (nz, ny, nx)
        # interleaved (node, comp) mask -> planar (comp, *shape)
        fine_mask = (
            self.bc.mask.cpu().numpy()
            .reshape(self.nnodes, nd).T.reshape((nd,) + shape)
        )
        physics = "elasticity" if nd == len(dims) else "poisson"
        kw = dict(p=self.p, dtype=self.dtype, device=self.device,
                  fine_mask=fine_mask)
        if physics == "elasticity":
            kw.update(E=self.E, nu=self.nu)
        kw.update(gmg_options)
        lengths = [float(X[:, k].max()) for k in range(len(dims))]
        cls = GMGAssembler if nnodes_z is None else GMGAssembler3D
        self._gmg_asm = cls(*dims, *lengths, physics, **kw)
        self._gmg_shape = shape
        return self

    def _solve_gmg(self, rho, rhs, rtol=1e-8, maxiter=400):
        from .. import multigrid
        from ..ops.dia import interleave_to_planar, planar_to_interleave

        shape = self._gmg_shape
        nd = self.ndof_per_node
        rho = self._as_nodal(rho)
        gmg, lv0 = self._gmg_asm.assemble(rho)
        rhs_g = interleave_to_planar(
            torch.as_tensor(rhs, dtype=self.dtype, device=self.device), nd
        ).reshape((nd,) + shape)
        vals_g = interleave_to_planar(
            self.bc.values.to(self.dtype), nd
        ).reshape((nd,) + shape)
        x0 = torch.where(lv0.mask, vals_g, 0.0)
        if bool(self.bc.values.any()):
            # nonzero Dirichlet values: the rhs lift through the fine
            # level's un-eliminated operator (the levels themselves are
            # eliminated), as the JAX package lifts on its XLA levels
            rhs_g = rhs_g - self._gmg_asm._dirichlet_lift(rho, x0)
        b = torch.where(lv0.mask, vals_g, rhs_g)
        # PCG from x0 (the JAX form) starts from r = b - A x0, which the
        # eliminated operator makes b at free dofs and 0 at fixed ones;
        # so the correction y = x - x0 is solved from y = 0 on that
        # residual, to the same stopping norm rtol ||b||.  (K6, the OTF
        # route's operator, takes no field that is nonzero at a fixed
        # dof, and the setup matvec is saved.)
        r0 = torch.where(lv0.mask, 0.0, b)
        bn, r0n = float(torch.linalg.norm(b)), float(torch.linalg.norm(r0))
        # a bf16 smoother copy makes the V-cycle vary with its input:
        # flexible PCG, as every caller of pcg_gmg on such a hierarchy
        y, k, rn = multigrid.pcg_gmg(
            gmg, lv0, r0, rtol=rtol * bn / r0n if r0n > 0 else rtol,
            maxiter=maxiter,
            flexible=self._gmg_asm.smoother_dtype is not None)
        x = x0 + y
        _check_converged("gmg-pcg", rn, rtol * bn, k)
        self.last_solve_stats = {
            "method": "gmg", "iters": int(k), "resnorm": float(rn),
        }
        return (planar_to_interleave(x.reshape(-1), nd),
                planar_to_interleave(b.reshape(-1), nd))

    def _solve_system(self, Ke, rhs, method="cg", rtol=1e-8, rho=None,
                      maxiter=None):
        """Apply BCs and solve K u = rhs.

        Returns:
            (u, b): solution and the BC-applied rhs (used by compliance).
        """
        if method != "direct" and any(
                v is not None and _is_complex(v) for v in (Ke, rho)):
            raise ValueError(
                f"complex-step inputs need solver='direct' (the host "
                f"scipy solve), got {method!r}")
        from .. import solvers

        if method == "pmg":
            if getattr(self, "_pmg", None) is None:
                raise RuntimeError(
                    "call attach_pmg(nx, ny, nz) before method='pmg'"
                )
            x, b, k, rn = self._pmg.solve(
                rho=rho if rho is not None else 1.0, rhs=rhs, rtol=rtol,
                maxiter=maxiter or 400,
            )
            _check_converged("pmg-pcg", rn,
                             rtol * float(torch.linalg.norm(b)), k)
            self.last_solve_stats = {
                "method": "pmg", "iters": int(k), "resnorm": float(rn),
            }
            return x, b
        if method == "gmg":
            if getattr(self, "_gmg_asm", None) is None:
                raise RuntimeError(
                    "call attach_structured_grid(nx, ny) before method='gmg'"
                )
            return self._solve_gmg(rho if rho is not None else 1.0, rhs,
                                   rtol=rtol)
        if method == "sharded_gmg":
            if getattr(self, "_sgmg", None) is None:
                raise RuntimeError(
                    "call attach_sharded_grid(mesh, nx, ny) before "
                    "method='sharded_gmg'"
                )
            return self._solve_sharded_gmg(
                rho if rho is not None else 1.0, rhs, rtol=rtol,
                maxiter=maxiter or 400)
        if method == "amg":
            return self._solve_amg(Ke, rhs, rtol, maxiter)
        if method == "direct":
            # a complex operator (complex-step probe) gives a complex u
            K, b = self.bc.apply_scipy(self.assemble_scipy(Ke), _host(rhs))
            return (torch.as_tensor(solvers.direct_solve(K, b),
                                    device=self.device),
                    torch.as_tensor(b, device=self.device))
        if method not in ("cg", "gmres"):
            raise ValueError(f"unknown solve method {method!r}")
        b = self.bc.constrain_rhs(rhs, lambda v: self.matvec(Ke, v))
        mask = self.bc.mask
        diag = self.diagonal(Ke)
        # unit entries at fixed dofs; guard unreferenced dofs (zero rows)
        inv_diag = 1.0 / torch.where(mask | (diag == 0), 1.0, diag)
        n0 = solvers.readbacks[method]
        # gmres: Jacobi on the right, for the nonsymmetric Newton tangents
        res = (solvers.cg if method == "cg" else solvers.gmres)(
            assembly.bc_elem_matvec, (Ke, self.conn_dof, mask, self.segments),
            b, inv_diag=inv_diag, rtol=rtol, maxiter=maxiter,
        )
        _check_converged(method, res.resnorm,
                         rtol * float(torch.linalg.norm(b)), res.iters)
        # observable convergence info; readbacks: host syncs of the loop
        self.last_solve_stats = {
            "method": method, "iters": int(res.iters),
            "resnorm": float(res.resnorm),
            "readbacks": solvers.readbacks[method] - n0,
        }
        return res.x, b

    def _solve_amg(self, Ke, rhs, rtol, maxiter):
        """Unstructured fast path (JAX ``models/base.py:438-466``): host
        smoothed-aggregation set-up, device AMG-PCG (pyamg's role,
        pyfem.py:2392-2400).  The structural set-up and the PCG runner
        are cached on the model (``_amg_cache``), so repeat solves
        (topology loops) pay only the value update.  ``amg_options``
        (e.g. ``{"max_offsets": 8192, "precond_dtype": torch.float32}``)
        go to ``unstructured.amg_pcg``."""
        from .. import solvers, unstructured

        if getattr(self, "_amg_cache", None) is None:
            self._amg_cache = {}
        t0 = time.perf_counter()
        K, b_np = self.bc.apply_scipy(self.assemble_scipy(Ke), _host(rhs))
        t_asm = time.perf_counter() - t0
        n0 = solvers.readbacks["amg"]
        x, k, rn = unstructured.amg_pcg(
            K, b_np, nd=self.ndof_per_node, coords=self.X_host,
            dtype=self.dtype, rtol=rtol, maxiter=maxiter or 10 * self.ndof,
            cache=self._amg_cache, device=self.device,
            **getattr(self, "amg_options", {}),
        )
        _check_converged("amg-pcg", rn, rtol * np.linalg.norm(b_np), k)
        # host-clock seconds: scipy assembly + BCs, AMG set-up, PCG
        times = self._amg_cache["times"]
        self.last_solve_stats = {
            "method": "amg", "iters": int(k), "resnorm": float(rn),
            "readbacks": solvers.readbacks["amg"] - n0,
            "assemble_s": t_asm, "setup_s": times["setup"],
            "pcg_s": times["pcg"],
        }
        return x, torch.as_tensor(b_np, dtype=self.dtype, device=self.device)

    @property
    def complex_dtype(self):
        """The complex dtype of a complex-step probe on this model."""
        return (torch.complex128 if self.dtype == torch.float64
                else torch.complex64)

    def _as_nodal(self, rho):
        """Broadcast scalar density to a nodal field (pyfem.py:1015-1016).

        A complex density keeps its imaginary part: it becomes
        :attr:`complex_dtype`, never a real cast.
        """
        if rho is None:
            rho = 1.0
        dtype = self.complex_dtype if _is_complex(rho) else self.dtype
        rho = torch.as_tensor(rho, dtype=dtype, device=self.device)
        return rho.expand(self.nnodes).clone() if rho.ndim == 0 else rho

    def _tables(self, dtype):
        """(Xe, dN, N, wq) in ``dtype``: the model's own, or cast to the
        complex dtype of a complex-step probe (``torch.einsum`` does not
        promote real operands)."""
        t = (self.Xe, self.dN, self.N, self.wq)
        return t if dtype == self.dtype else tuple(a.to(dtype) for a in t)
