"""Plain float64 reference of RAMP linear elasticity on a structured grid.

Quad4 plane stress in 2D and hex8 in 3D, both with 2-point Gauss rules
per axis, written from the textbook element formulation.  The stiffness
at a Gauss point is ``ramp(rho_q) * w_q |J| B^T C B``, with ``rho_q`` the
bilinear (trilinear) interpolation of the nodal density and
``ramp(r) = r / (1 + p (1 - r))``.  The operator is applied element by
element in blocks of element rows (slices of the node grid, no assembled
matrix), so it fits beside anything at the benchmark's sizes.

:func:`solve` is an independent solver for the same system: conjugate
gradients preconditioned by a geometric V-cycle on rediscretized coarse
grids (the density injected to every second node, damped Jacobi
smoothing, bilinear transfers, a dense coarsest solve).  It shares no
code and no design with the program under test, only the equations.

Fields are node grids with the components last: ``(ny, nx, nd)`` in 2D,
``(nz, ny, nx, nd)`` in 3D.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

F64 = torch.float64
ELEMS_PER_BLOCK = 1 << 20


def ramp(r, p):
    return r / (1.0 + p * (1.0 - r))


def ramp_deriv(r, p):
    return (1.0 + p) / (1.0 + p * (1.0 - r)) ** 2


def _corners(dim):
    """Local corner signs, x fastest: (nn, dim) with x in column 0."""
    return np.array([c[::-1] for c in itertools.product((-1, 1), repeat=dim)],
                    dtype=np.float64)


def shape_tables(dim):
    """Gauss points (weight 1 each), (nq, nn) values, (nq, nn, dim)
    local derivatives of the linear element."""
    c = _corners(dim)
    pts = c / np.sqrt(3.0)
    lin = 1.0 + pts[:, None, :] * c[None]
    N = np.prod(lin, axis=-1) / 2 ** dim
    dN = np.empty(N.shape + (dim,))
    for k in range(dim):
        dN[..., k] = c[None, :, k] * np.prod(np.delete(lin, k, -1),
                                             axis=-1) / 2 ** dim
    return pts, N, dN


def material(E, nu, dim):
    """Voigt constitutive matrix: plane stress in 2D, isotropic in 3D."""
    if dim == 2:
        f = E / (1.0 - nu * nu)
        return f * np.array([[1.0, nu, 0.0], [nu, 1.0, 0.0],
                             [0.0, 0.0, 0.5 * (1.0 - nu)]])
    lam = E * nu / ((1.0 + nu) * (1.0 - 2.0 * nu))
    mu = E / (2.0 * (1.0 + nu))
    C = np.zeros((6, 6))
    C[:3, :3] = lam
    C[:3, :3] += 2.0 * mu * np.eye(3)
    C[3:, 3:] = mu * np.eye(3)
    return C


def _strain_matrix(g, dim):
    """B (nvoigt, nn*dim) from physical shape gradients g (nn, dim)."""
    nn = g.shape[0]
    if dim == 2:
        B = np.zeros((3, 2 * nn))
        B[0, 0::2], B[1, 1::2] = g[:, 0], g[:, 1]
        B[2, 0::2], B[2, 1::2] = g[:, 1], g[:, 0]
        return B
    B = np.zeros((6, 3 * nn))
    gx, gy, gz = g.T
    B[0, 0::3], B[1, 1::3], B[2, 2::3] = gx, gy, gz
    B[3, 1::3], B[3, 2::3] = gz, gy
    B[4, 0::3], B[4, 2::3] = gz, gx
    B[5, 0::3], B[5, 1::3] = gy, gx
    return B


class Grid:
    """A uniform box grid of linear elasticity elements.

    dims: nodes per axis (x first); lengths: box edges (x first).
    ``lowp`` (e.g. torch.bfloat16) rounds the element data (the unit
    matrices and the Gauss-point material) to that type before use, the
    operator a lower-precision program would hold.
    """

    def __init__(self, dims, lengths, E, nu, p, device, lowp=None):
        self.dims = tuple(int(n) for n in dims)
        self.lengths = tuple(float(v) for v in lengths)
        self.E, self.nu = float(E), float(nu)
        self.dim = len(self.dims)
        self.nd = self.dim
        self.shape = self.dims[::-1]                  # node grid, z/y/x
        self.eshape = tuple(n - 1 for n in self.shape)
        self.p = float(p)
        self.device = device
        self.lowp = lowp
        h = [L / (n - 1) for L, n in zip(self.lengths, self.dims)]
        _, N, dN = shape_tables(self.dim)
        jinv = np.diag([2.0 / v for v in h])
        detj = float(np.prod([v / 2.0 for v in h]))
        C = material(E, nu, self.dim)
        Kq = np.stack([detj * _strain_matrix(dN[q] @ jinv, self.dim).T @ C
                       @ _strain_matrix(dN[q] @ jinv, self.dim)
                       for q in range(N.shape[0])])
        self.N = torch.tensor(N, dtype=F64, device=device)
        Kq = torch.tensor(Kq, dtype=F64, device=device)
        if lowp is not None:
            Kq = Kq.to(lowp).to(F64)
        self.Kq = Kq                                  # (nq, ne, ne)
        ne = Kq.shape[1]
        # ue @ KqT gives every Gauss point's Kq ue at once: (B, nq*ne)
        self.KqT = Kq.permute(2, 0, 1).reshape(ne, -1).contiguous()
        self.diagq = torch.diagonal(Kq, dim1=1, dim2=2)  # (nq, ne)
        self.corners = [tuple(int(v > 0) for v in c[::-1])
                        for c in _corners(self.dim)]   # offsets, z/y/x
        per_row = int(np.prod(self.eshape[1:]))
        self.rows = max(1, ELEMS_PER_BLOCK // per_row)

    def coarse(self):
        """The grid with every second node, or None at the coarsest."""
        if any(n < 5 or (n - 1) % 2 for n in self.dims):
            return None
        return Grid([(n - 1) // 2 + 1 for n in self.dims], self.lengths,
                    self.E, self.nu, self.p, self.device, self.lowp)

    # -- element blocks -----------------------------------------------------

    def _blocks(self):
        n = self.eshape[0]
        for a in range(0, n, self.rows):
            yield a, min(n, a + self.rows)

    def _corner(self, field, off, a, b):
        sl = (slice(a + off[0], b + off[0]),) + tuple(
            slice(o, o + e) for o, e in zip(off[1:], self.eshape[1:]))
        return field[sl]

    def _elem_vec(self, u, a, b):
        """(..elems.., nn*nd) element vectors of u (*shape, nd)."""
        return torch.cat([self._corner(u, off, a, b)
                          for off in self.corners], dim=-1)

    def _scatter(self, out, ye, a, b, width):
        for n, off in enumerate(self.corners):
            self._corner(out, off, a, b).add_(ye[..., n * width:(n + 1) * width])

    def _rho_q(self, rho, a, b):
        """(..elems.., nq) density at the Gauss points."""
        rc = torch.stack([self._corner(rho, off, a, b)
                          for off in self.corners], dim=-1)
        return rc @ self.N.T

    def _cq(self, rho, a, b):
        c = ramp(self._rho_q(rho, a, b), self.p)
        return c if self.lowp is None else c.to(self.lowp).to(F64)

    # -- operator -----------------------------------------------------------

    def apply(self, rho, u):
        """K(rho) u, no boundary conditions."""
        out = torch.zeros_like(u)
        nq, ne = self.Kq.shape[:2]
        for a, b in self._blocks():
            cq = self._cq(rho, a, b)
            ue = self._elem_vec(u, a, b)
            y = (ue @ self.KqT).reshape(ue.shape[:-1] + (nq, ne))
            ye = (cq[..., None] * y).sum(-2)
            self._scatter(out, ye, a, b, self.nd)
        return out

    def diagonal(self, rho):
        """The diagonal of K(rho), (*shape, nd)."""
        out = torch.zeros(self.shape + (self.nd,), dtype=F64,
                          device=self.device)
        for a, b in self._blocks():
            self._scatter(out, self._cq(rho, a, b) @ self.diagq, a, b,
                          self.nd)
        return out

    def compliance_sens(self, rho, u):
        """d(u^T K(rho) u)/d rho at the nodes, for a fixed u."""
        out = torch.zeros_like(rho)
        nq, ne = self.Kq.shape[:2]
        for a, b in self._blocks():
            dq = ramp_deriv(self._rho_q(rho, a, b), self.p)
            ue = self._elem_vec(u, a, b)
            y = (ue @ self.KqT).reshape(ue.shape[:-1] + (nq, ne))
            s = (y * ue[..., None, :]).sum(-1)          # u_e^T Kq u_e
            self._scatter(out[..., None], (dq * s) @ self.N, a, b, 1)
        return out


def cantilever(grid):
    """(fixed mask (*shape, nd), load (*shape, nd)): the x = 0 face
    clamped; a unit downward force on every node of the edge x = Lx,
    y = 0 (one node in 2D, a line of nodes in 3D)."""
    fixed = torch.zeros(grid.shape + (grid.nd,), dtype=torch.bool,
                        device=grid.device)
    fixed[..., 0, :] = True
    f = torch.zeros(grid.shape + (grid.nd,), dtype=F64, device=grid.device)
    f[..., 0, -1, 1] = -1.0
    return fixed, f


# -- the independent solver ----------------------------------------------------


def _prolong_axis(c, axis):
    n = c.shape[axis]
    shape = list(c.shape)
    shape[axis] = 2 * n - 1
    out = c.new_zeros(shape)
    ev = [slice(None)] * c.dim()
    ev[axis] = slice(0, None, 2)
    out[tuple(ev)] = c
    od = list(ev)
    od[axis] = slice(1, None, 2)
    lo, hi = list(ev), list(ev)
    lo[axis], hi[axis] = slice(0, n - 1), slice(1, n)
    out[tuple(od)] = 0.5 * (c[tuple(lo)] + c[tuple(hi)])
    return out


def _restrict_axis(f, axis):
    """The transpose of :func:`_prolong_axis`."""
    n = f.shape[axis]
    ev = [slice(None)] * f.dim()
    ev[axis] = slice(0, None, 2)
    out = f[tuple(ev)].clone()
    od = list(ev)
    od[axis] = slice(1, None, 2)
    half = 0.5 * f[tuple(od)]
    lo, hi = list(ev), list(ev)
    lo[axis], hi[axis] = slice(0, (n - 1) // 2), slice(1, None)
    out[tuple(lo)] += half
    out[tuple(hi)] += half
    return out


def prolong(c, dim):
    for ax in range(dim):
        c = _prolong_axis(c, ax)
    return c


def restrict(f, dim):
    for ax in range(dim):
        f = _restrict_axis(f, ax)
    return f


class _Level:
    def __init__(self, grid, rho, fixed):
        self.grid, self.rho, self.fixed = grid, rho, fixed
        d = grid.diagonal(rho)
        self.inv_diag = torch.where(fixed, 0.0, 1.0 / d)
        self.dense = None

    def apply(self, u):
        """The operator with the fixed dofs eliminated (identity rows)."""
        free = torch.where(self.fixed, 0.0, u)
        return torch.where(self.fixed, u, self.grid.apply(self.rho, free))


class Multigrid:
    """A V-cycle on rediscretized grids, as a CG preconditioner."""

    def __init__(self, grid, rho, fixed, sweeps=2, omega=None):
        self.dim = grid.dim
        self.sweeps = int(sweeps)
        self.omega = float(omega if omega is not None
                           else (0.6 if grid.dim == 2 else 0.5))
        self.levels = [_Level(grid, rho, fixed)]
        g = grid.coarse()
        while g is not None:
            sl = (slice(None, None, 2),) * self.dim
            rho, fixed = rho[sl], fixed[sl]
            self.levels.append(_Level(g, rho, fixed))
            g = g.coarse()
        last = self.levels[-1]
        n = last.fixed.numel()
        eye = torch.eye(n, dtype=F64, device=grid.device)
        cols = torch.stack([last.apply(e.reshape(last.fixed.shape)).reshape(-1)
                            for e in eye])
        last.dense = torch.linalg.inv(cols.T)

    def _cycle(self, k, b):
        lv = self.levels[k]
        if lv.dense is not None:
            return (lv.dense @ b.reshape(-1)).reshape(b.shape)
        x = self.omega * lv.inv_diag * b
        for _ in range(self.sweeps - 1):
            x = x + self.omega * lv.inv_diag * (b - lv.apply(x))
        r = torch.where(lv.fixed, 0.0, b - lv.apply(x))
        cf = self.levels[k + 1].fixed
        rc = torch.where(cf, 0.0, restrict(r, self.dim))
        x = x + torch.where(lv.fixed, 0.0,
                            prolong(self._cycle(k + 1, rc), self.dim))
        for _ in range(self.sweeps):
            x = x + self.omega * lv.inv_diag * (b - lv.apply(x))
        return x

    def __call__(self, r):
        return self._cycle(0, r)


def solve(grid, rho, fixed, f, rtol=1e-10, maxiter=300):
    """u with K(rho) u = f at the free dofs and u = 0 at the fixed ones:
    (u, iterations, relative residual).  Raises if it does not converge."""
    rho = rho.to(F64)
    mg = Multigrid(grid, rho, fixed)
    A = mg.levels[0].apply
    b = torch.where(fixed, 0.0, f.to(F64))
    bn = float(torch.linalg.norm(b))
    x = torch.zeros_like(b)
    r = b.clone()
    z = mg(r)
    p = z
    rz = torch.sum(r * z)
    for k in range(1, maxiter + 1):
        Ap = A(p)
        alpha = rz / torch.sum(p * Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        rn = float(torch.linalg.norm(r)) / bn
        if rn <= rtol:
            return x, k, rn
        z = mg(r)
        rz_new = torch.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    raise RuntimeError(f"reference solve: relative residual {rn:.3e} after "
                       f"{maxiter} iterations")
