"""Plain float64 reference of the Helmholtz density filter on a uniform
quad4 grid: ``(r0^2 S + M) rho = M x`` with natural (Neumann) boundaries,
S the Laplacian stiffness and M the consistent mass, both with the 2x2
Gauss rule; the backward product is its transpose ``M (r0^2 S + M)^-1``.
Solved by Jacobi-preconditioned CG to a tight tolerance.  Nothing here
imports the program under test.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from .elasticity import F64, shape_tables


class Filter:
    """dims: nodes per axis (x first); lengths: box edges (x first).
    ``lowp`` rounds the element matrices to that type before use."""

    def __init__(self, dims, lengths, r0, device, lowp=None):
        self.dims = tuple(int(n) for n in dims)
        self.shape = self.dims[::-1]
        self.dim = len(self.dims)
        h = [L / (n - 1) for L, n in zip(lengths, self.dims)]
        _, N, dN = shape_tables(self.dim)
        jinv = np.diag([2.0 / v for v in h])
        detj = float(np.prod([v / 2.0 for v in h]))
        G = dN @ jinv                                     # (nq, nn, dim)
        S = detj * np.einsum("qad,qbd->ab", G, G)
        M = detj * np.einsum("qa,qb->ab", N, N)
        self.K, self.M = (
            torch.tensor(a, dtype=F64, device=device) for a in (r0 * r0 * S + M, M))
        if lowp is not None:
            self.K, self.M = (a.to(lowp).to(F64) for a in (self.K, self.M))
        # local nodes in the element order of shape_tables: x fastest
        self.corners = [tuple(int(v) for v in row[::-1])
                        for row in _lex(self.dim)]
        self.diag_K = self._apply_diag(self.K)

    def _corner(self, f, off):
        return f[tuple(slice(o, o + n - 1) for o, n in zip(off, self.shape))]

    def _apply(self, A, u):
        ue = torch.stack([self._corner(u, off) for off in self.corners], -1)
        ye = ue @ A.T
        out = torch.zeros_like(u)
        for n, off in enumerate(self.corners):
            self._corner(out, off).add_(ye[..., n])
        return out

    def _apply_diag(self, A):
        out = torch.zeros(self.shape, dtype=F64, device=A.device)
        for n, off in enumerate(self.corners):
            self._corner(out, off).add_(A[n, n])
        return out

    def _solve_K(self, b, rtol=1e-12, maxiter=100000):
        x = torch.zeros_like(b)
        r = b.clone()
        bn = float(torch.linalg.norm(b))
        z = r / self.diag_K
        p = z
        rz = torch.sum(r * z)
        for k in range(1, maxiter + 1):
            Ap = self._apply(self.K, p)
            alpha = rz / torch.sum(p * Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            if k % 16 == 0 and float(torch.linalg.norm(r)) <= rtol * bn:
                return x
            z = r / self.diag_K
            rz_new = torch.sum(r * z)
            p = z + (rz_new / rz) * p
            rz = rz_new
        raise RuntimeError("reference filter solve did not converge")

    def forward(self, x):
        """rho = (r0^2 S + M)^-1 M x on the node grid."""
        return self._solve_K(self._apply(self.M, x.to(F64)))

    def backward(self, g):
        """M (r0^2 S + M)^-1 g, the forward map's transpose."""
        return self._apply(self.M, self._solve_K(g.to(F64)))


def _lex(dim):
    """Local node offsets (x first) in lexicographic order, x fastest."""
    return [c[::-1] for c in itertools.product((0, 1), repeat=dim)]
