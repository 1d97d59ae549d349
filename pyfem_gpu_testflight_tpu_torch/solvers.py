"""Linear and nonlinear solvers (PyTorch port of
``pyfem_gpu_testflight_tpu/solvers.py``).

* ``cg``: Jacobi-preconditioned conjugate gradients, the replacement for
  the reference's preconditioned ``scipy cg`` (pyfem.py:2402-2423).  It
  keeps the JAX ``lax.while_loop``'s stopping rule — iterate while
  ``r.r > max(rtol*||b||, atol)^2`` and ``k < maxiter`` — and its count.
  The loop runs on the device in blocks of ``CHECK_EVERY`` iterations
  and reads the convergence flag back to the host once per block; the
  iterations of a block past convergence are masked (``torch.where``
  keeps x, r, p and r.z; ``k`` counts active iterations only), so x,
  iters and resnorm equal those of a check after every iteration bit
  for bit.
* ``gmres``: restarted GMRES(m), right-preconditioned (Jacobi, or a
  general ``v -> M^-1 v`` such as a GMG V-cycle), for the nonsymmetric
  Newton tangents.  The Krylov basis and its CGS2 products stay on the
  device; each Arnoldi step reads its new Hessenberg column (at most
  m+1 numbers) back once, and the Givens rotations, the early-exit test
  and the back substitution run on the host in the solve's dtype.  So
  ``iters`` and the operator products executed are the JAX loop's: a
  system converging inside one cycle takes ``iters + 3`` products.
* ``direct_solve``: host scipy SuperLU, the float64 oracle (reference
  solver="direct", pyfem.py:2414).
* ``newton``: the reference's Newton contract (pyfem.py:2319-2355):
  relative tol against the first residual norm, an absolute floor,
  ``max_iter``, full reassembly per iteration.

Operator convention: ``(apply_fn, data)`` with ``apply_fn(data, x)``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

__all__ = ["cg", "cg_loop", "gmres", "gmres_loop", "direct_solve", "newton",
           "CGResult", "GMRESResult", "readbacks"]

# host read-backs: cg_loop's flag (one per block of CHECK_EVERY
# iterations), multigrid.pcg / pcg_gmg's r.r (one per iteration),
# gmres_loop's (the tolerance with the first residual, each restart
# cycle's entry and end residual norms, one Hessenberg column per Arnoldi
# step) and the fused Newton loop's flag (one per Newton iteration)
readbacks = {"cg": 0, "pcg": 0, "gmres": 0, "newton": 0}
# iterations between those read-backs (1 = the JAX loop's per-iteration test)
CHECK_EVERY = 16


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: torch.Tensor
    resnorm: torch.Tensor


class GMRESResult(NamedTuple):
    x: torch.Tensor
    iters: int
    resnorm: torch.Tensor


def _dot(a, b):
    return torch.dot(a.reshape(-1), b.reshape(-1))


def cg_loop(matvec, b, inv_diag=None, rtol=1e-8, atol=0.0, maxiter=1000,
            x0=None):
    """Jacobi-PCG; returns (x, iters, resnorm) as device tensors."""
    if inv_diag is None:
        inv_diag = torch.ones_like(b)
    normb = torch.linalg.norm(b)
    tol2 = torch.clamp(rtol * normb, min=atol) ** 2

    if x0 is None:  # r = b - A 0 = b: no setup matvec
        x, r = torch.zeros_like(b), b
    else:
        x, r = x0, b - matvec(x0)
    z = inv_diag * r
    p = z
    rz = _dot(r, z)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    done = False
    while not done:
        for _ in range(CHECK_EVERY):
            active = (_dot(r, r) > tol2) & (k < maxiter)
            Ap = matvec(p)
            alpha = rz / _dot(p, Ap)
            x = torch.where(active, x + alpha * p, x)
            r = torch.where(active, r - alpha * Ap, r)
            z = inv_diag * r
            rz_new = _dot(r, z)
            p = torch.where(active, z + (rz_new / rz) * p, p)
            rz = torch.where(active, rz_new, rz)
            k = k + active.long()
        readbacks["cg"] += 1
        done = not bool((_dot(r, r) > tol2) & (k < maxiter))
    return x, k, torch.sqrt(_dot(r, r))


def cg(
    apply_fn: Callable,
    data,
    b,
    *,
    inv_diag=None,
    x0=None,
    rtol=1e-8,
    atol=0.0,
    maxiter=None,
):
    """Preconditioned conjugate gradients.

    Args:
        apply_fn: ``apply_fn(data, x) -> A x``.
        data: operator data (element matrices, dof maps, masks, ...).
        b: right-hand side.
        inv_diag: inverse-diagonal (Jacobi) preconditioner; identity if
            None.
        rtol/atol: stop when ||r|| <= max(rtol*||b||, atol).
        maxiter: default 10 * ndof.

    Returns:
        CGResult(x, iters, resnorm).
    """
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    x, k, rn = cg_loop(lambda u: apply_fn(data, u), b, inv_diag=inv_diag,
                       rtol=rtol, atol=atol, maxiter=int(maxiter), x0=x0)
    return CGResult(x, k, rn)


def _host(t):
    """One read-back of a small device tensor, counted."""
    readbacks["gmres"] += 1
    return t.detach().cpu().numpy()


def _givens(hcol, cs, sn, g, j):
    """Rotate the new Hessenberg column ``hcol`` (host, in place) by the
    j earlier rotations, form rotation j and apply it to ``g``: the JAX
    loop's arithmetic, in the column's dtype (real or complex)."""
    for i in range(j):
        t = np.conj(cs[i]) * hcol[i] + np.conj(sn[i]) * hcol[i + 1]
        hcol[i + 1] = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
        hcol[i] = t
    hjj, hsub = hcol[j], hcol[j + 1]
    ahjj = np.abs(hjj)
    den = np.sqrt(ahjj * ahjj + np.abs(hsub) * np.abs(hsub))
    c_new = ahjj / den if den > 0 else 1.0
    phase = hjj / ahjj if ahjj > 0 else 1.0
    s_new = phase * np.conj(hsub) / den if den > 0 else 0.0
    cs[j] = c_new
    sn[j] = s_new
    hcol[j] = phase * den
    hcol[j + 1] = 0.0
    g[j + 1] = -sn[j] * g[j]
    g[j] = np.conj(cs[j]) * g[j]


def gmres_loop(matvec, b, inv_diag=None, rtol=1e-8, atol=0.0,
               maxiter=1000, restart=30, x0=None, precond=None):
    """Restarted GMRES(m), right-preconditioned, Givens-updated.

    Right preconditioning (solve A M^-1 y = b, x = M^-1 y) keeps the
    least-squares residual equal to the true residual ``||b - A x||``.
    ``precond`` (optional) is a general right preconditioner ``v ->
    M^-1 v`` (e.g. a GMG V-cycle); it must be a fixed linear operator
    across the solve.  When given, ``inv_diag`` is ignored.

    The basis ``V (m+1, n)`` lives on the device and is orthogonalized
    by two classical Gram-Schmidt passes (CGS2), each a pair of
    ``torch.matmul`` products in full float32 / float64 (TF32 is off,
    ``ops.precision``).  Each Arnoldi step reads its new Hessenberg
    column back once; the rotations, the early-exit test ``|g[j]| <=
    tol`` and the back substitution run on the host in the solve's
    dtype.  ``resnorm`` is the true residual recomputed at the end of
    each cycle.

    Returns:
        (x, iters, resnorm): ``iters`` (a Python int) is the exact number
        of Arnoldi steps executed (one ``A M^-1`` product each); a cycle
        exits early once the rotated residual dips under tolerance, so a
        system converging at inner step 3 pays 3 products, not m.
    """
    n = b.shape[0]
    if x0 is None:
        x0 = torch.zeros_like(b)
    if precond is not None:
        minv = precond
    else:
        if inv_diag is None:
            inv_diag = torch.ones_like(b)
        minv = lambda v: inv_diag * v
    m = int(min(restart, n))
    dt = torch.empty((), dtype=b.dtype).numpy().dtype  # host dtype
    rdt = torch.empty((), dtype=b.dtype).real.dtype
    normb = torch.linalg.norm(b)
    tol_t = torch.clamp(rtol * normb, min=atol).to(rdt)
    r0 = torch.linalg.norm(b - matvec(x0)).to(rdt)
    tol, rn_h = _host(torch.stack([tol_t, r0]))

    def cycle(x):
        r = b - matvec(x)
        beta = torch.linalg.norm(r)
        beta_h = _host(beta)
        V = torch.zeros((m + 1, n), dtype=b.dtype, device=b.device)
        V[0] = r / torch.where(beta > 0, beta, 1.0)
        H = np.zeros((m, m + 1), dt)  # row j = rotated column j
        cs = np.ones(m, dt)
        sn = np.zeros(m, dt)
        g = np.zeros(m + 1, dt)
        g[0] = beta_h
        j = 0
        while j < m and np.abs(g[j]) > tol:
            w = matvec(minv(V[j]))
            # classical Gram-Schmidt, twice (CGS2): unset rows of V are
            # zero, so the full-matrix products project on span(V[:j+1])
            Vc = V.conj()
            h = torch.matmul(Vc, w)
            w = w - torch.matmul(h, V)
            h2 = torch.matmul(Vc, w)
            w = w - torch.matmul(h2, V)
            h = h + h2
            hn = torch.linalg.norm(w)
            V[j + 1] = w / torch.where(hn > 0, hn, 1.0)
            h[j + 1] += hn.to(b.dtype)
            hcol = _host(h)
            _givens(hcol, cs, sn, g, j)
            H[j] = hcol
            j += 1
        # back substitution on the rotated (upper-triangular) system;
        # breakdown columns (H[j, j] == 0) carry y[j] = 0
        y = np.zeros(m, dt)
        for jj in range(m - 1, -1, -1):
            s = g[jj] - H[:, jj] @ y
            hjj = H[jj, jj]
            y[jj] = s / hjj if np.abs(hjj) > 0 else 0.0
        yt = torch.as_tensor(y, device=b.device)
        x = x + minv(torch.matmul(yt, V[:m]))
        rvec = b - matvec(x)
        rn = torch.sqrt(_dot(rvec.conj(), rvec).real)
        return x, rn, _host(rn), j

    x, k, rn = x0, 0, r0
    while rn_h > tol and k < maxiter:
        x, rn, rn_h, took = cycle(x)
        k += took
        if took == 0:  # the entry residual already met tol: no progress
            break
    return x, k, rn


def gmres(
    apply_fn: Callable,
    data,
    b,
    *,
    inv_diag=None,
    x0=None,
    rtol=1e-8,
    atol=0.0,
    maxiter=None,
    restart=30,
):
    """Jacobi-preconditioned restarted GMRES (for nonsymmetric K).

    Same calling convention as :func:`cg`; the Jacobi preconditioner is
    applied on the right so the reported residual is the true one.

    Returns:
        GMRESResult(x, iters, resnorm).
    """
    if maxiter is None:
        maxiter = 10 * b.shape[0]
    x, k, rn = gmres_loop(lambda u: apply_fn(data, u), b, inv_diag=inv_diag,
                          rtol=rtol, atol=atol, maxiter=int(maxiter),
                          restart=int(restart), x0=x0)
    return GMRESResult(x, k, rn)


def direct_solve(K_csr, rhs):
    """Host sparse direct solve (SuperLU), the float64 oracle path."""
    from scipy.sparse.linalg import spsolve

    return spsolve(K_csr.tocsr(), np.asarray(rhs))


def newton(
    residual_fn: Callable,
    jacobian_solve_fn: Callable,
    u0,
    *,
    tol=1e-10,
    atol=1e-12,
    max_iter=10,
    verbose=True,
    tag="pyfem-tpu",
):
    """Newton's method with the reference's convergence contract.

    Args:
        residual_fn: u -> residual (BCs applied).
        jacobian_solve_fn: (u, res) -> update solving K(u) du = res.
        u0: initial iterate.

    Returns:
        u: converged solution.
    """
    u = u0
    res_norm_init = None
    for k in range(max_iter):
        res = residual_fn(u)
        res_norm = float(torch.linalg.norm(res))
        if verbose:
            print(tag, "{0:5d} {1:25.15e}".format(k, res_norm))
        if k == 0:
            res_norm_init = res_norm
        elif res_norm < tol * res_norm_init or res_norm < atol:
            break
        u = u - jacobian_solve_fn(u, res)
    return u
