"""Post-processing: strain/stress recovery, mass matrices, natural
frequencies, KS aggregation + adjoints (PyTorch port).

Port of ``pyfem_gpu_testflight_tpu/postprocess.py``, same names and
signatures.  Every function takes a model of this package and runs on
the model's device; element -> node sums are the deterministic segment
sums of :mod:`..assembly` (two runs give the same bits on the card).

Reference parity (stretch items from SURVEY.md §2.11 — capabilities of
the reference's independent implementations, tests/ref_plane_stress.py
and tests/ref_linear_poisson.py, not of its main library):

* quadrature/nodal strain recovery (ref_plane_stress.py:141-226):
  each node takes the strain of the *nearest* quadrature point of every
  incident element, averaged by incidence count;
* consistent mass matrix + shift-invert natural frequencies
  (ref_plane_stress.py:228-340), and a matrix-free block LOBPCG on the
  device (:func:`natural_frequencies_device`);
* KS (Kreisselmeier-Steinhauser) max-aggregate of the solution field
  and its adjoint right-hand side (ref_linear_poisson.py:200-290).
"""

from __future__ import annotations

import numpy as np
import torch

from . import assembly
from .models.base import OWN_OPERATOR, _is_complex, ramp
from .ops import geometry, stiffness

__all__ = [
    "quadrature_strains",
    "nodal_strains",
    "quadrature_stresses",
    "mass_matrix",
    "lumped_mass",
    "natural_frequencies",
    "natural_frequencies_device",
    "ks_aggregate",
    "ks_adjoint_rhs",
    "solve_adjoint",
]


def _field(model, v):
    """A dof or nodal vector on the model's device in the model's dtype,
    or its complex form for a complex-step probe."""
    dt = model.complex_dtype if _is_complex(v) else model.dtype
    return torch.as_tensor(v, device=model.device).to(dt)


def _displacement_gradients(model, u):
    """g[e,q,a,l] = d u_a / d x_l at quadrature points."""
    u = _field(model, u)
    Xe, dN, _, _ = model._tables(u.dtype)
    _, Ngrad = geometry.shape_gradients(Xe, dN)
    nd = model.ndof_per_node
    ue = u[model.conn_dof].reshape(model.nelems, model.nnodes_per_elem, nd)
    return torch.einsum("eqnl,ena->eqal", Ngrad, ue)


def quadrature_strains(model, u):
    """Voigt strains at quadrature points.

    Returns:
        (nelems, nquads, 3) for 2D [exx, eyy, gxy] or
        (nelems, nquads, 6) for 3D [exx, eyy, ezz, gxy, gyz, gzx]
        (engineering shear; same component order as the reference's
        B matrix, pyfem.py:1988-2011).
    """
    g = _displacement_gradients(model, u)
    if model.ndims == 2:
        return torch.stack(
            [g[..., 0, 0], g[..., 1, 1], g[..., 0, 1] + g[..., 1, 0]], dim=-1
        )
    return torch.stack(
        [
            g[..., 0, 0],
            g[..., 1, 1],
            g[..., 2, 2],
            g[..., 0, 1] + g[..., 1, 0],
            g[..., 1, 2] + g[..., 2, 1],
            g[..., 0, 2] + g[..., 2, 0],
        ],
        dim=-1,
    )


def _nearest_quad_per_node(etype):
    """perm[n] = index of the quadrature point closest to local node n."""
    d = np.linalg.norm(
        etype.node_coords[:, None, :] - etype.quad_pts[None, :, :], axis=-1
    )
    return np.argmin(d, axis=1)


def nodal_strains(model, u):
    """Average nearest-quadrature strains to the nodes.

    Mirrors ref_plane_stress.py:202-226: node value = mean over incident
    elements of the closest quadrature point's strain.  The sum over
    elements is the model's sorted node segments (no atomics).
    """
    eq = quadrature_strains(model, u)  # (nelems, nquads, nstr)
    perm = torch.as_tensor(_nearest_quad_per_node(model.etype),
                           device=eq.device)
    contrib = eq[:, perm, :]  # (nelems, nn, nstr)
    seg = model.node_segments
    sums = seg.sum_columns(contrib)
    counts = seg.lengths.to(eq.dtype)
    return sums / torch.clamp(counts, min=1.0)[:, None]


def quadrature_stresses(model, u, rho=None):
    """Voigt stresses s = C e (RAMP-scaled if rho given)."""
    e = quadrature_strains(model, u)
    mu, lam = model.mu, model.lam
    nd = model.ndims
    tr = e[..., :nd].sum(dim=-1)
    s_norm = 2.0 * mu * e[..., :nd] + lam * tr[..., None]
    s_shear = mu * e[..., nd:]
    s = torch.cat([s_norm, s_shear], dim=-1)
    if rho is not None:
        rho = _field(model, rho)
        N = model._tables(rho.dtype)[2]
        rho_q = geometry.interp_to_quads(N, rho[model.conn])
        s = s * ramp(rho_q, model.p)[..., None]
    return s


def mass_matrix(model, density=1.0):
    """Consistent element mass matrices (nelems, ndpe, ndpe).

    Scalar fields get N N^T; vector fields the block-diagonal expansion
    (ref_plane_stress.py:228-289).
    """
    Me = density * stiffness.mass_matrix(model.Xe, model.dN, model.N,
                                         model.wq)
    nd = model.ndof_per_node
    if nd == 1:
        return Me
    nn = model.nnodes_per_elem
    eye = torch.eye(nd, dtype=Me.dtype, device=Me.device)
    Mb = Me[:, :, None, :, None] * eye[None, None, :, None, :]
    return Mb.reshape(model.nelems, nn * nd, nn * nd)


def natural_frequencies(model, k=5, sigma=0.0, density=1.0, rho=None):
    """Lowest natural frequencies via shift-invert Lanczos on the host.

    Mirrors ref_plane_stress.py:320-340: reduce K and M to free dofs,
    ``eigsh(Kr, M=Mr, sigma=sigma, which='LM')``, return
    (omega, modes) as host arrays with modes zero at fixed dofs.
    """
    from scipy.sparse import linalg as sla

    K = model.assemble_scipy(model.element_jacobian() if rho is None
                             else model.element_jacobian(rho))
    M = model.assemble_scipy(mass_matrix(model, density))
    free = np.setdiff1d(np.arange(model.ndof), model.bc.fixed)
    Kr = K[free][:, free].tocsc()
    Mr = M[free][:, free].tocsc()
    eigs, vr = sla.eigsh(Kr, M=Mr, k=k, sigma=sigma, which="LM", tol=1e-6)
    modes = np.zeros((model.ndof, k))
    modes[free] = vr
    return np.sqrt(np.maximum(eigs, 0.0)), modes


def lumped_mass(model, density=1.0):
    """(ndof,) row-sum (lumped) mass vector from the consistent mass."""
    Me = mass_matrix(model, density)
    ones = torch.ones(model.ndof, dtype=Me.dtype, device=Me.device)
    return model.matvec(Me, ones)


# -- block LOBPCG (standard problem, largest eigenvalues) -------------------
#
# The algorithm of jax.experimental.sparse.linalg.lobpcg_standard, which
# the JAX package calls: an orthonormal X, P, R basis kept by SVQB, the
# residual projected out of span(X, P) twice, Rayleigh-Ritz on [X P R],
# P from the orthogonalized Ritz coefficients, no locking, and the same
# self-consistency convergence test.  torch.lobpcg takes only a matrix,
# not an operator, so the package keeps its own.


def _eigh_descending(A):
    w, V = torch.linalg.eigh(A)
    return w.flip(0), V.flip(1)


def _svqb(X):
    """Orthonormal basis of X's columns; columns of a numerically
    degenerate direction come out zero."""
    norms = torch.linalg.norm(X, dim=0, keepdim=True)
    X = X / torch.where(norms == 0, 1.0, norms)
    inner = X.T @ X
    w, V = _eigh_descending(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    sqrted = torch.where(tau > 0, torch.maximum(w, tau), 1.0) ** -0.5
    orthoX = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    orthoX = orthoX * keep.to(orthoX.dtype)
    norms = torch.linalg.norm(orthoX, dim=0, keepdim=True)
    keep = keep & (norms > 0.0)
    return orthoX / torch.where(keep, norms, 1.0)


def _orthonormalize(basis):
    return _svqb(_svqb(basis))


def _project_out(basis, U):
    """The component of U orthogonal to the orthonormal ``basis``; its
    nonzero columns orthonormal, any column that lost its norm zeroed."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    normU = torch.linalg.norm(U, dim=0, keepdim=True)
    return U * (normU >= 0.99).to(U.dtype)


def _extend_basis(X, m):
    """m orthonormal columns orthogonal to the orthonormal (n, k) X, by a
    block Householder reflector (deterministic)."""
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(Xupper)
    y = torch.cat([Xupper + u @ vt, Xlower], dim=0)
    other = torch.cat([torch.eye(m, dtype=X.dtype, device=X.device),
                       torch.zeros((n - k - m, m), dtype=X.dtype,
                                   device=X.device)], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
    h = -2 * (w @ (w[k:, :].T @ other))
    h[k:] += other
    return h


def _lobpcg_standard(A, X, m):
    """Top-k eigenpairs of the symmetric operator ``A`` (a callable on
    (n, k) blocks) from the start block X: (theta, U, iterations).  An
    eigenpair has converged when its residual norm is below
    eps * 10 n (|A v| + theta), eps the dtype's."""
    n, k = X.shape
    if k == 0 or 5 * k >= n:
        raise ValueError(f"LOBPCG needs 0 < 5 k < n, got k={k}, n={n}")
    tol = float(torch.finfo(X.dtype).eps)
    X = _orthonormalize(X)
    P = _extend_basis(X, k)
    AX = A(X)
    theta = torch.sum(X * AX, dim=0, keepdim=True)
    R = AX - theta * X
    i, converged = 0, 0
    while i < m and converged < k:  # one host read-back an iteration
        R = _project_out(torch.cat([X, P], dim=1), R)
        XPR = torch.cat([X, P, R], dim=1)
        theta, Q = _eigh_descending(XPR.T @ A(XPR))  # Rayleigh-Ritz
        B = Q[:, :k]
        B = B / torch.linalg.norm(B, dim=0, keepdim=True)
        X = XPR @ B
        X = X / torch.linalg.norm(X, dim=0, keepdim=True)
        q, _ = torch.linalg.qr(Q[:k, k:].T)
        P = XPR @ (Q[:, k:] @ q)
        normP = torch.linalg.norm(P, dim=0, keepdim=True)
        P = P / torch.where(normP == 0, 1.0, normP)
        AX = A(X)
        R = AX - theta[None, :k] * X
        resid = torch.linalg.norm(R, dim=0)
        reltol = 10 * n * (torch.linalg.norm(AX, dim=0) + theta[:k])
        converged = int(torch.sum(resid < tol * reltol))
        theta = theta[None, :k]
        i += 1
    return theta[0, :], X, i


def natural_frequencies_device(model, k=5, density=1.0, rho=None,
                               maxiter=200, tol=1e-9):
    """Lowest natural frequencies fully on the device (matrix-free LOBPCG).

    The device companion to :func:`natural_frequencies` (which keeps the
    reference's host shift-invert eigsh, ref_plane_stress.py:320-340):
    lumps the consistent mass (row sums), symmetrizes to the standard
    problem A = M^-1/2 K M^-1/2, and runs block LOBPCG on the flipped
    spectrum c I - A so the *smallest* modes come out — no factorization,
    only the element operator, applied to all k columns at once (one
    ``conn_dof`` gather, one batched product, one segment sum).

    ``tol`` is accepted and not used, as in the JAX package: LOBPCG runs
    at most ``maxiter`` iterations with its float-epsilon convergence
    test.  Lumped mass is a standard (slightly low-pass) approximation of
    the consistent-mass frequencies; verify against the host path when
    consistent-mass accuracy matters.

    Returns:
        (omega, modes): (k,) frequencies and (ndof, k) M-orthonormal
        modes, zero at fixed dofs.  ``model.last_eig_stats`` holds the
        LOBPCG iterations and the operator applications (blocks and
        columns).
    """
    Ke = model.element_jacobian(1.0 if rho is None else rho)
    ml = lumped_mass(model, density)
    mask = model.bc.mask
    inv_sqrt_m = torch.where(mask | (ml <= 0), 0.0, 1.0 / torch.sqrt(ml))
    seg = model.segments
    stats = {"applies": 0, "columns": 0}

    def A_free(V):  # maps the free subspace to itself (zero at mask)
        stats["applies"] += 1
        stats["columns"] += V.shape[1]
        W = inv_sqrt_m[:, None] * V
        KW = seg.sum_columns(torch.bmm(Ke, W[model.conn_dof]))
        return inv_sqrt_m[:, None] * KW

    # spectral upper bound of the free block by power iteration
    v = torch.where(mask[:, None], 0.0,
                    torch.ones((model.ndof, 1), dtype=ml.dtype,
                               device=ml.device))
    v = v / torch.linalg.norm(v)
    for _ in range(15):
        v = A_free(v)
        v = v / torch.linalg.norm(v)
    c = 1.2 * torch.dot(v[:, 0], A_free(v)[:, 0]) + 1.0

    # fixed dofs get 2c so they sit *below* every free mode on the
    # flipped spectrum c I - A (a 0 or O(1) value would interleave)
    def A(V):
        return A_free(V) + (2.0 * c) * torch.where(mask[:, None], V, 0.0)

    rng = np.random.RandomState(0)
    X0 = torch.as_tensor(rng.standard_normal((model.ndof, k)),
                         dtype=ml.dtype, device=ml.device)
    X0 = torch.where(mask[:, None], 0.0, X0)
    theta, U, iters = _lobpcg_standard(lambda V: c * V - A(V), X0, maxiter)
    lam = c - theta
    order = torch.argsort(lam)
    lam = lam[order]
    U = U[:, order]
    modes = torch.where(mask[:, None], 0.0, inv_sqrt_m[:, None] * U)
    model.last_eig_stats = dict(stats, iters=int(iters))
    return torch.sqrt(torch.clamp(lam, min=0.0)), modes


def _ks_weights(model, u, pval):
    """(w, offset): w[e,q] = w_q |J_q| exp(p (u_q - offset)), offset =
    the largest nodal value (by real part for a complex-step probe; the
    aggregate does not depend on it)."""
    u = _field(model, u)
    Xe, dN, N, wq = model._tables(u.dtype)
    detJ, _ = geometry.det_and_inv(geometry.jacobian(Xe, dN))
    uq = geometry.interp_to_quads(N, u[model.conn])
    offset = u[torch.argmax(u.real if u.is_complex() else u)]
    return detJ * wq[None, :] * torch.exp(pval * (uq - offset)), offset


def ks_aggregate(model, u, pval):
    """KS max-aggregate of the scalar field u over the domain.

    ks = max(u) + log( sum_{e,q} w_q |J_q| exp(p (u_q - max)) ) / p
    (ref_linear_poisson.py:200-234).
    """
    w, offset = _ks_weights(model, u, pval)
    return offset + torch.log(torch.sum(w)) / pval


def ks_adjoint_rhs(model, u, pval):
    """d ks / d u_n (ref_linear_poisson.py:237-290)."""
    w, _ = _ks_weights(model, u, pval)
    N = model._tables(w.dtype)[2]
    fe = torch.einsum("eq,qn->en", w / torch.sum(w), N)
    return assembly.assemble_vector(fe, model.conn, model.nnodes,
                                    model.node_segments)


def solve_adjoint(model, rhs, rho=1.0, method="cg", rtol=1e-10, **kw):
    """Solve K(rho)^T psi = rhs with homogeneous BCs at fixed dofs.

    K is symmetric for the linear models; the Newton tangent is handled
    by passing the model's current element Jacobian via ``Ke``.  Every
    method of the model's ``solve`` works; ``"gmg"`` and ``"pmg"`` build
    their operator from ``rho`` (the JAX function hands them no density,
    so there they solve at rho = 1).
    """
    Ke = kw.pop("Ke", None)
    if Ke is None and method not in OWN_OPERATOR:
        Ke = model.element_jacobian(rho)
    psi, _ = model._solve_system(Ke, _field(model, rhs), method, rtol,
                                 rho=rho, **kw)
    return psi
