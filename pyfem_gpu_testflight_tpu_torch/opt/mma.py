"""Method of Moving Asymptotes (Svanberg 1987) with a ParOpt-shaped API.

Port of ``pyfem_gpu_testflight_tpu/opt/mma.py``: the NumPy optimizer loop and
dual solve are copied as they are; the device update
(:func:`device_update_body`, :func:`device_update_body_multi`) is
PyTorch, elementwise over design tensors on any device, with no host
synchronization (the JAX ``while_loop`` bracket is a masked loop of a
fixed 12 steps, the bisection 60 masked steps).

The reference drives topology optimization through the external C++
ParOpt MMA optimizer (examples/topology_optimization/topo.py:176-189).
This module provides an in-repo optimizer with the same user contract:

* ``Problem`` subclasses implement ``getVarsAndBounds``, ``evalObjCon``
  (returns ``fail, obj, con`` with the ParOpt convention con >= 0
  feasible) and ``evalObjConGradient`` (fills ``g`` and ``A[i]``);
* ``MMA(problem, options).optimize()`` runs the loop;
* ``Problem.checkGradients`` finite-differences the user gradients like
  ParOpt's checker (topo.py:187).

The MMA subproblem is solved in dual form.  For one constraint (the
topology-optimization case) the dual is a monotone scalar function of
the multiplier and is solved by bisection; for m > 1 a few sweeps of
coordinate-wise bisection are used.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["Problem", "MMA"]


class Problem:
    """Subclass and implement the three callbacks (ParOpt contract)."""

    def __init__(self, nvars: int, ncon: int = 1):
        self.nvars = int(nvars)
        self.ncon = int(ncon)

    def getVarsAndBounds(self, x, lb, ub):  # pragma: no cover - interface
        raise NotImplementedError

    def evalObjCon(self, x):  # pragma: no cover - interface
        raise NotImplementedError

    def evalObjConGradient(self, x, g, A):  # pragma: no cover - interface
        raise NotImplementedError

    def checkGradients(self, dh=1e-6, seed=0):
        """FD-check objective/constraint gradients along a random direction."""
        x = np.zeros(self.nvars)
        lb = np.zeros(self.nvars)
        ub = np.ones(self.nvars)
        self.getVarsAndBounds(x, lb, ub)
        rng = np.random.RandomState(seed)
        pert = rng.uniform(-1.0, 1.0, self.nvars)

        g = np.zeros(self.nvars)
        A = [np.zeros(self.nvars) for _ in range(self.ncon)]
        _, f0, c0 = self.evalObjCon(x)
        self.evalObjConGradient(x, g, A)
        _, f1, c1 = self.evalObjCon(x + dh * pert)

        results = []
        fd = (f1 - f0) / dh
        an = g.dot(pert)
        results.append(("objective", an, fd))
        for i in range(self.ncon):
            fd_c = (c1[i] - c0[i]) / dh
            an_c = A[i].dot(pert)
            results.append((f"con[{i}]", an_c, fd_c))
        for name, an_v, fd_v in results:
            rel = abs(an_v - fd_v) / max(1e-300, abs(fd_v))
            print(f"[checkGradients] {name}: analytic {an_v:+.8e}  "
                  f"fd {fd_v:+.8e}  rel err {rel:.3e}")
        return results


def _solve_dual_x(lam, p0, q0, P, Q, L, U, alpha, beta):
    """Primal minimizer of the separable MMA Lagrangian for multipliers lam."""
    p = p0 + P.T.dot(lam)
    q = q0 + Q.T.dot(lam)
    sp = np.sqrt(np.maximum(p, 0.0))
    sq = np.sqrt(np.maximum(q, 0.0))
    x = (sp * L + sq * U) / np.maximum(sp + sq, 1e-300)
    return np.clip(x, alpha, beta)


def _solve_x(lam_p, lam_q, p0, q0, L, U, alpha, beta):
    """Primal minimizer for the multiplier terms lam_p / lam_q already
    folded into p and q (torch; the JAX ``solve_x``, term for term)."""
    p = p0 + lam_p
    q = q0 + lam_q
    sp = torch.sqrt(torch.clamp(p, min=0.0))
    sq = torch.sqrt(torch.clamp(q, min=0.0))
    # 1e-300 is 0 in float32, as in the JAX package
    x = (sp * L + sq * U) / torch.clamp(sp + sq, min=1e-300)
    return torch.minimum(torch.maximum(x, alpha), beta)


def _asymptotes(x, xold1, xold2, low, upp, g, lb, ub, k, asy_grow,
                asy_shrink, albefa, move):
    """Svanberg's asymptote update, move limits and the objective's
    separable terms: (low, upp, alpha, beta, p0, q0, rng)."""
    rng = ub - lb
    sign = (x - xold1) * (xold1 - xold2)
    fac = torch.where(sign > 0, asy_grow,
                      torch.where(sign < 0, asy_shrink, torch.ones_like(x)))
    low2 = torch.minimum(torch.maximum(x - fac * (xold1 - low),
                                       x - 10.0 * rng), x - 0.01 * rng)
    upp2 = torch.minimum(torch.maximum(x + fac * (upp - xold1),
                                       x + 0.01 * rng), x + 10.0 * rng)
    if torch.is_tensor(k):
        low = torch.where(k >= 2, low2, low)
        upp = torch.where(k >= 2, upp2, upp)
    elif k >= 2:
        low, upp = low2, upp2
    alpha = torch.maximum(torch.maximum(lb, low + albefa * (x - low)),
                          x - move * rng)
    beta = torch.minimum(torch.minimum(ub, upp - albefa * (upp - x)),
                         x + move * rng)
    eps0 = 1e-5
    Umx = upp - x
    xmL = x - low
    p0 = Umx**2 * (torch.clamp(g, min=0.0) + 1e-3 * torch.abs(g)
                   + eps0 / rng)
    q0 = xmL**2 * (torch.clamp(-g, min=0.0) + 1e-3 * torch.abs(g)
                   + eps0 / rng)
    return low, upp, alpha, beta, p0, q0


_BRACKET_STEPS = 12  # hi = 1, 10, ..., 1e12: the JAX while_loop's reach
_BISECT_STEPS = 60


def _dual_root(con_value, c0, dtype, device):
    """The multiplier of one constraint: bracket then bisection, masked.

    ``con_value(lam)`` is increasing-then-feasible in lam as in the JAX
    package; its bracket ``while con(hi) > 0 and hi < 1e12: hi *= 10``
    becomes 12 masked steps (hi stops where the loop would), so nothing
    is read back to the host.
    """
    hi = torch.ones((), dtype=dtype, device=device)
    for _ in range(_BRACKET_STEPS):
        grow = (con_value(hi) > 0.0) & (hi < 1e12)
        hi = torch.where(grow, hi * 10.0, hi)
    lo = torch.zeros((), dtype=dtype, device=device)
    for _ in range(_BISECT_STEPS):
        mid = 0.5 * (lo + hi)
        gt = con_value(mid) > 0.0
        lo, hi = torch.where(gt, mid, lo), torch.where(gt, hi, mid)
    return torch.where(c0 <= 0.0, torch.zeros_like(lo), 0.5 * (lo + hi))


def device_update_body(x, xold1, xold2, low, upp, g, dc, ci, lb, ub, k,
                       *, asy_grow=1.2, asy_shrink=0.7, albefa=0.1,
                       move=0.2, mesh=None):
    """Single-constraint MMA update (asymptotes + dual bisection) on
    design tensors — the same math as the NumPy path, term for term as
    the JAX package's traced update.

    Args:
        x, xold1, xold2, low, upp, g, dc, lb, ub: (n,) tensors.
        ci: 0-d constraint value (gi = ci <= 0 feasible).
        k: iteration index (int or 0-d tensor).
        mesh: block-sharded design tensors on the ranks of a
            ``parallel.Mesh`` (the JAX ``psum_axis``): the dual
            bisection's sums and the step's max are all-reduced, so every
            rank solves the same global dual.

    Returns:
        (x_new, low, upp, lam, step), the last two 0-d tensors.
    """
    if mesh is None:
        gsum, gmax = torch.sum, torch.max
    else:
        gsum = lambda a: mesh.all_reduce(torch.sum(a))
        gmax = lambda a: mesh.all_reduce(torch.max(a), op="max")
    low, upp, alpha, beta, p0, q0 = _asymptotes(
        x, xold1, xold2, low, upp, g, lb, ub, k, asy_grow, asy_shrink,
        albefa, move)
    Umx = upp - x
    xmL = x - low
    P1 = Umx**2 * torch.clamp(dc, min=0.0)
    Q1 = xmL**2 * torch.clamp(-dc, min=0.0)
    ri = ci - gsum(P1 / Umx + Q1 / xmL)

    def solve_x(lam):
        return _solve_x(lam * P1, lam * Q1, p0, q0, low, upp, alpha, beta)

    def con_value(lam):
        xs = solve_x(lam)
        return ri + gsum(P1 / (upp - xs) + Q1 / (xs - low))

    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    lam = _dual_root(con_value, con_value(zero), x.dtype, x.device)
    x_new = solve_x(lam)
    step = gmax(torch.abs(x_new - x))
    return x_new, low, upp, lam, step


def device_update_body_multi(x, xold1, xold2, low, upp, g, dC, ci, lb,
                             ub, k, *, asy_grow=1.2, asy_shrink=0.7,
                             albefa=0.1, move=0.2, sweeps=8):
    """m-constraint MMA update (coordinate-sweep dual), as the NumPy
    path's m > 1 branch: ``sweeps`` rounds of coordinate-wise bracket +
    60-step bisection on each multiplier with the others held fixed.
    ``dC`` is (m, n), ``ci`` (m,) with gi = ci <= 0 feasible.

    Returns:
        (x_new, low, upp, lam (m,), step).
    """
    low, upp, alpha, beta, p0, q0 = _asymptotes(
        x, xold1, xold2, low, upp, g, lb, ub, k, asy_grow, asy_shrink,
        albefa, move)
    m = dC.shape[0]
    Umx = upp - x
    xmL = x - low
    P = Umx[None, :] ** 2 * torch.clamp(dC, min=0.0)
    Q = xmL[None, :] ** 2 * torch.clamp(-dC, min=0.0)
    ri = ci - torch.stack([torch.sum(P[i] / Umx + Q[i] / xmL)
                           for i in range(m)])

    def solve_x(lam):
        return _solve_x(lam @ P, lam @ Q, p0, q0, low, upp, alpha, beta)

    def con_value(lam, i):
        xs = solve_x(lam)
        return ri[i] + torch.sum(P[i] / (upp - xs) + Q[i] / (xs - low))

    onehot = torch.eye(m, dtype=torch.bool, device=x.device)
    put = lambda lam, i, v: torch.where(onehot[i], v, lam)
    lam = torch.zeros((m,), dtype=x.dtype, device=x.device)
    for _ in range(sweeps):
        for i in range(m):
            c0v = con_value(put(lam, i, 0.0), i)
            lam_i = _dual_root(lambda h, lam=lam, i=i:
                               con_value(put(lam, i, h), i),
                               c0v, x.dtype, x.device)
            lam = put(lam, i, lam_i)
    x_new = solve_x(lam)
    step = torch.max(torch.abs(x_new - x))
    return x_new, low, upp, lam, step


class MMA:
    """Method of Moving Asymptotes optimizer.

    Options (dict): ``max_iterations`` (200), ``move_limit`` (0.5 of the
    var range, asymptote clamp), ``asymptote_init`` (0.5),
    ``asymptote_shrink`` (0.7), ``asymptote_grow`` (1.2), ``tol`` (KKT
    style infinity-norm of the design step, 0 disables early stop),
    ``verbose`` (True), ``callback`` (called with (k, x, obj, con)).
    """

    def __init__(self, problem: Problem, options=None):
        self.problem = problem
        o = dict(options or {})
        self.max_iterations = int(o.get("max_iterations", o.get("mma_max_iterations", 200)))
        self.asy_init = float(o.get("asymptote_init", 0.5))
        self.asy_shrink = float(o.get("asymptote_shrink", 0.7))
        self.asy_grow = float(o.get("asymptote_grow", 1.2))
        self.move = float(o.get("move_limit", 0.2))
        self.albefa = float(o.get("albefa", 0.1))
        self.tol = float(o.get("tol", 0.0))
        self.verbose = bool(o.get("verbose", True))
        self.callback = o.get("callback")
        # device=True/"auto": the torch subproblem (keeps the design
        # update on the design tensor's device: the problem's ``device``
        # attribute, else the CPU); False: NumPy reference
        self.device = o.get("device", "auto")
        self.history = []

    def optimize(self):
        prob = self.problem
        n, m = prob.nvars, prob.ncon
        x = np.zeros(n)
        lb = np.zeros(n)
        ub = np.ones(n)
        prob.getVarsAndBounds(x, lb, ub)
        x = np.clip(x, lb, ub)
        rng = ub - lb
        xold1 = x.copy()
        xold2 = x.copy()
        low = x - self.asy_init * rng
        upp = x + self.asy_init * rng

        g = np.zeros(n)
        A = [np.zeros(n) for _ in range(m)]

        # "auto" keeps the NumPy coordinate-sweep dual as the m > 1
        # default (the oracle path); device=True forces the torch
        # subproblem for any m (single-constraint dual bisection, or
        # the coordinate-sweep dual of device_update_body_multi)
        use_device = self.device is True or (
            m == 1 and self.device == "auto"
        )
        if use_device:
            import functools

            dev = torch.device(getattr(prob, "device", None) or "cpu")
            upd = functools.partial(
                device_update_body if m == 1 else device_update_body_multi,
                asy_grow=self.asy_grow, asy_shrink=self.asy_shrink,
                albefa=self.albefa, move=self.move,
            )
            t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                          device=dev)
            x = t(x)
            xold1, xold2 = x, x
            low_d, upp_d = t(low), t(upp)
            lb_d, ub_d = t(lb), t(ub)

        for k in range(self.max_iterations):
            fail, f0, con = prob.evalObjCon(x)
            if fail:
                raise RuntimeError(f"evalObjCon failed at iteration {k}")
            fail = prob.evalObjConGradient(x, g, A)
            if fail:
                raise RuntimeError(f"evalObjConGradient failed at iteration {k}")
            con = np.atleast_1d(np.asarray(con, dtype=float))
            # ParOpt convention con >= 0 feasible -> gi = -con <= 0
            ci = -con
            dci = -np.stack([np.asarray(a, dtype=float) for a in A])

            if use_device:
                x_new, low_d, upp_d, lam_d, step_d = upd(
                    x, xold1, xold2, low_d, upp_d, t(g),
                    t(dci[0]) if m == 1 else t(dci),
                    t(ci[0]) if m == 1 else t(ci), lb_d, ub_d, k,
                )
                lam = np.atleast_1d(lam_d.detach().cpu().numpy()).astype(
                    float)
                step = float(step_d)
                self.history.append(
                    {"iter": k, "obj": float(f0), "con": con.tolist(),
                     "step": step, "lam": lam.tolist()}
                )
                if self.verbose:
                    print(
                        f"[mma] {k:4d} obj {f0: .8e} con "
                        + " ".join(f"{c: .3e}" for c in con)
                        + f" step {step:.3e}"
                    )
                if self.callback is not None:
                    self.callback(k, x, f0, con)
                xold2, xold1 = xold1, x
                x = x_new
                if self.tol > 0.0 and step < self.tol:
                    break
                continue

            # -- asymptote update (Svanberg's rule) -----------------------
            if k >= 2:
                sign = (x - xold1) * (xold1 - xold2)
                fac = np.ones(n)
                fac[sign > 0] = self.asy_grow
                fac[sign < 0] = self.asy_shrink
                low = x - fac * (xold1 - low)
                upp = x + fac * (upp - xold1)
                low = np.clip(low, x - 10.0 * rng, x - 0.01 * rng)
                upp = np.clip(upp, x + 0.01 * rng, x + 10.0 * rng)

            # Svanberg's bounds: stay inside the asymptotes by albefa and
            # within a move limit of the variable range
            alpha = np.maximum.reduce(
                [lb, low + self.albefa * (x - low), x - self.move * rng]
            )
            beta = np.minimum.reduce(
                [ub, upp - self.albefa * (upp - x), x + self.move * rng]
            )

            # -- separable approximations --------------------------------
            eps0 = 1e-5
            df = np.asarray(g, dtype=float)
            Umx = upp - x
            xmL = x - low
            p0 = Umx**2 * (np.maximum(df, 0.0) + 1e-3 * np.abs(df) + eps0 / rng)
            q0 = xmL**2 * (np.maximum(-df, 0.0) + 1e-3 * np.abs(df) + eps0 / rng)
            P = Umx[None, :] ** 2 * np.maximum(dci, 0.0)
            Q = xmL[None, :] ** 2 * np.maximum(-dci, 0.0)
            # subproblem constraint offsets: gi(x) approximated value at x
            ri = ci - (P / Umx[None, :] + Q / xmL[None, :]).sum(axis=1)

            # -- dual solve ----------------------------------------------
            lam = np.zeros(m)

            def con_value(lam, i):
                xs = _solve_dual_x(lam, p0, q0, P, Q, low, upp, alpha, beta)
                return ri[i] + (P[i] / (upp - xs) + Q[i] / (xs - low)).sum()

            for _ in range(1 if m == 1 else 8):  # coordinate sweeps
                for i in range(m):
                    # bisection on lam[i]: constraint value decreasing? it is
                    # increasing in lam... find bracket
                    lam_i = lam.copy()
                    lam_i[i] = 0.0
                    c0v = con_value(lam_i, i)
                    if c0v <= 0.0:
                        lam[i] = 0.0
                        continue
                    lo_b, hi_b = 0.0, 1.0
                    lam_i[i] = hi_b
                    while con_value(lam_i, i) > 0.0 and hi_b < 1e12:
                        hi_b *= 10.0
                        lam_i[i] = hi_b
                    for _ in range(60):
                        mid = 0.5 * (lo_b + hi_b)
                        lam_i[i] = mid
                        if con_value(lam_i, i) > 0.0:
                            lo_b = mid
                        else:
                            hi_b = mid
                    lam[i] = 0.5 * (lo_b + hi_b)

            x_new = _solve_dual_x(lam, p0, q0, P, Q, low, upp, alpha, beta)

            step = np.abs(x_new - x).max()
            self.history.append(
                {"iter": k, "obj": float(f0), "con": con.tolist(),
                 "step": float(step), "lam": lam.tolist()}
            )
            if self.verbose:
                print(
                    f"[mma] {k:4d} obj {f0: .8e} con "
                    + " ".join(f"{c: .3e}" for c in con)
                    + f" step {step:.3e}"
                )
            if self.callback is not None:
                self.callback(k, x, f0, con)

            xold2, xold1 = xold1, x
            x = x_new
            if self.tol > 0.0 and step < self.tol:
                break

        self.x = x
        return x
