"""Plain float64 reference of one Method of Moving Asymptotes update with
one constraint (Svanberg 1987; the subproblem of his ``mmasub``: the
move limits ``alpha``/``beta`` from ``albefa`` and the move limit, the
separable terms ``p0 = (U-x)^2 (g+ + 1e-3 |g| + 1e-5/range)`` and the
mirror ``q0``, the constraint's terms from its gradient, and the dual
solved for its one multiplier by bisection to machine precision; where
no multiplier up to 1e12 makes the step feasible, the largest is taken).

Given the asymptotes the update used, it returns the new design.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def update(x, low, upp, g, dc, ci, lb, ub, albefa=0.1, move=0.2):
    """x_new of the subproblem at x with asymptotes (low, upp), objective
    gradient g, constraint value ci (feasible: ci <= 0) and its gradient
    dc, bounds lb, ub (scalars)."""
    x, low, upp, g, dc = (t.to(F64) for t in (x, low, upp, g, dc))
    rng = ub - lb
    alpha = torch.clamp(torch.maximum(low + albefa * (x - low),
                                      x - move * rng), min=lb)
    beta = torch.clamp(torch.minimum(upp - albefa * (upp - x),
                                     x + move * rng), max=ub)
    Umx, xmL = upp - x, x - low
    p0 = Umx ** 2 * (torch.clamp(g, min=0) + 1e-3 * g.abs() + 1e-5 / rng)
    q0 = xmL ** 2 * (torch.clamp(-g, min=0) + 1e-3 * g.abs() + 1e-5 / rng)
    P = Umx ** 2 * torch.clamp(dc, min=0)
    Q = xmL ** 2 * torch.clamp(-dc, min=0)
    r = float(ci) - float(torch.sum(P / Umx + Q / xmL))

    def x_of(lam):
        sp = torch.sqrt(p0 + lam * P)
        sq = torch.sqrt(q0 + lam * Q)
        return torch.clamp((sp * low + sq * upp) / (sp + sq), alpha, beta)

    def con(lam):
        xs = x_of(lam)
        return r + float(torch.sum(P / (upp - xs) + Q / (xs - low)))

    if con(0.0) <= 0.0:
        return x_of(0.0)
    hi = 1.0
    while con(hi) > 0.0 and hi < 1e12:   # an infeasible step saturates
        hi *= 10.0
    lo = 0.0
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if con(mid) > 0.0:
            lo = mid
        else:
            hi = mid
        if hi - lo <= 1e-15 * hi:
            break
    return x_of(0.5 * (lo + hi))
