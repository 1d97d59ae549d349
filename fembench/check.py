"""How ``correct`` is decided: the program's answers against the plain
float64 reference in ``fembench/reference/``, each number beside its
limit from ``fembench/limits/<cell>.json``.  Each entry module
(``fembench/entries/``) judges its own answers with the pieces here.

The reference rebuilds from the benchmark's own inputs (the configuration
and the seeded designs) everything the program derived from them; it
reads the program's answers only to judge them.  It runs once the window
has closed and the program's state is freed.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import torch

from .reference import elasticity as ref

F64 = torch.float64
HERE = Path(__file__).resolve().parent


def load_limits(cell):
    return json.loads((HERE / "limits" / f"{cell}.json").read_text())


def ref_grid(cfg, device, lowp=None):
    ph = cfg["physics"]
    return ref.Grid(cfg["grid"], cfg["lengths"], ph["E"], ph["nu"], ph["p"],
                    device, lowp=lowp)


def as_grid(grid, u):
    """An interleaved flat dof vector as the reference's node grid."""
    return u.reshape(grid.shape + (grid.nd,)).to(F64)


def solve_numbers(grid, rho, u, fixed, f, want_err):
    """The numbers of one answer u to K(rho) u = f:

    * ``resid``: ||f - K u|| / ||f|| over the free dofs, K the float64
      reference operator (the answer's backward error);
    * ``fixed``: max |u| at the clamped dofs (exactly 0);
    * ``err`` (with ``want_err``): ||u - u_ref|| / ||u_ref||, u_ref the
      reference's own float64 solve (the forward error).
    """
    r = torch.where(fixed, 0.0, f - grid.apply(rho, u))
    out = {"resid": float(torch.linalg.norm(r) / torch.linalg.norm(f)),
           "fixed": float(torch.where(fixed, u.abs(), 0.0).max())}
    if want_err:
        u_ref, _, _ = ref.solve(grid, rho, fixed, f)
        out["err"] = float(torch.linalg.norm(u - u_ref)
                           / torch.linalg.norm(u_ref))
    return out


def worst(rows):
    """Each number's largest reading over the answers (NaN wins)."""
    out = {}
    for row in rows:
        for k, v in row.items():
            if k not in out or not (v <= out[k]):
                out[k] = v
    return out


def judge(numbers, limits):
    """(correct, [[name, value, limit]]) over the limits' names; a number
    missing or not finite fails."""
    rows, ok = [], True
    for name, lim in limits.items():
        v = numbers.get(name, float("nan"))
        good = (lim["limit"] is not None and math.isfinite(v)
                and v <= lim["limit"])
        ok = ok and good
        rows.append([name, v, lim["limit"]])
    return ok, rows
