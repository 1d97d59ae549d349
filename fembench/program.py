"""The program under test, built from a configuration file through its
public entries only: ``ProblemCreator``, ``LinearElasticity``,
``attach_structured_grid``, ``solve``, ``Helmholtz`` and
``opt.DeviceTopo``.  This is the one module of the benchmark that imports
the program (``pyfem_gpu_testflight_tpu_torch``): the builders here are
the structured cantilever's, which the entries ``solves`` and ``topo``
share; an entry of another kind builds its model from ``package()``.
"""

from __future__ import annotations

import torch

DTYPES = {"float32": torch.float32, "float64": torch.float64,
          "bfloat16": torch.bfloat16}
ELEMENTS = {"quad4": "quad", "hex8": "block"}


def package():
    import pyfem_gpu_testflight_tpu_torch as pt

    return pt


def gmg_options(cfg):
    """``attach_structured_grid`` keyword arguments of a configuration."""
    opts = dict(cfg["gmg"])
    if "smoother_dtype" in opts:
        opts["smoother_dtype"] = DTYPES[opts["smoother_dtype"]]
    return opts


def build_model(cfg, device):
    """(model, mesh) of a structured cantilever configuration: the
    problem factory's clamped face and tip load, the GMG path attached."""
    pt = package()
    dims = cfg["grid"]
    creator = pt.ProblemCreator(*dims, element_type=ELEMENTS[cfg["element"]])
    conn, X, fixed, force = creator.create_linear_elasticity_problem()
    ph = cfg["physics"]
    model = pt.LinearElasticity(cfg["element"], X, conn, fixed, None, force,
                                E=ph["E"], nu=ph["nu"], p=ph["p"],
                                dtype=DTYPES[cfg["dtype"]], device=device)
    model.attach_structured_grid(*dims, **gmg_options(cfg))
    return model, (conn, X)


def solver(model, cfg):
    """The timed entry of a solve mix: rho -> u (device tensor)."""
    s = cfg["solve"]

    def solve(rho):
        return model.solve(method=s["method"], rho=rho, rtol=s["rtol"],
                           maxiter=s["maxiter"])

    return solve


def last_iters(model):
    """PCG iterations of the model's last solve (its public counter)."""
    return int(model.last_solve_stats["iters"])


def build_topo(cfg, device):
    """(DeviceTopo, model) of a configuration with a filter and an
    optimizer section."""
    pt = package()
    model, (conn, X) = build_model(cfg, device)
    f = cfg["filter"]
    filtr = pt.Helmholtz(f["r0"], cfg["element"], X, conn,
                         dtype=DTYPES[cfg["dtype"]], rtol=f["rtol"],
                         device=device).attach_structured_grid(*cfg["grid"])
    t = cfg["topo"]
    dt = pt.opt.DeviceTopo(model, filtr, fixed_volume=t["fixed_volume"],
                           x_init=t["x_init"], lb=t["lb"], ub=t["ub"],
                           rtol=t["rtol"], maxiter=t["maxiter"])
    return dt, model

