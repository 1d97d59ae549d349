"""PyTorch port: the reference-style examples run end to end on CPU.

Each ported example's ``main`` runs once with ``--device cpu`` at a tiny
size, writing its VTK output under a temporary directory: ``block_3d``,
``heat_conduction``, ``helmholtz_filter`` (the filter keeps the field's
integral), ``nonlinear_poisson_ex``, ``quad_tri``, ``element_plot``
(the consistent mass sums to the quadrature's integral of 1), ``topo``
(``--solver gmg``, 3 MMA iterations: the structured filter and V-cycle
on their kernels' plain versions) and ``performance_study --kernel
cuda`` (kernel K8's plain version).  chip_smoke.py phase 12 runs them on
the card at their default sizes.
"""

import importlib
import os

import numpy as np
import pytest

import torch_threads  # noqa: F401  (one torch thread per worker)

CASES = {
    "block_3d": (["--nx", "5", "--ny", "3", "--nz", "3"], "--vtk",
                 "block.vtk"),
    "heat_conduction": (["--nx", "9", "--ny", "9"], "--vtk", "heat.vtk"),
    "helmholtz_filter": (["--n", "9"], "--vtk", "helmholtz.vtk"),
    "nonlinear_poisson_ex": (["--n", "9"], "--vtk", "nonlinear.vtk"),
    "quad_tri": (["--n", "9"], "--out-dir", "poisson_quad.vtk"),
    "element_plot": ([], "--out-dir", "c3d20.vtk"),
    "topo": (["--solver", "gmg", "--nx", "17", "--ny", "9",
              "--max_iterations", "3"], "--prefix", "result.vtk"),
    "performance_study": (["--sizes", "3", "--kernel", "cuda",
                           "--repeats", "1"], None, None),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_cpu(name, tmp_path, capsys):
    argv, out_flag, out_file = CASES[name]
    if out_flag == "--vtk":
        argv = argv + [out_flag, str(tmp_path / out_file)]
    elif out_flag is not None:
        argv = argv + [out_flag, str(tmp_path)]
    mod = importlib.import_module(
        f"pyfem_gpu_testflight_tpu_torch.examples.{name}")
    out = mod.main(argv + ["--device", "cpu"])
    if out_file is not None:
        assert os.path.getsize(tmp_path / out_file) > 0
    if name == "helmholtz_filter":
        assert out < 1e-8
    elif name == "element_plot":
        np.testing.assert_allclose([out["tet10"], out["brick20"]], [6.0, 1.0],
                                   rtol=1e-12)
    elif name == "topo":
        assert 0.0 < out < 1.0
    elif name == "performance_study":
        assert len(out) == 3 and all(r["t_ke_s"] > 0 for r in out)
        assert "host clock" in capsys.readouterr().out
    elif name == "quad_tri":
        assert all(np.isfinite(u).all() for u in out.values())
    else:
        assert np.isfinite(out).all() and np.abs(out).max() > 0
