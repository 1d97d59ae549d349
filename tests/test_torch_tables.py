"""PyTorch port: imports, precision pin and host tables vs the JAX package.

Gates (CPU, small grids):
* the port imports without jax;
* importing it pins float32 (TF32 off);
* element tables and ProblemCreator outputs are bit-equal;
* RAMP and its derivative, and ``DirichletBC`` (mask, values,
  ``constrain_rhs``, ``zero_fixed``, ``apply_scipy``) equal the JAX
  package's;
* the per-level unit matrices Kq and K1 weights W of the port's
  GMGAssembler match the JAX GMGAssembler's (1e-14 relative in float64,
  exactly in float32), and ``convert.assembler_state_from_numpy``
  installs the JAX tables unchanged.
"""

import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu import bcs as jbcs
from pyfem_gpu_testflight_tpu import multigrid as jmg
from pyfem_gpu_testflight_tpu.models import base as jbase
from pyfem_gpu_testflight_tpu.ops import pallas_assemble as pa

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import bcs as tbcs
from pyfem_gpu_testflight_tpu_torch import convert, mesh as tmesh
from pyfem_gpu_testflight_tpu_torch import multigrid as tmg
from pyfem_gpu_testflight_tpu_torch.models import base as tbase

import torch_threads  # noqa: F401  (one torch thread per worker)

# the port's entry points default to the CUDA card; these tests run on CPU
DEV = "cpu"

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DTYPES = {"float64": (torch.float64, jnp.float64),
           "float32": (torch.float32, jnp.float32)}


def test_port_imports_without_jax():
    # every module of the port, and chip_smoke.py as a module, import
    # with jax and the JAX package made unimportable
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['pyfem_gpu_testflight_tpu'] = None\n"
        "import pyfem_gpu_testflight_tpu_torch as pt\n"
        "names = [m.name for m in pkgutil.walk_packages(pt.__path__,"
        " 'pyfem_gpu_testflight_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert 'pyfem_gpu_testflight_tpu_torch.multigrid' in names\n"
        "assert 'pyfem_gpu_testflight_tpu_torch.device' in names\n"
        "import chip_smoke\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and"
        " (m == 'jax' or m.startswith('jax.')"
        " or m.startswith('pyfem_gpu_testflight_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_precision_pin():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("name", ["quad4", "tri3", "hex8", "tet10",
                                  "brick20"])
def test_element_tables_bit_equal(name):
    a, b = fem.get_element(name), pt.get_element(name)
    assert (a.name, a.ndims, a.nnodes) == (b.name, b.ndims, b.nnodes)
    for f in ("quad_pts", "quad_wts", "shape_vals", "shape_grads",
              "node_coords"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f


@pytest.mark.parametrize("args", [
    (17, 9, None, "quad"), (9, 5, None, "tri"), (5, 4, 3, "block"),
    (5, 5, 5, "tet"), (5, 5, 5, "brick20"),
])
def test_problem_creator_bit_equal(args):
    nx, ny, nz, et = args
    a = fem.ProblemCreator(nx, ny, nz, element_type=et)
    b = pt.ProblemCreator(nx, ny, nz, element_type=et)
    assert np.array_equal(a.conn, b.conn) and a.conn.dtype == b.conn.dtype
    assert np.array_equal(a.X, b.X)
    fa = a.create_linear_elasticity_problem()
    fb = b.create_linear_elasticity_problem()
    assert np.array_equal(fa[2], fb[2]) and fa[3] == fb[3]
    assert np.array_equal(a.create_poisson_problem()[2],
                          b.create_poisson_problem()[2])
    conn, X = tmesh.structured_mesh(nx, ny, nz, element_type=et)
    assert np.array_equal(conn, a.conn) and np.array_equal(X, a.X)


def test_ramp_matches_jax():
    rho = np.random.default_rng(5).uniform(0.0, 1.0, 64)
    for p in (0.0, 3.0, 8.0):
        for jf, tf in ((jbase.ramp, tbase.ramp),
                       (jbase.ramp_deriv, tbase.ramp_deriv)):
            ref = np.asarray(jf(jnp.asarray(rho), p))
            got = tf(torch.as_tensor(rho), p).numpy()
            assert np.abs(got - ref).max() <= 1e-15 * np.abs(ref).max()


@pytest.mark.parametrize("with_vals", [False, True])
def test_dirichlet_bc_matches_jax(with_vals):
    import scipy.sparse as sp

    n = 40
    rng = np.random.default_rng(6)
    fixed = np.array([7, 3, 3, 20, 39])  # unsorted, with a repeat
    vals = rng.standard_normal(fixed.size) if with_vals else None
    if with_vals:
        vals[2] = vals[1]  # a repeated dof keeps one value
    jbc = jbcs.DirichletBC(fixed, vals, n)
    tbc = tbcs.DirichletBC(fixed, vals, n, device=DEV)
    assert tbc.nfixed == jbc.nfixed == 4
    assert np.array_equal(tbc.mask.numpy(), np.asarray(jbc.mask))
    assert np.array_equal(tbc.values.numpy(), np.asarray(jbc.values))

    A = rng.standard_normal((n, n))
    A = A + A.T
    rhs, u = rng.standard_normal(n), rng.standard_normal(n)
    got = tbc.constrain_rhs(torch.as_tensor(rhs),
                            lambda v: torch.as_tensor(A) @ v).numpy()
    ref = np.asarray(jbc.constrain_rhs(jnp.asarray(rhs),
                                       lambda v: jnp.asarray(A) @ v))
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()
    assert np.array_equal(tbc.zero_fixed(torch.as_tensor(u)).numpy(),
                          np.asarray(jbc.zero_fixed(jnp.asarray(u))))

    K = sp.csr_matrix(A + n * np.eye(n))
    for sym in (True, False):
        Kt, bt = tbc.apply_scipy(K, rhs, enforce_symmetric_K=sym)
        Kj, bj = jbc.apply_scipy(K, rhs, enforce_symmetric_K=sym)
        assert np.array_equal(Kt.toarray(), Kj.toarray())
        assert np.array_equal(bt, bj)


def _assemblers(physics, dtype, nx=65, ny=33):
    tdt, jdt = _DTYPES[dtype]
    ja = jmg.GMGAssembler(nx, ny, 2.0, 1.0, physics, p=3.0, dtype=jdt)
    ta = tmg.GMGAssembler(nx, ny, 2.0, 1.0, physics, p=3.0, dtype=tdt,
                          device=DEV)
    return ja, ta


def _jax_tables(ja):
    """Per level (Kq, W, mask) of a JAX GMGAssembler as numpy."""
    out = []
    for (op, _xe, _conn, mask, _shape, Kq, _pal) in ja.static_levels:
        Kq = np.asarray(Kq)
        W = pa.assembly_weights(op.plan, Kq, ja.nd, Kq.shape[0])
        out.append((Kq, W.astype(Kq.dtype), np.asarray(mask)))
    return out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
def test_unit_matrices_and_weights_match(physics, dtype):
    ja, ta = _assemblers(physics, dtype)
    assert ta.sizes == ja.sizes
    jt = _jax_tables(ja)
    assert len(jt) == len(ta.static_levels) == 4
    for (Kq, W, mask), st in zip(jt, ta.static_levels):
        for ref, got in ((Kq, st.Kq), (W, st.W)):
            got = got.numpy()
            assert got.dtype == ref.dtype
            if dtype == "float32":
                assert np.array_equal(got, ref)
            else:
                assert np.abs(got - ref).max() <= 1e-14 * np.abs(ref).max()
        assert np.array_equal(st.mask.numpy(), mask)
        assert np.array_equal(st.maskf.numpy(), (~mask).astype(Kq.dtype))


def test_convert_installs_jax_tables():
    ja, ta = _assemblers("elasticity", "float32")
    jt = _jax_tables(ja)
    own = [(st.Kq.clone(), st.W.clone()) for st in ta.static_levels]
    convert.assembler_state_from_numpy(
        ta, [t[0] for t in jt], [t[2] for t in jt], W=[t[1] for t in jt]
    )
    for (Kq, W, mask), st, (oKq, oW) in zip(jt, ta.static_levels, own):
        assert np.array_equal(st.Kq.numpy(), Kq)
        assert np.array_equal(st.W.numpy(), W)
        assert np.array_equal(st.mask.numpy(), mask)
        # the port's own setup already produced the same tables
        assert torch.equal(st.Kq, oKq) and torch.equal(st.W, oW)
    with pytest.raises(ValueError):
        convert.assembler_state_from_numpy(ta, [jt[0][0]], [jt[0][2]])
