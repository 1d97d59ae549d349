"""PyTorch port, the native host-setup helpers (``native``).

The port's own loader of ``native/fastsetup.cpp`` (built with g++ and
the Makefile's flags into ``build/native/``, never into ``native/``)
against NumPy and against the JAX package's ``native`` module on the
same seeded inputs: ``expand_pattern``, ``unique_inverse`` (sorted and
row-bucketed) and ``greedy_aggregate`` (against the Python loop of
``unstructured._greedy_aggregate``); the NumPy fallback gives the same
results; and ``assembly.SparsityPattern`` on the native route against
scipy's COO de-duplication and the JAX pattern.
"""

from pathlib import Path

import numpy as np
import pytest

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu import native as jax_native
from pyfem_gpu_testflight_tpu.assembly import SparsityPattern as JaxPattern

from pyfem_gpu_testflight_tpu_torch import native, unstructured
from pyfem_gpu_testflight_tpu_torch.assembly import (
    SparsityPattern, make_conn_dof,
)

import torch_threads  # noqa: F401  (one torch thread per worker)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def numpy_only(monkeypatch):
    """The port's native module with no library (the NumPy fallback)."""
    monkeypatch.setattr(native, "get_lib", lambda: None)


def test_library_builds_into_build_dir():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("no C++ compiler on this host (NumPy fallback)")
    path = Path(lib._name).resolve()
    assert path.parent == ROOT / "build" / "native"
    assert path.name.startswith("libfastsetup_")


def test_expand_pattern_matches_numpy_and_jax():
    rng = np.random.default_rng(0)
    cd = rng.integers(0, 99, size=(500, 8)).astype(np.int64)
    r1, c1 = native.expand_pattern(cd)
    np.testing.assert_array_equal(r1, np.repeat(cd, 8, axis=1).ravel())
    np.testing.assert_array_equal(c1, np.tile(cd, (1, 8)).ravel())
    r2, c2 = jax_native.expand_pattern(cd)
    np.testing.assert_array_equal(r1, r2)
    np.testing.assert_array_equal(c1, c2)


@pytest.mark.parametrize("bucketed", [False, True])
def test_unique_inverse_matches_numpy_and_jax(bucketed):
    rng = np.random.default_rng(1 + bucketed)
    nrows = 300
    rows = rng.integers(0, nrows, size=100000).astype(np.int64)
    keys = rows * nrows + rng.integers(0, nrows, size=100000)
    kw = dict(rows=rows, nrows=nrows) if bucketed else {}
    u1, i1 = native.unique_inverse(keys, **kw)
    u2, i2 = np.unique(keys, return_inverse=True)
    np.testing.assert_array_equal(u1, u2)
    np.testing.assert_array_equal(i1, i2.astype(np.int32))
    assert i1.dtype == np.int32
    u3, i3 = jax_native.unique_inverse(keys, **kw)
    np.testing.assert_array_equal(u1, u3)
    np.testing.assert_array_equal(i1, i3)


def _graph(seed, n=400):
    from scipy import sparse

    rng = np.random.default_rng(seed)
    A = sparse.random(n, n, density=8.0 / n, random_state=seed,
                      format="csr")
    A = (A + A.T + sparse.eye(n)).tocsr()
    A.data[:] = rng.standard_normal(A.nnz)
    return A


def test_greedy_aggregate_matches_python_loop_and_jax(monkeypatch):
    A = _graph(3)
    agg, n_agg = native.greedy_aggregate(A.indptr, A.indices, A.shape[0])
    agg_j, n_agg_j = jax_native.greedy_aggregate(A.indptr, A.indices,
                                                 A.shape[0])
    np.testing.assert_array_equal(agg, agg_j)
    assert n_agg == n_agg_j
    monkeypatch.setattr(native, "get_lib", lambda: None)
    assert native.greedy_aggregate(A.indptr, A.indices, A.shape[0]) is None
    agg_py, n_py = unstructured._greedy_aggregate(A)
    np.testing.assert_array_equal(agg, agg_py)
    assert n_agg == n_py and agg.dtype == agg_py.dtype == np.int64


def test_numpy_fallback_matches_native(numpy_only):
    rng = np.random.default_rng(4)
    cd = rng.integers(0, 50, size=(60, 6)).astype(np.int64)
    r, c = native.expand_pattern(cd)
    u, i = native.unique_inverse(r * 50 + c, rows=r, nrows=50)
    u2, i2 = jax_native.unique_inverse(r * 50 + c, rows=r, nrows=50)
    np.testing.assert_array_equal(u, u2)
    np.testing.assert_array_equal(i, i2)


@pytest.mark.parametrize("element_type", ["quad", "tet"])
def test_sparsity_pattern_native_matches_scipy_and_jax(element_type):
    from scipy import sparse

    if element_type == "quad":
        creator = fem.ProblemCreator(nnodes_x=9, nnodes_y=7)
    else:
        creator = fem.ProblemCreator(5, 3, 3, element_type="tet")
    conn, X, _fixed, _force = creator.create_linear_elasticity_problem()
    nd = X.shape[1]
    cd = make_conn_dof(np.asarray(conn), nd)
    ndof = nd * X.shape[0]
    pat = SparsityPattern(cd, ndof)
    ii = np.repeat(cd, cd.shape[1], axis=1).ravel()
    jj = np.tile(cd, (1, cd.shape[1])).ravel()
    K = sparse.coo_matrix((np.ones(ii.shape[0]), (ii, jj)),
                          shape=(ndof, ndof)).tocsr()
    K.sum_duplicates()
    assert pat.nnz == K.nnz
    np.testing.assert_array_equal(pat.indptr, K.indptr)
    np.testing.assert_array_equal(pat.cols, K.indices)
    jp = JaxPattern(cd, ndof)
    np.testing.assert_array_equal(pat.seg_ids, np.asarray(jp.seg_ids))
    np.testing.assert_array_equal(pat.diag_pos, jp.diag_pos)
    np.testing.assert_array_equal(pat.indptr, jp.indptr)
