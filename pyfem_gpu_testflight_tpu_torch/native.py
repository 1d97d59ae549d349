"""ctypes loader for the native host-setup library (``native/fastsetup.cpp``).

Port of ``pyfem_gpu_testflight_tpu/native.py``.  The C++ library speeds
up host-side mesh setup — the sparsity-pattern sort/unique over tens of
millions of keys (``assembly.SparsityPattern``) and the greedy
aggregation of the AMG set-up (``unstructured``) — with OpenMP.  At
first use it is compiled with g++ and the flags of ``native/Makefile``
into ``build/native/`` at the root of the checkout (never into
``native/``), under a name keyed by the source, the flags and the host's
CPU model (``-march=native`` code runs only where it was built).  Every
entry point keeps the JAX module's NumPy fallback, with identical
results, for a host without a compiler.  Host set-up only: no device
work.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

__all__ = ["get_lib", "unique_inverse", "expand_pattern", "greedy_aggregate"]

_ROOT = Path(__file__).resolve().parent.parent
_SOURCE = _ROOT / "native" / "fastsetup.cpp"
_BUILD_DIR = _ROOT / "build" / "native"
# native/Makefile's CXXFLAGS
_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-fopenmp",
          "-std=c++17")
_lib = None
_tried = False


def _cpu_model():
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return ""


def _lib_path():
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SOURCE.read_bytes())
    h.update(_cpu_model().encode())
    return _BUILD_DIR / f"libfastsetup_{h.hexdigest()[:16]}.so"


def _build(so):
    """g++ into a temporary file beside ``so``, then an atomic rename, so
    that concurrent builds (test workers) never load half a library."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        return False
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=_BUILD_DIR, suffix=".so")
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *_FLAGS, "-o", tmp, str(_SOURCE)],
                              capture_output=True, timeout=120)
        if proc.returncode != 0:
            return False
        os.replace(tmp, so)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(path):
    lib = ctypes.CDLL(str(path))
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.unique_inverse_i64.restype = ctypes.c_int64
    lib.unique_inverse_i64.argtypes = [i64p, ctypes.c_int64, i64p, i32p]
    lib.greedy_aggregate_csr.restype = ctypes.c_int64
    lib.greedy_aggregate_csr.argtypes = [i64p, i64p, ctypes.c_int64, i64p]
    lib.unique_inverse_i64_keys.restype = ctypes.c_int64
    lib.unique_inverse_i64_keys.argtypes = [
        i64p, ctypes.c_int64, ctypes.c_int64, i64p, i64p, i32p]
    lib.expand_pattern_i64.restype = None
    lib.expand_pattern_i64.argtypes = [i64p, ctypes.c_int64, ctypes.c_int64,
                                       i64p, i64p]
    return lib


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _SOURCE.exists():
        return None
    so = _lib_path()
    if not so.exists() and not _build(so):
        return None
    try:
        _lib = _bind(so)
    except OSError:
        _lib = None
    return _lib


def _ptr_i64(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _ptr_i32(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def unique_inverse(keys: np.ndarray, rows=None, nrows=None):
    """np.unique(keys, return_inverse=True), native when available.

    When ``rows``/``nrows`` are given (FEM pattern keys = row*N + col),
    the native path uses a linear-time row-bucketed algorithm instead of
    a global sort.
    """
    keys = np.ascontiguousarray(keys, dtype=np.int64)
    lib = get_lib()
    if lib is None:
        uniq, inv = np.unique(keys, return_inverse=True)
        return uniq, inv.astype(np.int32)
    n = keys.shape[0]
    uniq = np.empty(n, dtype=np.int64)
    inv = np.empty(n, dtype=np.int32)
    if rows is not None:
        rows = np.ascontiguousarray(rows, dtype=np.int64)
        n_unique = lib.unique_inverse_i64_keys(
            _ptr_i64(keys), n, int(nrows), _ptr_i64(rows), _ptr_i64(uniq),
            _ptr_i32(inv),
        )
    else:
        n_unique = lib.unique_inverse_i64(_ptr_i64(keys), n, _ptr_i64(uniq),
                                          _ptr_i32(inv))
    if n_unique < 0:
        raise RuntimeError("native unique_inverse failed")
    return uniq[:n_unique].copy(), inv


def expand_pattern(conn_dof: np.ndarray):
    """(rows, cols) int64 arrays of all element-matrix index pairs."""
    conn_dof = np.ascontiguousarray(conn_dof, dtype=np.int64)
    nelems, ndpe = conn_dof.shape
    lib = get_lib()
    if lib is None:
        rows = np.repeat(conn_dof, ndpe, axis=1).ravel()
        cols = np.tile(conn_dof, (1, ndpe)).ravel()
        return rows, cols
    rows = np.empty(nelems * ndpe * ndpe, dtype=np.int64)
    cols = np.empty(nelems * ndpe * ndpe, dtype=np.int64)
    lib.expand_pattern_i64(_ptr_i64(conn_dof), nelems, ndpe,
                           _ptr_i64(rows), _ptr_i64(cols))
    return rows, cols


def greedy_aggregate(indptr: np.ndarray, indices: np.ndarray, n: int):
    """Greedy BFS graph aggregation (AMG setup); native when available.

    Returns:
        (agg, n_agg) with agg int64 of shape (n,), or None without the
        library (the caller runs its Python loop).
    """
    lib = get_lib()
    if lib is None:
        return None
    indptr = np.ascontiguousarray(indptr, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.int64)
    agg = np.empty(int(n), dtype=np.int64)
    n_agg = lib.greedy_aggregate_csr(_ptr_i64(indptr), _ptr_i64(indices),
                                     int(n), _ptr_i64(agg))
    return agg, int(n_agg)
