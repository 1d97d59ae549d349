"""Build, bind and count the package's hand-written CUDA kernels.

The sources in ``csrc/*.cu`` expose plain C entry points; at first use
``nvcc`` compiles each of them for Hopper (``sm_90a``) into an object,
all in parallel, and links the objects into one shared library, keyed
by a hash of the sources and flags, which is loaded with ``ctypes``.
The library lands in ``build/pyfem_torch_kernels/`` at the root of the
checkout; ptxas's register and spill report of the build is kept beside
it and in :data:`build_log` (also when another process built it).
Nothing is built or loaded at import: the CPU tests import every module
on machines without ``nvcc``.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises on a nonzero code and
counts the call in :data:`launches`, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

__all__ = ["library", "launch", "launches", "reset_launches", "stream_ptr",
           "build_log"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("assemble_2d.cu", "smooth_2d.cu", "assemble_3d.cu",
            "smooth_3d.cu", "otf_3d.cu", "stiffness_2d.cu",
            "stiffness_3d.cu", "stencil_2d.cu", "spmv.cu")
_BUILD_DIR = (
    Path(__file__).resolve().parent.parent.parent
    / "build" / "pyfem_torch_kernels"
)
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FP = ctypes.POINTER(ctypes.c_float)  # a host float array
# C entry point -> argtypes (pointers and the stream as c_void_p: a
# bare Python int would be passed as a 32-bit int and cut the pointer)
_SIGNATURES = {
    # rho, maskf, table (HOST memory), table floats, p, nd, ny, nx, coeff,
    # invd, coeff_lp, stream
    "pyfem_assemble_2d": (_P, _P, _P, _I, _F, _I, _I, _I, _P, _P, _P, _P),
    # the same, half-symmetric storage (kept planes of sym_planes_2d)
    "pyfem_assemble_2d_sym": (_P, _P, _P, _I, _F, _I, _I, _I, _P, _P, _P,
                              _P),
    # coeff, coeff_bf16, invd, b, x, out, nd, ny, nx, omega, mode, stream
    "pyfem_smooth_2d": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    "pyfem_smooth_2d_sym": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # coeff, coeff_bf16, invd, b, x0, xout, rout, omegas (HOST memory),
    # nsweeps, first_elem, rmode, g, tile_y, tile_x, nd, ny, nx, stream
    "pyfem_sweeps_2d": (_P, _I, _P, _P, _P, _P, _P, _FP, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _P),
    # coeff, u, out, nd, ny, nx, f64, stream
    "pyfem_stencil_2d": (_P, _P, _P, _I, _I, _I, _I, _P),
    # rho, maskf, table, table floats, p, nd, nz, ny, nx, full, coeff,
    # invd, coeff_lp, stream
    "pyfem_assemble_3d": (_P, _P, _P, _I, _F, _I, _I, _I, _I, _I, _P, _P,
                          _P, _P),
    # coeff, coeff_bf16, full, invd, b, x, out, nd, nz, ny, nx, omega,
    # mode, stream
    "pyfem_sweep_3d": (_P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                       _P),
    # coeff, coeff_bf16, full, invd, b, x0, buf0, buf1, r, omegas, niter,
    # rmode, nd, nz, ny, nx, stream
    "pyfem_sweeps_3d": (_P, _I, _I, _P, _P, _P, _P, _P, _P, _FP, _I, _I, _I,
                        _I, _I, _I, _P),
    # rho, maskf, tables (w3 | wd | N), b, x, out, p, nd, nz, ny, nx,
    # omega, mode, stream
    "pyfem_otf_3d": (_P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _F, _I, _P),
    # rho, maskf, w3t (bf16), tab (wd | N), b, x, out, p, nd, nz, ny, nx,
    # omega, mode, stream
    "pyfem_otf_3d_tc": (_P, _P, _P, _P, _P, _P, _P, _F, _I, _I, _I, _I, _F,
                        _I, _P),
    # XeT, cq, mu, lam, nelems, KeT, stream
    "pyfem_elasticity_quad4": (_P, _P, _F, _F, _I, _P, _P),
    # XeT, kq, nelems, KeT, stream
    "pyfem_poisson_quad4": (_P, _P, _I, _P, _P),
    # XeT, cq, table, mu, lam, elastic, nn, nelems, KeT, stream
    "pyfem_stiffness_3d": (_P, _P, _P, _F, _F, _I, _I, _I, _P, _P),
    # indptr, indices, vals, x, y, n, group, f64, stream
    "pyfem_csr_spmv": (_P, _P, _P, _P, _P, _I, _I, _I, _P),
    # offsets, noffs, dia, u, mask (or None), y, n, f64, stream
    "pyfem_dia_spmv": (_P, _I, _P, _P, _P, _P, _I, _I, _P),
}

launches = {name: 0 for name in _SIGNATURES}
_lib = None
build_log = ""  # nvcc/ptxas output of the last build in this process


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels are "
        "built from csrc/ at first use"
    )


def _build(so):
    """Compile every source at once (one nvcc each), link into ``so``."""
    global build_log
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=_BUILD_DIR))
    try:
        objs = [tmp / f"{n}.o" for n in _SOURCES]
        cmds = [[_nvcc(), *_NVCC_FLAGS, "-c", "-o", str(o), str(_CSRC / n)]
                for n, o in zip(_SOURCES, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        logs = [proc.communicate()[0] for proc in procs]  # waits for all
        for cmd, proc, out in zip(cmds, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                                   f"{' '.join(cmd)}\n{out}")
        lib = tmp / "lib.so"
        cmd = [_nvcc(), *_ARCH, "-shared", "-o", str(lib),
               *(str(o) for o in objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}"
                               f"{proc.stderr}")
        build_log = "".join(logs)
        so.with_suffix(".log").write_text(build_log)
        os.replace(lib, so)  # atomic: concurrent builders never see half
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def library():
    """The loaded kernel library, built on first call."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    so = _BUILD_DIR / f"libpyfem_torch_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _build(so)
    elif not build_log and so.with_suffix(".log").exists():
        build_log = so.with_suffix(".log").read_text()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.pyfem_cuda_error_string.argtypes = (ctypes.c_int,)
    lib.pyfem_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def stream_ptr(t):
    """The current CUDA stream of tensor ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name, *args):
    """Call C entry point ``name``; raise on a launch error, count it."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        msg = lib.pyfem_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
    launches[name] += 1


def reset_launches():
    for name in launches:
        launches[name] = 0
