"""Build, bind and count the package's hand-written CUDA kernels.

The sources in ``csrc/*.cu`` expose plain C entry points; they are
compiled by ``nvcc`` for Hopper (``sm_90a``) into one shared library at
first use, keyed by a hash of the sources and flags, and loaded with
``ctypes``.  The library lands in ``build/pyfem_torch_kernels/`` at the
root of the checkout.  Nothing is built or loaded at import: the CPU
tests import every module on machines without ``nvcc``.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` raises on a nonzero code and
counts the launch in :data:`launches`, so a run can show that its main
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

__all__ = ["library", "launch", "launches", "reset_launches", "stream_ptr"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCES = ("assemble_2d.cu", "smooth_2d.cu")
_BUILD_DIR = (
    Path(__file__).resolve().parent.parent.parent
    / "build" / "pyfem_torch_kernels"
)
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argtypes (pointers and the stream as c_void_p: a
# bare Python int would be passed as a 32-bit int and cut the pointer)
_SIGNATURES = {
    # rho, maskf, W, N, p, nd, ny, nx, coeff, invd, coeff_lp, stream
    "pyfem_assemble_2d": (_P, _P, _P, _P, _F, _I, _I, _I, _P, _P, _P, _P),
    # coeff, coeff_bf16, invd, b, x, out, nd, ny, nx, omega, mode, stream
    "pyfem_smooth_2d": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
}

launches = {name: 0 for name in _SIGNATURES}
_lib = None


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


def library():
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is not None:
        return _lib
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for name in _SOURCES:
        h.update((_CSRC / name).read_bytes())
    so = _BUILD_DIR / f"libpyfem_torch_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp,
               *(str(_CSRC / n) for n in _SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, so)  # atomic: concurrent builders never see half
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
