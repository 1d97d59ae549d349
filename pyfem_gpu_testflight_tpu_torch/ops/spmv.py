"""U1 (CSR) and U2 (DIA) sparse matrix-vector products.

Neither replaces a TPU kernel: in the JAX package the AMG levels and the
fine operator of ``unstructured.amg_pcg`` are DIA operators whose matvec
is a Python loop over the diagonals that XLA fuses into one loop
(``ops/dia.py`` ``DiaOperator.matvec``).  In eager PyTorch that loop is
a launch or more per diagonal, and on an RCM-ordered unstructured mesh
the band's diagonals are almost empty, so the port keeps the AMG levels
as CSR (``unstructured``) and multiplies with U1; U2 is
``DiaOperator.matvec`` / ``bc_matvec`` (``ops.dia``).

* :func:`csr_matvec` — ``y = A x`` for a CSR matrix with int32
  ``indptr`` / ``indices`` and float32 or float64 values, a group of
  lanes per row (``csrc/spmv.cu`` ``pyfem_csr_spmv``).
* :func:`dia_matvec` — ``y[i] = sum_k dia[k, i] * u[i + offsets[k]]``
  (entries of u outside [0, n) read as 0), with an optional Dirichlet
  mask: fixed entries of u read as 0 and ``y = u`` there
  (``pyfem_dia_spmv``).

A CPU tensor takes the plain PyTorch version (``*_plain``, same
signature); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import _cuda

__all__ = ["csr_matvec", "csr_matvec_plain", "csr_group", "dia_matvec",
           "dia_matvec_plain"]

_FLOATS = (torch.float32, torch.float64)
_INT_MAX = 2**31 - 1


def csr_group(n, nnz):
    """Lanes per row of U1: the power of two from 1 to 32 at or above an
    eighth of the mean row length, so that each lane takes about eight
    entries of its row.  Measured on an H100 (all six groups timed in
    ``chip_smoke.py`` phase 11): the torque arm's fine level (14 entries
    a row) runs fastest at 2 lanes, the C3D10 bracket's (81) at 16."""
    mean = nnz / max(n, 1)
    g = 1
    while g < 32 and 8 * g < mean:
        g *= 2
    return g


def _check_csr(indptr, indices, vals, x):
    n = x.shape[0]
    if x.dim() != 1 or indptr.shape != (n + 1,):
        raise ValueError(f"indptr {tuple(indptr.shape)} does not match x "
                         f"{tuple(x.shape)} (a square matrix)")
    if indices.shape != vals.shape or indices.dim() != 1:
        raise ValueError(f"indices {tuple(indices.shape)} and values "
                         f"{tuple(vals.shape)} must be one (nnz,) each")
    if vals.dtype != x.dtype or vals.dtype not in _FLOATS:
        raise TypeError(f"values and x must share float32 or float64, got "
                        f"{vals.dtype} and {x.dtype}")
    if indptr.dtype != torch.int32 or indices.dtype != torch.int32:
        raise TypeError("indptr and indices must be int32")
    if len({t.device for t in (indptr, indices, vals, x)}) != 1:
        raise ValueError("all operands must be on one device")
    return n


def csr_matvec_plain(indptr, indices, vals, x):
    """Plain PyTorch U1: products gathered by column, summed per row by a
    segment sum in row order."""
    _check_csr(indptr, indices, vals, x)
    prod = vals * x[indices.long()]
    return torch.segment_reduce(prod, "sum", offsets=indptr.long(),
                                unsafe=True)


def _csr_matvec_cuda(indptr, indices, vals, x):
    n = _check_csr(indptr, indices, vals, x)
    if vals.numel() > _INT_MAX or n >= _INT_MAX:
        raise ValueError("the CUDA kernel takes int32 sizes")
    if not all(t.is_contiguous() for t in (indptr, indices, vals, x)):
        raise ValueError("operands must be contiguous")
    y = torch.empty_like(x)
    _cuda.launch("pyfem_csr_spmv", indptr.data_ptr(), indices.data_ptr(),
                 vals.data_ptr(), x.data_ptr(), y.data_ptr(), n,
                 csr_group(n, vals.numel()), int(x.dtype == torch.float64),
                 _cuda.stream_ptr(x))
    return y


def csr_matvec(indptr, indices, vals, x):
    """y = A x for the CSR matrix (indptr, indices, vals), square.

    Args:
        indptr: (n+1,) int32 row starts; indices: (nnz,) int32 columns.
        vals: (nnz,) float32 or float64, x's dtype.
        x: (n,).

    Returns:
        (n,) in x's dtype; each row summed in a fixed order (the same
        on every run).
    """
    if x.device.type == "cuda":
        return _csr_matvec_cuda(indptr, indices, vals, x)
    if x.device.type == "cpu":
        return csr_matvec_plain(indptr, indices, vals, x)
    raise ValueError(f"unsupported device {x.device}")


def _check_dia(offsets, dia, u, mask):
    n = u.shape[0]
    if u.dim() != 1 or dia.dim() != 2 or dia.shape[1] != n:
        raise ValueError(f"dia {tuple(dia.shape)} must be (noffs, "
                         f"{n}) for u {tuple(u.shape)}")
    if offsets.shape != (dia.shape[0],) or offsets.dtype != torch.int32:
        raise ValueError(f"offsets must be ({dia.shape[0]},) int32, got "
                         f"{tuple(offsets.shape)} {offsets.dtype}")
    if dia.dtype != u.dtype or u.dtype not in _FLOATS:
        raise TypeError(f"dia and u must share float32 or float64, got "
                        f"{dia.dtype} and {u.dtype}")
    if mask is not None and (mask.shape != u.shape
                             or mask.dtype != torch.bool):
        raise ValueError("mask must be a bool tensor shaped like u")
    devs = {t.device for t in (offsets, dia, u, mask) if t is not None}
    if len(devs) != 1:
        raise ValueError("all operands must be on one device")
    return n


def dia_matvec_plain(offsets, dia, u, mask=None):
    """Plain PyTorch U2: one shifted multiply-add per diagonal, in the
    order of ``offsets`` (the JAX ``DiaOperator`` matvec's loop)."""
    n = _check_dia(offsets, dia, u, mask)
    uz = u if mask is None else torch.where(mask, 0.0, u)
    acc = torch.zeros_like(u)
    for k, off in enumerate(offsets.tolist()):
        lo, hi = max(0, -off), min(n, n - off)
        if hi > lo:
            acc[lo:hi] += dia[k, lo:hi] * uz[lo + off:hi + off]
    return acc if mask is None else torch.where(mask, u, acc)


def _dia_matvec_cuda(offsets, dia, u, mask):
    n = _check_dia(offsets, dia, u, mask)
    if dia.numel() >= 2**62 or n >= _INT_MAX:
        raise ValueError("the CUDA kernel takes int32 rows")
    if not all(t.is_contiguous() for t in (offsets, dia, u, mask)
               if t is not None):
        raise ValueError("operands must be contiguous")
    y = torch.empty_like(u)
    _cuda.launch("pyfem_dia_spmv", offsets.data_ptr(), offsets.numel(),
                 dia.data_ptr(), u.data_ptr(),
                 None if mask is None else mask.data_ptr(), y.data_ptr(), n,
                 int(u.dtype == torch.float64), _cuda.stream_ptr(u))
    return y


def dia_matvec(offsets, dia, u, mask=None):
    """y = sum_k dia[k] * shift(u, offsets[k]), optionally BC-masked.

    Args:
        offsets: (noffs,) int32 column-minus-row offsets.
        dia: (noffs, n) diagonals in u's dtype: ``dia[k, i]`` multiplies
            ``u[i + offsets[k]]``.
        u: (n,) float32 or float64.
        mask: optional (n,) bool Dirichlet mask: ``where(mask, u,
            A where(mask, 0, u))``.
    """
    if u.device.type == "cuda":
        return _dia_matvec_cuda(offsets, dia, u, mask)
    if u.device.type == "cpu":
        return dia_matvec_plain(offsets, dia, u, mask)
    raise ValueError(f"unsupported device {u.device}")
