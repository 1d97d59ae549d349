"""The yardstick: published peaks, roofline bounds and the least work of
each kernel layer, from shapes and the algorithm's call counts.

Every byte a call must read is counted once and every byte it must write
once, whatever a kernel reads again; operations count a multiply-add as
two.  A bound is the larger of bytes / memory rate and operations /
float32 rate outside the tensor cores.  These functions are frozen with
the benchmark: a kernel that replaces another adds a row to a table in
``fembench/kernels/``; nothing here depends on the program's code.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, no
sparsity) at its 700 W limit; a run prints the card's power limit
beside them.
"""

from __future__ import annotations

import math

HBM_BYTES_S = 3.35e12   # device memory
F32_FLOP_S = 67e12      # float32 outside the tensor cores
F64_FLOP_S = 34e12      # float64 outside the tensor cores
BF16_FLOP_S = 989e12    # dense bf16 on the tensor cores

F32, BF16 = 4, 2


def bound_s(n_bytes, flops, flop_s=F32_FLOP_S):
    """Least seconds of a call: max(bytes / HBM rate, flops / flop rate)."""
    return max(n_bytes / HBM_BYTES_S, flops / flop_s)


# -- grids and storage ----------------------------------------------------------


def level_dims(dims, min_n):
    """Node counts per axis (x first) of every GMG level: the cell count
    halves on every axis while each axis has an even cell count and keeps
    at least ``min_n`` nodes."""
    out = [tuple(dims)]
    while True:
        nxt = tuple((n - 1) // 2 + 1 if (n - 1) % 2 == 0 else None
                    for n in out[-1])
        if any(v is None or v < min_n for v in nxt):
            return out
        out.append(nxt)


def planes(dim, nd, sym):
    """Stored coefficient planes of a level: nd*nd*3^dim in full storage;
    in half-symmetric storage every plane with its partner (the
    transposed block at the opposite offset) once, the self-partners
    (diagonal blocks at offset zero) once each."""
    full = nd * nd * 3 ** dim
    return (full + nd) // 2 if sym else full


def assembly_weight(dim, nd, sym):
    """Structurally nonzero element weights per node of the stored
    planes: a plane at offset o couples two nodes through the elements
    they share, 2 per axis where o is 0 and 1 where it is +-1, so a
    block of all 3^dim offsets has (1 + 2 + 1)^dim = 4^dim per local
    node pair, 2^dim local nodes each."""
    block = 2 ** dim * 4 ** dim
    centre = 2 ** dim * 2 ** dim          # the weight of offset zero
    if not sym:
        return block * nd * nd
    return (block * nd * nd + centre * nd) // 2


def assembly_flops(dim, nd, sym, nodes):
    """Operations of the level assembly (K1 in 2D, K3 in 3D): one
    multiply-add per structurally nonzero weight of the stored planes,
    and per element (about one per node) the material at its 2^dim
    Gauss points, 2^dim multiply-adds each."""
    mat = 2 ** dim * 2 ** dim
    return 2 * (assembly_weight(dim, nd, sym) + mat) * nodes


def assembly_bytes(dim, nd, sym, nodes, lowp_copy):
    """Reads the density and the free-dof mask; writes the planes, the
    inverse diagonal and the low-precision copy of the planes."""
    P = planes(dim, nd, sym)
    per = F32 + F32 * nd + F32 * P + F32 * nd + (BF16 * P if lowp_copy
                                                 else 0)
    return per * nodes


def smoothing_call_bytes(nd, nodes, n_planes, plane_bytes, fields):
    """A smoothing call or operator product: its planes once and
    ``fields`` float32 fields of nd components (inputs and outputs)."""
    return (plane_bytes * n_planes + fields * F32 * nd) * nodes


def stencil_flops(dim, nd, nodes, steps):
    """One multiply-add per operator entry and node for each stencil step."""
    return 2 * nd * nd * 3 ** dim * nodes * steps


# -- the GMG solve ---------------------------------------------------------------


def _nodes(d):
    return math.prod(d)


def smoothing_work(cfg, vcycles, matvecs):
    """(bytes, flops) of the smoothing calls and operator products of
    ``vcycles`` V-cycles and ``matvecs`` separate PCG operator products.

    The V-cycle of the configuration (``gmg`` options: Jacobi sweeps with
    per-sweep damping, nu_pre = nu_post, a low-precision smoother copy,
    a dense coarsest level) on every level but the coarsest:
    a presmoothing call from x = 0 with its residual (reads the smoother
    planes, the inverse diagonal and b; writes x and r; nu_pre stencil
    steps, the first from x = 0 free) and a postsmoothing call from x
    (reads planes, inverse diagonal, b and x; writes x; nu_post steps).
    In 2D the finest postsmoothing call also returns its residual on the
    full-precision planes, which is the PCG's operator product (one more
    step, one more output); in 3D the PCG's product is a separate call
    on the full-precision planes.
    """
    g = cfg["gmg"]
    dim = len(cfg["grid"])
    nd = dim
    sym = bool(g.get("sym", dim == 3))
    P = planes(dim, nd, sym)
    lp = BF16 if g.get("smoother_dtype") == "bfloat16" else F32
    pre, post = int(g["nu_pre"]), int(g["nu_post"])
    call = lambda n, pb, fields: smoothing_call_bytes(nd, n, P, pb, fields)
    levels = level_dims(cfg["grid"], int(g["min_n"]))
    by = fl = 0.0
    for li, d in enumerate(levels[:-1]):
        n = _nodes(d)
        by += call(n, lp, 4)                # invd, b -> x, r
        fl += stencil_flops(dim, nd, n, pre)
        if li == 0 and dim == 2:
            by += call(n, F32, 5)           # invd, b, x -> x, r
            fl += stencil_flops(dim, nd, n, post + 1)
        else:
            by += call(n, lp, 4)            # invd, b, x -> x
            fl += stencil_flops(dim, nd, n, post)
    n0 = _nodes(levels[0])
    mv_by = call(n0, F32, 2)                # x -> A x
    mv_fl = stencil_flops(dim, nd, n0, 1)
    return vcycles * by + matvecs * mv_by, vcycles * fl + matvecs * mv_fl


def solve_counts(cfg, iters):
    """(V-cycles, separate operator products) of one PCG solve from x = 0
    that took ``iters`` iterations: one V-cycle before the loop and one
    per iteration; in 3D one operator product per iteration (in 2D the
    product rides the finest postsmoothing)."""
    dim = len(cfg["grid"])
    return iters + 1, (iters if dim == 3 else 0)


def assembly_work(cfg, hierarchies):
    """(bytes, flops) of ``hierarchies`` assemblies of every GMG level."""
    g = cfg["gmg"]
    dim = len(cfg["grid"])
    nd = dim
    sym = bool(g.get("sym", dim == 3))
    lowp = g.get("smoother_dtype") == "bfloat16"
    by = fl = 0.0
    for d in level_dims(cfg["grid"], int(g["min_n"])):
        n = _nodes(d)
        by += assembly_bytes(dim, nd, sym, n, lowp)
        fl += assembly_flops(dim, nd, sym, n)
    return hierarchies * by, hierarchies * fl


# -- the Helmholtz filter's stencil products ------------------------------------


def stencil_product_bytes(dim, nodes, itemsize=F32):
    """One scalar stencil product (nd = 1): the 3^dim planes and the
    input read once, the output written once."""
    return (3 ** dim + 2) * itemsize * nodes


def filter_work(cfg, products):
    """(bytes, flops) of ``products`` scalar stencil products on the
    finest grid."""
    dim = len(cfg["grid"])
    n = _nodes(cfg["grid"])
    return (products * stencil_product_bytes(dim, n),
            products * stencil_flops(dim, 1, n, 1))
