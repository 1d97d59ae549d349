"""PyTorch port, K2's one-pass launch plan (``ops/fused_smooth.py``) on CPU.

On the card a smoothing call runs as the launches of ``sweep_plan_2d``:
groups of at most ``SWEEP_BUDGET_2D`` stencil steps, each a grid of
tiles, each tile computed from the iterate on the tile plus a ghost ring
as wide as its group's stencil steps and from its planes on the tile
plus the plan's ``ring`` (zeros past the grid): the region (one node
narrower) on full storage, the ghost ring on half storage, whose partner
term reads the kept value of the next node out.  These tests replay that
plan on the CPU in float64 with the plain version, each tile on its own
window, and hold it to the plain version on the whole grid (1e-12 of
max|plain|), in both storages: nd 1 and 2, niter 0-8, from x0 = 0 and
from a given x0, with and without the residual, Chebyshev-node damping,
ragged grids.  A ghost ring one node narrower must not pass, nor, on
half storage, kept planes on a ring one node narrower.  The plan's
region rows and sweep budget are the kernel source's.
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pyfem_gpu_testflight_tpu_torch import multigrid as tmg
from pyfem_gpu_testflight_tpu_torch.ops import fused_smooth as fs

import torch_threads  # noqa: F401  (one torch thread per worker)


def _level(nd, ny, nx, seed, full=True):
    rng = np.random.default_rng(seed)
    t = lambda *s: torch.as_tensor(rng.uniform(-1.0, 1.0, s),
                                   dtype=torch.float64)
    nk = nd * nd * 9 if full else len(fs.sym_planes_2d(nd))
    coeff = t(nk, ny, nx) / 9.0
    invd = 0.5 + 0.25 * t(nd, ny, nx)
    return coeff, invd, t(nd, ny, nx), t(nd, ny, nx)


def _tup(v):
    return v if isinstance(v, tuple) else (v,)


def _windows(t, g, ty, tx, gy, gx):
    """Every tile's window (the tile plus a ring of g, zeros past the
    grid) laid out side by side, one zero row and column after each:
    (nd, gy * (ty + 2g + 1), gx * (tx + 2g + 1))."""
    if t is None:
        return None
    nd, ny, nx = t.shape
    wy, wx = ty + 2 * g, tx + 2 * g
    p = torch.nn.functional.pad(t, (g, gx * tx - nx + g, g,
                                    gy * ty - ny + g))
    w = p.unfold(1, wy, ty).unfold(2, wx, tx)  # (nd, gy, gx, wy, wx)
    w = torch.nn.functional.pad(w, (0, 1, 0, 1))
    return w.permute(0, 1, 3, 2, 4).reshape(nd, gy * (wy + 1),
                                            gx * (wx + 1))


def _tiles(e, g, ty, tx, gy, gx, ny, nx):
    """Each window's tile back in place: the inverse of _windows."""
    wy, wx = ty + 2 * g + 1, tx + 2 * g + 1
    e = e.reshape(e.shape[0], gy, wy, gx, wx)[:, :, g:g + ty, :, g:g + tx]
    return e.reshape(e.shape[0], gy * ty, gx * tx)[:, :ny, :nx]


def replay(coeff, invd, b, x, *, niter, want_resid, neg_resid, omega,
           ghost_delta=0, ring_delta=0):
    """The call as the card runs it: the plan's groups in order, each
    tile of a group by the plain version on the tile plus a ring of
    ``g + ghost_delta`` nodes, its planes on the tile plus a ring of
    ``ring + ring_delta`` (zeros past those and past the grid), kept on
    the tile.  A group's windows run in one plain call, apart by a zero
    row and column (a node whose inverse diagonal and fields are 0 stays
    0, so no window sees another)."""
    nd, ny, nx = invd.shape
    oms = fs._omega_seq(omega, niter)
    full = fs.is_full_storage_2d(coeff, nd)
    plan = fs.sweep_plan_2d(nd, ny, nx, niter, x is None, want_resid, full)
    assert [i for grp in plan for i in grp["sweeps"]] == list(range(niter))
    assert [grp["resid"] for grp in plan] == [want_resid and j == len(plan) - 1
                                              for j in range(len(plan))]
    r = None
    for grp in plan:
        n, g, (ty, tx) = len(grp["sweeps"]), grp["g"], grp["tile"]
        gy, gx = grp["grid"]
        assert 1 <= g <= fs.SWEEP_BUDGET_2D and ty > 0 and tx > 0
        assert (gy - 1) * ty < ny <= gy * ty and (gx - 1) * tx < nx <= gx * tx
        assert grp["ring"] == (g - 1 if full else g)
        gw, pr = g + ghost_delta, min(grp["ring"] + ring_delta, g + ghost_delta)
        win = lambda t: _windows(t, gw, ty, tx, gy, gx)
        # the planes on the tile plus a ring of pr, in each window
        keep = torch.zeros(ty + 2 * gw + 1, tx + 2 * gw + 1,
                           dtype=coeff.dtype)
        keep[gw - pr:gw + ty + pr, gw - pr:gw + tx + pr] = 1
        out = _tup(fs.fused_sweeps_2d_plain(
            win(coeff) * keep.repeat(gy, gx), win(invd), win(b), win(x),
            niter=n,
            want_resid=grp["resid"], neg_resid=neg_resid,
            omega=tuple(oms[i] for i in grp["sweeps"])))
        out = [_tiles(o, gw, ty, tx, gy, gx, ny, nx) for o in out]
        if n > 0:
            x = out[0]
        if grp["resid"]:
            r = out[-1]
    return fs._outputs(x, r, niter, want_resid)


def _max_rel(got, ref):
    return max(float((g - r).abs().max() / r.abs().max())
               for g, r in zip(_tup(got), _tup(ref)))


# (nd, ny, nx, niter, x0 given, want_resid, neg_resid, Chebyshev nodes)
_CASES = [
    (2, 33, 65, 2, False, True, False, True),   # presmooth + resid
    (2, 33, 65, 2, True, False, False, True),   # postsmooth
    (2, 33, 65, 2, True, True, False, True),    # postsmooth + resid
    (2, 7, 13, 0, True, True, True, False),     # matvec (b given)
    (1, 9, 17, 0, True, True, False, False),    # Chebyshev residual
    (1, 3, 3, 1, False, False, False, False),   # elementwise only
    (1, 9, 17, 3, True, True, True, True),
    (2, 3, 3, 5, False, True, False, True),
    (1, 33, 65, 8, False, True, False, True),   # three groups
    (2, 9, 17, 8, True, True, False, True),
    (2, 40000, 2, 2, False, True, False, True),
    (1, 2, 40000, 6, True, False, False, False),
    (2, 7, 13, 4, True, False, True, True),
]


@pytest.mark.parametrize("case", _CASES)
def test_plan_replay_matches_whole_grid(case):
    nd, ny, nx, niter, given, want_resid, neg, cheby = case
    coeff, invd, b, x0 = _level(nd, ny, nx, seed=ny * 131 + nx)
    omega = tmg.smoothing_omegas(niter, 2.3) if cheby and niter else 0.7
    kw = dict(niter=niter, want_resid=want_resid, neg_resid=neg,
              omega=omega)
    x = x0 if given else None
    ref = fs.fused_sweeps_2d_plain(coeff, invd, b, x, **kw)
    got = replay(coeff, invd, b, x, **kw)
    assert _max_rel(got, ref) <= 1e-12


def test_plan_replay_with_a_narrower_ghost_ring_fails():
    nd, ny, nx = 2, 33, 65
    coeff, invd, b, x0 = _level(nd, ny, nx, seed=7)
    kw = dict(niter=2, want_resid=True, neg_resid=False,
              omega=tmg.smoothing_omegas(2, 2.3))
    ref = fs.fused_sweeps_2d_plain(coeff, invd, b, x0, **kw)
    assert _max_rel(replay(coeff, invd, b, x0, **kw), ref) <= 1e-12
    assert _max_rel(replay(coeff, invd, b, x0, ghost_delta=-1, **kw),
                    ref) > 1e-3


# the cases above on half storage (the kept planes of sym_planes_2d), the
# long strips shortened
_SYM_CASES = [c[:1] + tuple(min(v, 3000) for v in c[1:3]) + c[3:]
              for c in _CASES]


@pytest.mark.parametrize("case", _SYM_CASES)
def test_sym_plan_replay_matches_whole_grid(case):
    nd, ny, nx, niter, given, want_resid, neg, cheby = case
    coeff, invd, b, x0 = _level(nd, ny, nx, seed=ny * 131 + nx, full=False)
    omega = tmg.smoothing_omegas(niter, 2.3) if cheby and niter else 0.7
    kw = dict(niter=niter, want_resid=want_resid, neg_resid=neg,
              omega=omega)
    x = x0 if given else None
    ref = fs.fused_sweeps_2d_plain(coeff, invd, b, x, **kw)
    got = replay(coeff, invd, b, x, **kw)
    assert _max_rel(got, ref) <= 1e-12


@pytest.mark.parametrize("nd, niter", [(2, 2), (1, 1), (2, 5)])
def test_sym_plan_replay_with_a_narrower_plane_ring_fails(nd, niter):
    ny, nx = 33, 65
    coeff, invd, b, x0 = _level(nd, ny, nx, seed=11, full=False)
    kw = dict(niter=niter, want_resid=True, neg_resid=False,
              omega=tmg.smoothing_omegas(niter, 2.3))
    ref = fs.fused_sweeps_2d_plain(coeff, invd, b, x0, **kw)
    assert _max_rel(replay(coeff, invd, b, x0, **kw), ref) <= 1e-12
    assert _max_rel(replay(coeff, invd, b, x0, ring_delta=-1, **kw),
                    ref) > 1e-3


def test_plan_rows_and_budget_match_the_kernel_source():
    src = (Path(fs.__file__).resolve().parent.parent / "csrc"
           / "smooth_2d.cu").read_text()
    rows = dict(re.findall(r"\b(kRows[12]) = (\d+)", src))
    assert len(rows) == 2
    for nd, qh in fs._SWEEP_ROWS_2D.items():
        assert int(rows[f"kRows{nd}"]) == qh
        for g, full in itertools.product(range(1, fs.SWEEP_BUDGET_2D + 1),
                                         (True, False)):
            plan = fs.sweep_plan_2d(nd, 100, 100, g, False, False, full)
            assert plan[0]["tile"] == (qh - 2 * (g - 1), 32 - 2 * (g - 1))
            assert plan[0]["ring"] == (g - 1 if full else g)
    assert re.search(r"constexpr int kMaxSteps = (\d+);", src).group(1) \
        == str(fs.SWEEP_BUDGET_2D)
