"""PyTorch port: global assembly, Dirichlet algebra and CG on CPU.

Gates against the JAX package (float64, jittered 9x5 quad4 and 4x4x3
hex8 meshes, seeded element matrices):

* ``make_conn_dof`` and ``SparsityPattern`` (rows, cols, indptr,
  seg_ids, diag_pos) equal the JAX ones exactly;
* ``elem_matvec``, ``bc_elem_matvec``, ``elem_diagonal``,
  ``assemble_values``, ``assemble_vector``, ``constrain_values`` and
  ``constrain_operator`` within 1e-12 of max|ref|;
* ``solvers.cg`` takes the JAX ``solvers.cg``'s iteration count exactly,
  with x within 1e-10, at rtol 1e-12 (these jittered p=3 systems are
  ill-conditioned enough that the two recursive residuals drift apart
  by up to 2x in the last iterations, so at a tolerance that falls
  between them, e.g. rtol 1e-10 at 9x5, the counts differ by one);
* the 16-iteration blocked convergence check is bit-identical to a
  check after every iteration (x, iters, resnorm), and reads back to
  the host once per block;
* ``segment_sum`` is deterministic (two sums of the same input are
  bit-identical) and matches a float64 ``np.add.at``.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pyfem_gpu_testflight_tpu import assembly as jas
from pyfem_gpu_testflight_tpu import bcs as jbcs
from pyfem_gpu_testflight_tpu import solvers as jsol

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import assembly as tas
from pyfem_gpu_testflight_tpu_torch import bcs as tbcs
from pyfem_gpu_testflight_tpu_torch import solvers as tsol

import torch_threads  # noqa: F401  (one torch thread per worker)
DEV = "cpu"


def _system(dims, seed=0):
    """(conn_dof, ndof, Ke SPD-ish f64, fixed dofs) on a jittered mesh."""
    kw = (dict(nnodes_x=dims[0], nnodes_y=dims[1]) if len(dims) == 2 else
          dict(nnodes_x=dims[0], nnodes_y=dims[1], nnodes_z=dims[2],
               element_type="block"))
    c = pt.ProblemCreator(**kw)
    conn, X, fixed, _force = c.create_linear_elasticity_problem()
    rng = np.random.RandomState(seed)
    X = X + 0.03 * rng.randn(*X.shape)
    etype = "quad4" if len(dims) == 2 else "hex8"
    m = pt.LinearElasticity(etype, X, conn, fixed, None, None, p=3.0,
                            device=DEV)
    Ke = m.element_jacobian(0.3 + 0.6 * rng.rand(m.nnodes))
    return m.conn_dof_host, m.ndof, Ke.numpy(), np.asarray(fixed)


DIMS = [(9, 5), (4, 4, 3)]


@pytest.mark.parametrize("dims", DIMS)
def test_pattern_matches_jax(dims):
    conn_dof, ndof, _Ke, _f = _system(dims)
    conn = np.arange(conn_dof.shape[0] * 2).reshape(-1, 2) % 7
    assert np.array_equal(tas.make_conn_dof(conn, 3),
                          jas.make_conn_dof(conn, 3))
    pj = jas.SparsityPattern(conn_dof, ndof)
    pp = tas.SparsityPattern(conn_dof, ndof)
    assert pp.nnz == pj.nnz
    for name in ("rows", "cols", "indptr", "diag_pos"):
        assert np.array_equal(getattr(pp, name), np.asarray(getattr(pj, name)))
    assert np.array_equal(pp.seg_ids, np.asarray(pj.seg_ids))


def test_pattern_slots_unreferenced_diagonals():
    # dof 5 belongs to no element: it still gets a diagonal slot
    conn_dof = np.array([[0, 1, 2], [2, 3, 4]])
    pj = jas.SparsityPattern(conn_dof, 6)
    pp = tas.SparsityPattern(conn_dof, 6)
    assert pp.nnz == pj.nnz == 18
    assert np.array_equal(pp.diag_pos, np.asarray(pj.diag_pos))
    assert np.array_equal(pp.seg_ids, np.asarray(pj.seg_ids))


@pytest.mark.parametrize("dims", DIMS)
def test_operators_match_jax(dims):
    conn_dof, ndof, Ke, fixed = _system(dims)
    rng = np.random.default_rng(1)
    u = rng.standard_normal(ndof)
    fe = rng.standard_normal(conn_dof.shape)
    mask = np.zeros(ndof, bool)
    mask[fixed] = True
    cj, ct = jnp.asarray(conn_dof), torch.as_tensor(conn_dof).long()
    Kj, Kt = jnp.asarray(Ke), torch.as_tensor(Ke)
    seg = tas.SortedSegments(ct, ndof)
    pairs = [
        (jas.elem_matvec(Kj, cj, jnp.asarray(u), ndof),
         tas.elem_matvec(Kt, ct, torch.as_tensor(u), ndof, seg)),
        (jas.elem_matvec(Kj, cj, jnp.asarray(u), ndof),
         tas.elem_matvec(Kt, ct, torch.as_tensor(u), ndof)),
        (jas.bc_elem_matvec((Kj, cj, jnp.asarray(mask)), jnp.asarray(u)),
         tas.bc_elem_matvec((Kt, ct, torch.as_tensor(mask), seg),
                            torch.as_tensor(u))),
        (jas.elem_diagonal(Kj, cj, ndof), tas.elem_diagonal(Kt, ct, ndof, seg)),
        (jas.assemble_vector(jnp.asarray(fe), cj, ndof),
         tas.assemble_vector(torch.as_tensor(fe), ct, ndof, seg)),
    ]
    pj = jas.SparsityPattern(conn_dof, ndof)
    pp = tas.SparsityPattern(conn_dof, ndof)
    vj, vt = jas.assemble_values(Kj, pj), tas.assemble_values(Kt, pp)
    pairs.append((vj, vt))
    bj = jbcs.DirichletBC(fixed, None, ndof)
    bt = tbcs.DirichletBC(fixed, None, ndof, device=DEV)
    pairs.append((bj.constrain_values(vj, pj), bt.constrain_values(vt, pp)))
    opj = bj.constrain_operator(lambda v: jas.elem_matvec(Kj, cj, v, ndof))
    opt = bt.constrain_operator(lambda v: tas.elem_matvec(Kt, ct, v, ndof))
    pairs.append((opj(jnp.asarray(u)), opt(torch.as_tensor(u))))
    for ref, got in pairs:
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        assert np.abs(got.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    # the scipy export holds the same matrix
    Kj_csr, Kt_csr = jas.scipy_csr(vj, pj), tas.scipy_csr(vt, pp)
    assert abs(Kj_csr - Kt_csr).max() <= 1e-12 * abs(Kj_csr).max()


def test_segment_sum_deterministic_and_exact():
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 50, 4000)
    data = rng.standard_normal(4000)
    ref = np.zeros(53)
    np.add.at(ref, ids, data)
    seg = tas.SortedSegments(torch.as_tensor(ids), 53)
    a = tas.segment_sum(torch.as_tensor(data), seg, 53)
    b = tas.segment_sum(torch.as_tensor(data), torch.as_tensor(ids), 53)
    assert torch.equal(a, b)
    assert np.abs(a.numpy() - ref).max() <= 1e-12 * np.abs(ref).max()
    assert (a[50:] == 0).all()  # empty segments
    with pytest.raises(ValueError):
        seg.sum(torch.zeros(10))


def _cg_problem(dims, seed=0):
    conn_dof, ndof, Ke, fixed = _system(dims, seed)
    mask = np.zeros(ndof, bool)
    mask[fixed] = True
    b = np.where(mask, 0.0, np.random.default_rng(3).standard_normal(ndof))
    diag = np.asarray(jas.elem_diagonal(jnp.asarray(Ke),
                                        jnp.asarray(conn_dof), ndof))
    inv_diag = 1.0 / np.where(mask | (diag == 0), 1.0, diag)
    return conn_dof, ndof, Ke, mask, b, inv_diag


@pytest.mark.parametrize("dims", DIMS)
def test_cg_matches_jax(dims):
    conn_dof, ndof, Ke, mask, b, inv_diag = _cg_problem(dims)
    rj = jsol.cg(jas.bc_elem_matvec,
                 (jnp.asarray(Ke), jnp.asarray(conn_dof), jnp.asarray(mask)),
                 jnp.asarray(b), inv_diag=jnp.asarray(inv_diag), rtol=1e-12)
    ct = torch.as_tensor(conn_dof).long()
    rt = tsol.cg(tas.bc_elem_matvec,
                 (torch.as_tensor(Ke), ct, torch.as_tensor(mask),
                  tas.SortedSegments(ct, ndof)),
                 torch.as_tensor(b), inv_diag=torch.as_tensor(inv_diag),
                 rtol=1e-12)
    assert int(rt.iters) == int(rj.iters) > 10
    xj = np.asarray(rj.x)
    assert np.abs(rt.x.numpy() - xj).max() <= 1e-10 * np.abs(xj).max()
    assert float(rt.resnorm) <= 1e-12 * np.linalg.norm(b)


@pytest.mark.parametrize("maxiter", [None, 21])
def test_cg_blocked_check_is_bit_identical(maxiter, monkeypatch):
    conn_dof, ndof, Ke, mask, b, inv_diag = _cg_problem((9, 5), seed=4)
    ct = torch.as_tensor(conn_dof).long()
    data = (torch.as_tensor(Ke), ct, torch.as_tensor(mask),
            tas.SortedSegments(ct, ndof))
    kw = dict(inv_diag=torch.as_tensor(inv_diag), rtol=1e-9,
              maxiter=maxiter)
    n0 = tsol.readbacks["cg"]
    assert tsol.CHECK_EVERY == 16
    blocked = tsol.cg(tas.bc_elem_matvec, data, torch.as_tensor(b), **kw)
    n_blocked = tsol.readbacks["cg"] - n0
    monkeypatch.setattr(tsol, "CHECK_EVERY", 1)
    each = tsol.cg(tas.bc_elem_matvec, data, torch.as_tensor(b), **kw)
    k = int(each.iters)
    assert k == (21 if maxiter else k) and k > 16
    assert torch.equal(blocked.x, each.x)
    assert torch.equal(blocked.iters, each.iters)
    assert torch.equal(blocked.resnorm, each.resnorm)
    assert n_blocked == -(-k // 16) + (1 if k % 16 == 0 else 0)
