"""PyTorch port, the DIA operator (``ops.dia``) and kernel U2's plain
version (``ops.spmv.dia_matvec``).

* ``DiaOperator`` from ``conn_dof``: matvec and diagonal against the
  assembled CSR matrix, ``bc_matvec`` against ``bc_elem_matvec``, 3D
  Poisson (the cases of ``tests/test_dia.py``), on the same meshes;
* ``structured_dia_2d`` / ``StructuredDia2D`` in both layouts against
  the JAX package's at 1e-12, ``assemble`` and ``assemble_transposed``;
* ``unstructured.csr_to_dia`` offsets and values against the JAX
  package's, and a DIA product against the CSR product (U2 against U1's
  plain versions) on the torque arm's RCM-ordered matrix;
* the refusals: more diagonals than ``max_offsets`` (``DiaOperator``,
  ``csr_to_dia``, the AMG set-up, with the JAX messages' wording) and
  ``assemble`` on a ``from_offsets`` operator;
* U2's plain version against a dense product with offsets past both
  ends and a mask.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu import unstructured as jax_unstructured
from pyfem_gpu_testflight_tpu.ops import dia as jax_dia

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import assembly, unstructured
from pyfem_gpu_testflight_tpu_torch.examples.torque_arm import (
    arm_model, synthesize_arm_inp,
)
from pyfem_gpu_testflight_tpu_torch.ops import spmv
from pyfem_gpu_testflight_tpu_torch.ops.dia import (
    DiaOperator, build_dia, structured_dia_2d,
)

import torch_threads  # noqa: F401  (one torch thread per worker)


def _model(physics="elasticity"):
    if physics == "elasticity":
        creator = pt.ProblemCreator(nnodes_x=13, nnodes_y=9)
        conn, X, fixed, force = creator.create_linear_elasticity_problem()
        return pt.LinearElasticity("quad4", X, conn, fixed, None, force,
                                   device="cpu")
    creator = pt.ProblemCreator(6, 5, 4, element_type="block")
    conn, X, fixed = creator.create_poisson_problem()
    return pt.LinearPoisson("hex8", X, conn, fixed, device="cpu")


@pytest.mark.parametrize("physics", ["elasticity", "poisson3d"])
def test_dia_matvec_and_diagonal_match_csr(physics):
    model = _model("elasticity" if physics == "elasticity" else "poisson")
    Ke = model.element_jacobian()
    K = model.assemble_scipy(Ke)
    op, dia = build_dia(model.conn_dof_host, model.ndof, Ke)
    if physics == "elasticity":
        assert op.noffs <= 27
    u = np.random.default_rng(0).standard_normal(model.ndof)
    y = op.matvec(dia, torch.as_tensor(u))
    np.testing.assert_allclose(y.numpy(), K @ u, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(op.diagonal(dia).numpy(), K.diagonal(),
                               rtol=1e-13, atol=1e-14)


def test_dia_bc_matvec_matches_elem_bc_matvec():
    model = _model()
    Ke = model.element_jacobian()
    op = DiaOperator(model.conn_dof_host, model.ndof, device="cpu")
    dia = op.assemble(Ke)
    u = torch.as_tensor(np.random.default_rng(1).standard_normal(model.ndof))
    y1 = op.bc_matvec(dia, model.bc.mask, u)
    y2 = assembly.bc_elem_matvec((Ke, model.conn_dof, model.bc.mask), u)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("layout", ["interleaved", "planar"])
def test_structured_dia_2d_matches_jax(layout):
    nx, ny, nd = 9, 6, 2
    creator = fem.ProblemCreator(nnodes_x=nx, nnodes_y=ny)
    conn, X, fixed, force = creator.create_linear_elasticity_problem()
    Ke = np.random.default_rng(2).standard_normal(
        ((nx - 1) * (ny - 1), 4 * nd, 4 * nd))
    op, st = structured_dia_2d(nx, ny, nd, layout=layout)
    op_j, st_j = jax_dia.structured_dia_2d(nx, ny, nd, layout=layout)
    np.testing.assert_array_equal(op.offsets, op_j.offsets)
    assert (op.lo, op.hi, op.noffs) == (op_j.lo, op_j.hi, op_j.noffs)
    assert st.plan == st_j.plan
    d = st.assemble(torch.as_tensor(Ke))
    np.testing.assert_allclose(d.numpy(), np.asarray(st_j.assemble(
        jnp.asarray(Ke))), rtol=1e-12, atol=1e-12)
    KeT = Ke.reshape(Ke.shape[0], -1).T.copy()
    dT = st.assemble_transposed(torch.as_tensor(KeT))
    np.testing.assert_allclose(dT.numpy(), d.numpy(), rtol=1e-12,
                               atol=1e-12)
    u = np.random.default_rng(3).standard_normal(op.ndof)
    np.testing.assert_allclose(
        op.matvec(d, torch.as_tensor(u)).numpy(),
        np.asarray(op_j.matvec(jnp.asarray(d.numpy()), jnp.asarray(u))),
        rtol=1e-12, atol=1e-12)
    if layout == "interleaved":  # the general route's assembly agrees
        cd = pt.assembly.make_conn_dof(conn, nd)
        dg = build_dia(cd, op.ndof, torch.as_tensor(Ke))[1]
        np.testing.assert_allclose(dg.numpy(), d.numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_csr_to_dia_matches_jax_and_csr(tmp_path):
    inp = synthesize_arm_inp(str(tmp_path / "arm.inp"), nr=12, nt=80)
    model = arm_model(inp, device="cpu")[0]
    K, _b = model.bc.apply_scipy(model.assemble_scipy(
        model.element_jacobian()), np.zeros(model.ndof))
    perm = unstructured.rcm_permutation(K)
    Kp = K[perm][:, perm].tocsr()
    op, vals, offs = unstructured.csr_to_dia(Kp, torch.float64,
                                             device="cpu")
    op_j, vals_j, offs_j = jax_unstructured.csr_to_dia(Kp, jnp.float64)
    np.testing.assert_array_equal(offs, offs_j)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vals_j))
    assert op.noffs == op_j.noffs and op.noffs == offs.size
    # the offsets handed back again: the same values
    vals2 = unstructured.csr_to_dia(Kp, torch.float64, offsets=offs,
                                    device="cpu")[1]
    assert torch.equal(vals, vals2)
    u = torch.as_tensor(np.random.default_rng(4).standard_normal(Kp.shape[0]))
    y_dia = op.matvec(vals, u)
    y_csr = spmv.csr_matvec(torch.as_tensor(Kp.indptr, dtype=torch.int32),
                            torch.as_tensor(Kp.indices, dtype=torch.int32),
                            torch.as_tensor(Kp.data), u)
    np.testing.assert_allclose(y_dia.numpy(), y_csr.numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(y_csr.numpy(), Kp @ u.numpy(), rtol=1e-12,
                               atol=1e-12)


def test_max_offsets_refusals(tmp_path):
    model = _model()
    noffs = DiaOperator(model.conn_dof_host, model.ndof, device="cpu").noffs
    for cls in (DiaOperator, jax_dia.DiaOperator):
        with pytest.raises(ValueError, match="diagonals"):
            cls(model.conn_dof_host, model.ndof, max_offsets=noffs - 1)
    K = model.assemble_scipy(model.element_jacobian())
    with pytest.raises(ValueError, match="reorder"):
        unstructured.csr_to_dia(K, torch.float64, max_offsets=noffs - 1,
                                device="cpu")
    with pytest.raises(ValueError, match="reorder"):
        jax_unstructured.csr_to_dia(K, jnp.float64, max_offsets=noffs - 1)
    # the AMG set-up refuses where the JAX one does (its levels are CSR,
    # the gate is kept for parity)
    K, b = model.bc.apply_scipy(K, model.compute_rhs().numpy())
    for amg_pcg, kw in ((unstructured.amg_pcg, dict(device="cpu")),
                        (jax_unstructured.amg_pcg, {})):
        with pytest.raises(ValueError, match="diagonals"):
            amg_pcg(K, b, nd=2, max_offsets=10, **kw)
    op = DiaOperator.from_offsets([0, 1, -1], model.ndof)
    with pytest.raises(ValueError, match="from_offsets"):
        op.assemble(model.element_jacobian())


def test_dia_matvec_plain_matches_dense_at_both_ends():
    rng = np.random.default_rng(5)
    n = 37
    offsets = np.array([-40, -36, -5, -1, 0, 2, 17, 36, 50])
    dia = rng.standard_normal((offsets.size, n))
    A = np.zeros((n, n))
    for k, off in enumerate(offsets):
        for i in range(n):
            if 0 <= i + off < n:
                A[i, i + off] = dia[k, i]
    u = rng.standard_normal(n)
    mask = rng.uniform(size=n) < 0.3
    t = lambda a: torch.as_tensor(a)
    offs = t(offsets.astype(np.int32))
    np.testing.assert_allclose(spmv.dia_matvec(offs, t(dia), t(u)).numpy(),
                               A @ u, rtol=1e-13, atol=1e-13)
    uz = np.where(mask, 0.0, u)
    want = np.where(mask, u, A @ uz)
    got = spmv.dia_matvec(offs, t(dia), t(u), t(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-13)
    with pytest.raises(ValueError):
        spmv.dia_matvec(offs.long(), t(dia), t(u))
