"""PyTorch port: element stiffness (K7, K8 and the einsum path) on CPU.

Gates, on jittered ProblemCreator meshes (17x9 quad4, a ragged 12x7
quad4, 5x4x4 hex8, n=5 tet10 and brick20 node lattices):

* float64: the port's einsum path (``ops.stiffness``) and the plain
  versions of K7 / K8 (``ops.element_kernels[3d].*_plain``, through the
  element-minor layout) equal the JAX einsum path within 1e-12 of
  max|Ke|, for both physics and every element type;
* float32: the port's element matrices are within 3e-5 (the JAX tests'
  own tolerance, tests/test_pallas_stiffness.py) of the JAX Pallas
  kernels in interpret mode for quad4 and hex8, both physics (four
  interpret-mode calls, ~15 s together); tet10 and brick20 are held in
  float32 to the JAX einsum path, which test_pallas_stiffness.py ties to
  the Pallas kernels;
* the layout helpers of ``convert`` round-trip;
* K8's decomposition (csrc/stiffness_3d.cu), emulated in float64 NumPy:
  the node pairs n <= m of the upper triangle (a thread each in the group
  kernel; all of an element's in the per-element Poisson kernel), the
  mirror of each 3x3 (1x1) block into the element-major tile, every
  entry written once, and the
  ``KeT`` the wrapper hands out as the transposed view of that buffer
  (``untranspose`` of it copies nothing), equal within 3e-5 to the JAX
  Pallas kernel in interpret mode for hex8 (both physics) and tet10 /
  brick20 Poisson, and to the JAX einsum path for tet10 / brick20
  elasticity (their interpret-mode calls take 11-44 s each);
* ``element_jacobian(kernel="cuda")`` of tet10 / brick20 models on the
  CPU equals the JAX package's element matrices in float32 (3e-5).

The JAX Pallas outputs are computed once per module (``_jax_pallas``).
The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3c).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import pyfem_gpu_testflight_tpu as fem
from pyfem_gpu_testflight_tpu.ops import stiffness as jst

import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import convert
from pyfem_gpu_testflight_tpu_torch.ops import element_kernels as ek
from pyfem_gpu_testflight_tpu_torch.ops import element_kernels3d as ek3
from pyfem_gpu_testflight_tpu_torch.ops import stiffness as tst

import torch_threads  # noqa: F401  (one torch thread per worker)

# name: (etype, ProblemCreator args, jitter amplitude)
MESHES = {
    "quad4": ("quad4", dict(nnodes_x=17, nnodes_y=9), 0.03),
    "quad4_ragged": ("quad4", dict(nnodes_x=12, nnodes_y=7), 0.03),
    "hex8": ("hex8", dict(nnodes_x=5, nnodes_y=4, nnodes_z=4,
                          element_type="block"), 0.03),
    "tet10": ("tet10", dict(nnodes_x=5, nnodes_y=5, nnodes_z=5,
                            element_type="tet"), 0.01),
    "brick20": ("brick20", dict(nnodes_x=5, nnodes_y=5, nnodes_z=5,
                                element_type="brick20"), 0.01),
}


def _inputs(name, seed=0):
    """(etype, Xe (nelems, nn, ndims), cq (nelems, nq), (mu, lam)) f64."""
    etype, kw, amp = MESHES[name]
    c = pt.ProblemCreator(**kw)
    rng = np.random.RandomState(seed)
    X = c.X + amp * rng.randn(*c.X.shape)
    et = pt.get_element(etype)
    Xe = X[c.conn]
    cq = 0.3 + 0.6 * rng.rand(len(c.conn), et.nquads)
    return etype, Xe, cq, tst.lame_params(10.0, 0.3, et.ndims)


def _jax_einsum(etype, Xe, cq, mulam, physics, dtype):
    et = fem.get_element(etype)
    args = (jnp.asarray(Xe, dtype), jnp.asarray(et.shape_grads, dtype),
            jnp.asarray(et.quad_wts, dtype), jnp.asarray(cq, dtype))
    if physics == "elasticity":
        return np.asarray(jst.elasticity_stiffness(*args, *mulam))
    return np.asarray(jst.poisson_stiffness(*args))


def _port_plain(etype, Xe, cq, mulam, physics, dtype):
    """The K7 / K8 plain version through the element-minor layout."""
    XeT = ek.transpose_xe(torch.as_tensor(Xe, dtype=dtype))
    cqT = torch.as_tensor(cq, dtype=dtype).t().contiguous()
    if etype == "quad4":
        KeT = (ek.elasticity_stiffness_quad4(XeT, cqT, *mulam)
               if physics == "elasticity"
               else ek.poisson_stiffness_quad4(XeT, cqT))
    else:
        KeT = (ek3.elasticity_stiffness_3d(XeT, cqT, *mulam, etype=etype)
               if physics == "elasticity"
               else ek3.poisson_stiffness_3d(XeT, cqT, etype=etype))
    return convert.ket_to_ke(KeT).numpy()


def _port_einsum(etype, Xe, cq, mulam, physics, dtype):
    et = pt.get_element(etype)
    args = (torch.as_tensor(Xe, dtype=dtype),
            torch.as_tensor(et.shape_grads, dtype=dtype),
            torch.as_tensor(et.quad_wts, dtype=dtype),
            torch.as_tensor(cq, dtype=dtype))
    if physics == "elasticity":
        return tst.elasticity_stiffness(*args, *mulam).numpy()
    return tst.poisson_stiffness(*args).numpy()


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_stiffness_matches_jax_einsum_f64(name, physics):
    etype, Xe, cq, mulam = _inputs(name)
    ref = _jax_einsum(etype, Xe, cq, mulam, physics, jnp.float64)
    scale = np.abs(ref).max()
    for fn in (_port_plain, _port_einsum):
        got = fn(etype, Xe, cq, mulam, physics, torch.float64)
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= 1e-12 * scale, fn.__name__


_PALLAS = {}  # (name, physics) -> Ke of the JAX Pallas kernel, seed 1


def _jax_pallas(name, physics):
    """The JAX Pallas kernel in interpret mode on the float32 seed-1
    inputs of ``name``, as (nelems, ndpe, ndpe); each computed once per
    module (an interpret-mode call takes 3-44 s)."""
    from pyfem_gpu_testflight_tpu.ops import pallas_stiffness as jp2
    from pyfem_gpu_testflight_tpu.ops import pallas_stiffness3d as jp3

    if (name, physics) not in _PALLAS:
        etype, Xe, cq, mulam = _inputs(name, seed=1)
        XeT = jnp.asarray(ek.transpose_xe(torch.as_tensor(Xe)).numpy(),
                          jnp.float32)
        cqT = jnp.asarray(cq.T, jnp.float32)
        if etype == "quad4":
            KeT = (jp2.elasticity_stiffness_quad4(XeT, cqT, *mulam,
                                                  tile=1024, interpret=True)
                   if physics == "elasticity"
                   else jp2.poisson_stiffness_quad4(XeT, cqT, tile=1024,
                                                    interpret=True))
        else:
            KeT = (jp3.elasticity_stiffness_3d(XeT, cqT, *mulam,
                                               etype=etype, interpret=True)
                   if physics == "elasticity"
                   else jp3.poisson_stiffness_3d(XeT, cqT, etype=etype,
                                                 interpret=True))
        _PALLAS[name, physics] = convert.ket_to_ke(np.asarray(KeT))
    return _PALLAS[name, physics]


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
@pytest.mark.parametrize("name", ["quad4", "hex8"])
def test_stiffness_matches_jax_pallas_interpret_f32(name, physics):
    etype, Xe, cq, mulam = _inputs(name, seed=1)
    ref = _jax_pallas(name, physics)
    got = _port_plain(etype, Xe, cq, mulam, physics, torch.float32)
    np.testing.assert_allclose(got, ref, rtol=3e-5, atol=3e-5)


def _k8_pair(t, nn):
    """The node pair (n, m), n <= m, of pair task t: the kernel's decode
    of its row-major upper-triangle index."""
    m, n = t, 0
    while m >= nn - n:
        m -= nn - n
        n += 1
    return n, m + n


def _k8_emulated(etype, Xe, cq, mulam, physics):
    """K8 as csrc/stiffness_3d.cu decomposes it, in float64 NumPy:
    geometry once per element (centred coordinates, J, its inverse,
    c = cq w detJ, the gradients G from ``element_table``), then per node
    pair task the outer product A = sum_q (c G_n) G_m^T, the block
    mu (A^T + tr(A) I) + lam A (Poisson: tr A), written at (n, m) and
    mirrored to (m, n) in the element-major buffer (E, ndpe, ndpe).
    Returns (buffer, KeT) with KeT the wrapper's transposed view; asserts
    that every entry is written exactly once."""
    et = pt.get_element(etype)
    nn, nq = et.nnodes, et.nquads
    nd = 3 if physics == "elasticity" else 1
    ndpe = nd * nn
    tab = ek3.element_table(etype, "cpu").double().numpy()
    dn, w = tab[:, :3 * nn].reshape(nq, nn, 3), tab[:, 3 * nn]
    xc = Xe - Xe.mean(axis=1, keepdims=True)          # (E, nn, 3)
    J = np.einsum("qnk,enr->eqrk", dn, xc)
    detJ, invJ = np.linalg.det(J), np.linalg.inv(J)   # invJ[m][l]
    G = np.einsum("qnm,eqml->eqnl", dn, invJ)         # (E, nq, nn, 3)
    c = cq * w[None] * detJ                            # (E, nq)
    E = len(Xe)
    buf = torch.full((E, ndpe, ndpe), float("nan"), dtype=torch.float64)
    writes = np.zeros((ndpe, ndpe), int)
    for t in range(nn * (nn + 1) // 2):
        n, m = _k8_pair(t, nn)
        A = np.einsum("eqi,eqj->eij", c[..., None] * G[:, :, n],
                      G[:, :, m])                       # (E, 3, 3)
        tr = np.trace(A, axis1=1, axis2=2)
        for a in range(nd):
            for b in range(nd):
                if nd == 1:
                    v = tr
                else:
                    v = (mulam[0] * (A[:, b, a] + (a == b) * tr)
                         + mulam[1] * A[:, a, b])
                r, s = n * nd + a, m * nd + b
                buf[:, r, s] = torch.as_tensor(v)
                writes[r, s] += 1
                if n != m:
                    buf[:, s, r] = torch.as_tensor(v)
                    writes[s, r] += 1
    assert (writes == 1).all()
    return buf, buf.view(E, ndpe * ndpe).t()


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
@pytest.mark.parametrize("name", ["hex8", "tet10", "brick20"])
def test_k8_index_map_matches_jax(name, physics):
    etype, Xe, cq, mulam = _inputs(name, seed=1)
    buf, KeT = _k8_emulated(etype, Xe, cq, mulam, physics)
    nd = 3 if physics == "elasticity" else 1
    ndpe = nd * pt.get_element(etype).nnodes
    assert KeT.shape == (ndpe * ndpe, len(Xe))
    # the operator's layout: untranspose of the view is the buffer itself
    Ke = ek.untranspose(KeT, ndpe, ndpe)
    assert Ke.data_ptr() == buf.data_ptr() and Ke.is_contiguous()
    if etype == "hex8" or physics == "poisson":
        ref = _jax_pallas(name, physics)
    else:
        ref = _jax_einsum(etype, Xe, cq, mulam, physics, jnp.float32)
    np.testing.assert_allclose(Ke.numpy(), ref, rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
@pytest.mark.parametrize("name", ["tet10", "brick20"])
def test_element_jacobian_kernel_cuda_on_cpu_matches_jax(name, physics):
    etype, kw, amp = MESHES[name]
    c = pt.ProblemCreator(**kw)
    conn, X, fixed, force = c.create_linear_elasticity_problem()
    rng = np.random.RandomState(4)
    X = X + amp * rng.randn(*X.shape)
    rho = np.full(len(X), 0.7)  # RAMP stays off its pole (quadratic N < 0)
    if physics == "elasticity":
        args = (etype, X, conn, np.asarray(fixed), None, force)
        mj = fem.LinearElasticity(*args, p=3.0, dtype=jnp.float32)
        with pytest.warns(UserWarning):
            mt = pt.LinearElasticity(*args, p=3.0, dtype=torch.float32,
                                     device="cpu", kernel="cuda")
    else:
        args = (etype, X, conn, np.asarray(fixed)[::3] // 3)
        mj = fem.LinearPoisson(*args, p=3.0, dtype=jnp.float32)
        with pytest.warns(UserWarning):
            mt = pt.LinearPoisson(*args, p=3.0, dtype=torch.float32,
                                  device="cpu", kernel="cuda")
    Ke = mt.element_jacobian(rho)
    assert Ke.is_contiguous()
    np.testing.assert_allclose(Ke.numpy(),
                               np.asarray(mj.element_jacobian(rho)),
                               rtol=3e-5, atol=3e-5)


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
@pytest.mark.parametrize("name", ["tet10", "brick20"])
def test_quadratic_stiffness_matches_jax_einsum_f32(name, physics):
    etype, Xe, cq, mulam = _inputs(name, seed=2)
    ref = _jax_einsum(etype, Xe, cq, mulam, physics, jnp.float32)
    got = _port_plain(etype, Xe, cq, mulam, physics, torch.float32)
    np.testing.assert_allclose(got, ref, rtol=3e-5, atol=3e-5)


def test_layout_helpers_round_trip():
    rng = np.random.default_rng(0)
    Xe = rng.standard_normal((7, 8, 3))
    XeT = ek.transpose_xe(torch.as_tensor(Xe)).numpy()
    assert XeT.shape == (24, 7) and XeT[3 * 2 + 1, 4] == Xe[4, 2, 1]
    assert torch.equal(ek.untranspose(torch.as_tensor(XeT), 8, 3),
                       torch.as_tensor(Xe))
    Ke = torch.as_tensor(rng.standard_normal((7, 24, 24)))
    KeT = ek.transpose_xe(Ke)
    assert KeT.shape == (576, 7) and KeT[5 * 24 + 9, 3] == Ke[3, 5, 9]
    assert torch.equal(convert.ket_to_ke(KeT), Ke)
    assert np.array_equal(convert.ket_to_ke(KeT.numpy()), Ke.numpy())
    # one transpose serves K7's quad4 layout too (rows n*2 + i)
    Xe2 = torch.as_tensor(rng.standard_normal((5, 4, 2)))
    XeT2 = ek.transpose_xe(Xe2)
    assert XeT2.shape == (8, 5) and XeT2[2 * 3 + 1, 2] == Xe2[2, 3, 1]
    assert torch.equal(ek.untranspose(XeT2, 4, 2), Xe2)


def test_wrappers_check_inputs():
    XeT = torch.zeros(8, 5, dtype=torch.float32)
    with pytest.raises(ValueError):
        ek.poisson_stiffness_quad4(XeT, torch.zeros(3, 5))  # nq
    with pytest.raises(ValueError):
        ek.poisson_stiffness_quad4(XeT, torch.zeros(4, 5, dtype=torch.float64))
    with pytest.raises(ValueError):
        ek3.poisson_stiffness_3d(torch.zeros(24, 5), torch.zeros(8, 5),
                                 etype="tet4")
    with pytest.raises(ValueError):
        ek3.elasticity_stiffness_3d(torch.zeros(24, 5), torch.zeros(8, 5),
                                    1.0, 1.0, etype="brick20")  # 60 rows
