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
* the layout helpers of ``convert`` round-trip.

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

torch.set_num_threads(2)

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
    XeT = convert.xe_to_xet(torch.as_tensor(Xe, dtype=dtype))
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


@pytest.mark.parametrize("physics", ["elasticity", "poisson"])
@pytest.mark.parametrize("name", ["quad4", "hex8"])
def test_stiffness_matches_jax_pallas_interpret_f32(name, physics):
    from pyfem_gpu_testflight_tpu.ops import pallas_stiffness as jp2
    from pyfem_gpu_testflight_tpu.ops import pallas_stiffness3d as jp3

    etype, Xe, cq, mulam = _inputs(name, seed=1)
    XeT = jnp.asarray(convert.xe_to_xet(Xe), jnp.float32)
    cqT = jnp.asarray(cq.T, jnp.float32)
    if etype == "quad4":
        KeT = (jp2.elasticity_stiffness_quad4(XeT, cqT, *mulam, tile=1024,
                                              interpret=True)
               if physics == "elasticity"
               else jp2.poisson_stiffness_quad4(XeT, cqT, tile=1024,
                                                interpret=True))
    else:
        KeT = (jp3.elasticity_stiffness_hex8(XeT, cqT, *mulam,
                                             interpret=True)
               if physics == "elasticity"
               else jp3.poisson_stiffness_hex8(XeT, cqT, interpret=True))
    ref = convert.ket_to_ke(np.asarray(KeT))
    got = _port_plain(etype, Xe, cq, mulam, physics, torch.float32)
    np.testing.assert_allclose(got, ref, rtol=3e-5, atol=3e-5)


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
    XeT = convert.xe_to_xet(Xe)
    assert isinstance(XeT, np.ndarray)
    assert XeT.shape == (24, 7) and XeT[3 * 2 + 1, 4] == Xe[4, 2, 1]
    assert torch.equal(ek.untranspose(torch.as_tensor(XeT), 8, 3),
                       torch.as_tensor(Xe))
    Ke = torch.as_tensor(rng.standard_normal((7, 24, 24)))
    KeT = ek.transpose_xe(Ke)
    assert KeT.shape == (576, 7) and KeT[5 * 24 + 9, 3] == Ke[3, 5, 9]
    assert torch.equal(convert.ket_to_ke(KeT), Ke)
    assert np.array_equal(convert.ket_to_ke(KeT.numpy()), Ke.numpy())
    # the kernels' own transposes are the same layout
    assert torch.equal(ek.transpose_xe(torch.as_tensor(Xe)),
                       torch.as_tensor(XeT))
    assert ek3.transpose_xe_3d is ek3.transpose_xe_hex8 is ek.transpose_xe


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
