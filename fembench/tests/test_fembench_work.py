"""The yardstick reproduces the bounds the port's kernel table was
measured against (PERF.md, section 6: bench 2D at 1025x513)."""

import pytest

from fembench import work

BENCH2D = 1025 * 513


@pytest.mark.parametrize("call,plane_bytes,fields,us", [
    ("K2 bf16 presmooth with its residual", work.BF16, 4, 16.3),
    ("K2 f32 postsmooth with its residual", work.F32, 5, 28.9),
])
def test_smoothing_call_bound(call, plane_bytes, fields, us):
    by = work.smoothing_call_bytes(2, BENCH2D, work.planes(2, 2, False),
                                   plane_bytes, fields)
    assert work.bound_s(by, 0) * 1e6 == pytest.approx(us, abs=0.05), call


@pytest.mark.parametrize("itemsize,us", [(work.F32, 6.9), (8, 13.8)])
def test_stencil_product_bound(itemsize, us):
    by = work.stencil_product_bytes(2, BENCH2D, itemsize)
    assert work.bound_s(by, 0) * 1e6 == pytest.approx(us, abs=0.05)


def test_storage_and_assembly_counts():
    # full 2D planes, the 3D half-symmetric kept planes of the port
    assert work.planes(2, 2, False) == 36
    assert work.planes(3, 3, True) == 123
    # structurally nonzero weights per node: 64 per 2D block, 512 per
    # 3D block; the half-symmetric 3D storage keeps 2400 of them
    assert work.assembly_weight(2, 2, False) == 256
    assert work.assembly_weight(3, 3, True) == 2400


def test_levels():
    assert work.level_dims((4097, 2049), 5)[-1] == (9, 5)
    assert len(work.level_dims((4097, 2049), 5)) == 10
    assert work.level_dims((257, 129, 129), 3)[-1] == (5, 3, 3)
    assert len(work.level_dims((257, 129, 129), 3)) == 7


def test_bounds_are_bytes_bound_for_stencils():
    by = work.smoothing_call_bytes(2, BENCH2D, 36, work.BF16, 4)
    fl = work.stencil_flops(2, 2, BENCH2D, 2)
    assert by / work.HBM_BYTES_S > fl / work.F32_FLOP_S
