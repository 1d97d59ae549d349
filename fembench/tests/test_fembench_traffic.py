"""The traffic generator: seeded, reproducible designs and samples."""

import torch

from fembench import loops

BIG = 2 ** 31 + 12345


def test_designs_are_reproducible_per_seed():
    a = loops.smooth_densities((33, 17), 8, BIG, 0.3, 1.0, 3, "cpu")
    b = loops.smooth_densities((33, 17), 8, BIG, 0.3, 1.0, 3, "cpu")
    c = loops.smooth_densities((33, 17), 8, BIG + 1, 0.3, 1.0, 3, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert len({float(x.sum()) for x in a}) == 8      # eight designs


def test_designs_stay_in_range_and_node_order():
    dims = (9, 5, 3)
    for rho in loops.smooth_densities(dims, 4, 3, 0.3, 1.0, 3, "cpu"):
        assert rho.shape == (9 * 5 * 3,)
        assert rho.dtype == torch.float32
        assert float(rho.min()) >= 0.3 and float(rho.max()) <= 1.0


def test_reservoir_is_seeded_and_uniform_in_size():
    def sample(seed):
        r = loops.Reservoir(3, seed)
        for i in range(40):
            r.offer(i % 8, torch.full((2,), float(i)))
        return [(i, k, float(t[0])) for i, k, t in r.items]

    assert sample(5) == sample(5)
    assert sample(5) != sample(6)
    assert all(v == i for i, _, v in sample(5))
