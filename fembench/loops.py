"""The traffic generator: the closed loops a mix file describes.

A mix file (``fembench/traffic/<mix>.json``) names its ``entry`` (the
module ``fembench/entries/<entry>.py`` that builds and judges it) and
the parameters of the loop; the loops and generators here are what the
entries share.  The entries so far are

* ``"solves"``: one caller re-solves the configuration for a stream of
  designs, cycling through a fixed set of ``designs`` smooth densities
  (drawn once from the mix's ``design_seed``) in an order drawn from the
  run's seed, each solve from x = 0 to the configuration's tolerance.
  Every seed does the same work in another order; the seed also draws
  the sample of answers that is checked;
* ``"topo"``: the MMA loop of the configuration's optimizer, in cycles of
  ``cycle`` iterations, each a fresh optimizer run from the initial
  design, so the work of a cycle never depends on the program's speed.

Each loop runs a warm-up in set-up, then a window of at least
``seconds``: whole units only (solves, cycles), the window closing at
the end of the unit in progress when the time ran out.
"""

from __future__ import annotations

import gc
import math
import random
import time

import numpy as np
import torch


def smooth_densities(dims, count, seed, lo, hi, waves, device,
                     dtype=torch.float32):
    """``count`` nodal densities in [lo, hi] on the node grid ``dims`` (x
    first), flat in node order (x fastest): each the mean of ``waves``
    cosines with wave numbers up to one per domain length, random
    directions and phases.  The few random numbers come from the seed
    (NumPy's generator, the same on every device); the fields are made
    on the device in one broadcast call per wave."""
    rng = np.random.default_rng(seed)
    dim = len(dims)
    axes = [torch.linspace(0.0, 1.0, n, dtype=torch.float64, device=device)
            for n in dims]
    mid, half = 0.5 * (hi + lo), 0.5 * (hi - lo)
    out = []
    for _ in range(count):
        t = torch.zeros(tuple(dims[::-1]), dtype=torch.float64,
                        device=device)
        for _ in range(waves):
            k = rng.uniform(-1.0, 1.0, dim)
            phase = rng.uniform(0.0, 2.0 * math.pi)
            arg = phase
            for ax in range(dim):
                shape = [1] * dim
                shape[dim - 1 - ax] = dims[ax]
                arg = arg + 2.0 * math.pi * k[ax] * axes[ax].reshape(shape)
            t += torch.cos(arg)
        out.append((mid + half * t / waves).reshape(-1).to(dtype))
    return out


GIB = float(1 << 30)


def sync(device):
    """Wait for the card (a no-op on the CPU, where tests run)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device):
    """The allocator's peak since the last reset (0 on the CPU)."""
    if torch.device(device).type == "cuda":
        return int(torch.cuda.max_memory_allocated(device))
    return 0


def free(device):
    """Give back what the program's state held before the reference runs."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class Reservoir:
    """A uniform sample of ``k`` of the window's answers, drawn from the
    seed: slot copies on the device, no host transfer in the window."""

    def __init__(self, k, seed):
        self.k = int(k)
        self.rng = random.Random(seed)
        self.items = []   # [index, key, tensor]
        self.seen = 0

    def offer(self, key, value):
        i = self.seen
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append([i, key, value.detach().clone()])
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            slot = self.items[j]
            slot[0], slot[1] = i, key
            slot[2].copy_(value)


def design_order(count, seed):
    """The order in which a run cycles through the design set."""
    return [int(i) for i in np.random.default_rng(seed).permutation(count)]


def solve_window(solve, iters_of, designs, order, seconds, device, sample,
                 seed, start=0):
    """Closed-loop solves until ``seconds`` have passed, the designs in
    ``order`` (cycled), starting at position ``start``.

    Returns a dict: ``times`` (s per solve, host clock from the call to a
    synchronized solution), ``iters`` (PCG iterations per solve),
    ``elapsed`` (first call to last solution), ``failed`` (solves that
    raised), ``sample`` (the reservoir) and ``next`` (the next position)."""
    res = Reservoir(sample, seed)
    times, iters, failed = [], [], []
    i = start
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        d = order[i % len(order)]
        try:
            u = solve(designs[d])
            sync(device)
        except RuntimeError as ex:  # no convergence: the answer never came
            failed.append(f"solve {i} (design {d}): {ex}")
        else:
            t1 = time.perf_counter()
            times.append(t1 - t0)
            iters.append(iters_of())
            res.offer(d, u)
        i += 1
        if time.perf_counter() - t_start >= seconds:
            break
    return dict(times=times, iters=iters, failed=failed, sample=res,
                elapsed=time.perf_counter() - t_start, attempted=i - start,
                next=i)


def topo_window(run_cycle, seconds, device):
    """Whole optimizer cycles until ``seconds`` have passed: a dict with
    ``cycles`` (the cycles' histories), ``failed``, ``elapsed``."""
    cycles, failed = [], []
    t_start = time.perf_counter()
    n = 0
    while True:
        try:
            cycles.append(run_cycle())
            sync(device)
        except RuntimeError as ex:
            failed.append(f"cycle {n}: {ex}")
        n += 1
        if time.perf_counter() - t_start >= seconds:
            break
    return dict(cycles=cycles, failed=failed, attempted=n,
                elapsed=time.perf_counter() - t_start)
