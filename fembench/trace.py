"""The device trace of a profiled segment, from ``torch.profiler``.

A :class:`Segment` profiles host and device activity over a block of
whole units of work (solves, optimizer cycles).  Afterwards it holds the
device activities (kernels, copies, sets) with their times, the host's
operator and ``record_function`` ranges, the segment's wall time, and
the readings the result line and the per-layer readers take from them.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict

import torch
from torch.profiler import ProfilerActivity, profile

from .loops import sync


def _ns(ev, what):
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(1000 * getattr(ev, what + "_us")())


def _annotation(ev):
    """A host range mirrored on the device timeline, not device work."""
    f = getattr(ev, "is_user_annotation", None)
    return bool(f()) if f is not None else ev.name().startswith("fembench.")


def short_name(name):
    """A kernel's name without its return type, anonymous namespace and
    argument list."""
    name = name.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    return name.split("(")[0].strip()


class Segment:
    """``with Segment(device) as seg: ...`` profiles the block; the card
    is synchronized on entry and on exit so the block's work is whole."""

    def __init__(self, device):
        self.device = device
        self.dev = []     # (start_ns, end_ns, name) of device activities
        self.host = []    # (start_ns, end_ns, name) of host ranges
        self.window_s = None

    def __enter__(self):
        sync(self.device)
        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        sync(self.device)
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read(self._prof.profiler.kineto_results.events())
        return False

    def _read(self, events):
        for ev in events:
            start = _ns(ev, "start")
            end = start + _ns(ev, "duration")
            row = (start, end, ev.name())
            if ev.device_type() != torch.autograd.DeviceType.CUDA:
                self.host.append(row)
            elif not _annotation(ev):
                self.dev.append(row)
        self.dev.sort()
        self.host.sort()

    # -- readings ---------------------------------------------------------------

    def _merged(self):
        out = []
        for s, e, _ in self.dev:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    @property
    def busy_s(self):
        """Seconds in which some device activity ran."""
        return sum(e - s for s, e in self._merged()) / 1e9

    @property
    def idle_pct(self):
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    @property
    def device_activities(self):
        return len(self.dev)

    def seconds_of(self, substrings):
        """Device seconds of the activities whose name holds any of
        ``substrings`` (a kernel table of ``fembench/kernels``)."""
        return sum(e - s for s, e, n in self.dev
                   if any(k in n for k in substrings)) / 1e9

    def device_ops(self, top=10):
        """[[name, seconds]] of the device operations that took most."""
        by = defaultdict(int)
        for s, e, n in self.dev:
            by[short_name(n)] += e - s
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n, v / 1e9] for n, v in rows]

    def idle_gaps(self, top=10):
        """[[host range, seconds]]: the device's idle gaps summed by the
        innermost host operator or ``record_function`` range open when
        each gap began, the longest first."""
        merged = self._merged()
        starts = [h[0] for h in self.host]
        outer = [h for h in self.host if h[2].startswith("fembench.")]
        by = defaultdict(int)
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            by[self._open_at(e0, starts, outer)] += s1 - e0
        rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
        return [[n, v / 1e9] for n, v in rows]

    def _open_at(self, t, starts, outer):
        """The innermost host range open at ``t`` among the nearest 2,000
        that began before it, else the benchmark's own range around it."""
        i = bisect.bisect_right(starts, t)
        for j in range(i - 1, max(-1, i - 2000), -1):
            s, e, n = self.host[j]
            if e >= t:
                return n
        for s, e, n in outer:
            if s <= t <= e:
                return n
        return "(no host range)"
