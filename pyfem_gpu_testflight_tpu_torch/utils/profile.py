"""Call-graph profiler + PyTorch tracing hooks.

Port of ``pyfem_gpu_testflight_tpu/utils/profile.py``.  API parity with
the reference profiler (utils.py:9-151): the ``@time_this`` decorator,
``timer_on/timer_off/timer_to_stdout/timer_set_threshold`` switches, the
indent-paired call/return log filtered by a millisecond threshold, and
the ``saved_times`` dict consumed by the performance studies.

Device additions: each timed region also opens a
``torch.profiler.record_function`` range of the function's name, so the
regions show up in ``torch.profiler`` traces, and ``trace`` wraps
``torch.profiler.profile`` (CPU and, where there is a card, CUDA
activities) and writes a Chrome trace.  While the timer is on, a timed
call synchronizes the CUDA card on entry and on exit, so its reading is
the card's work and not an asynchronous launch; while it is off the
wrapper calls the function directly and synchronizes nothing.
"""

from __future__ import annotations

import contextlib
import functools
import os
from time import perf_counter_ns

import torch

__all__ = [
    "Profiler",
    "time_this",
    "timer_on",
    "timer_off",
    "timer_to_stdout",
    "timer_set_threshold",
    "saved_times",
    "trace",
]


def _sync():
    """Wait for the CUDA card's queued work (nothing without a card)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Profiler:
    """Process-global profiler state (mirrors reference MyProfiler)."""

    counter = 0
    timer_is_on = False  # off by default; enable explicitly like reference examples
    print_to_stdout = False
    buffer: list = []
    t_min = 1.0  # ms
    log_name = "profiler.log"
    old_log_removed = False
    saved_times: dict[str, list[float]] = {}

    @staticmethod
    def timer_set_threshold(t: float):
        Profiler.t_min = t

    @staticmethod
    def timer_to_stdout():
        Profiler.print_to_stdout = True

    @staticmethod
    def timer_on():
        Profiler.timer_is_on = True

    @staticmethod
    def timer_off():
        Profiler.timer_is_on = False

    @staticmethod
    def _flush():
        """Pair call/return entries, filter by threshold, emit."""
        pairs = {}
        stack = []
        for idx, entry in enumerate(Profiler.buffer):
            if entry["type"] == "(":
                stack.append(idx)
            else:
                if not stack:
                    continue
                start = stack.pop()
                if entry["t"] > Profiler.t_min:
                    pairs[start] = idx
        keep = sorted(list(pairs.keys()) + list(pairs.values()))
        kept = [Profiler.buffer[i] for i in keep]
        if Profiler.print_to_stdout:
            for entry in kept:
                print(entry["msg"])
        elif kept:
            if os.path.exists(Profiler.log_name) and not Profiler.old_log_removed:
                os.remove(Profiler.log_name)
                Profiler.old_log_removed = True
            with open(Profiler.log_name, "a") as f:
                for entry in kept:
                    f.write(entry["msg"] + "\n")
        for entry in kept:
            if "t" in entry:
                Profiler.saved_times.setdefault(entry["fun_name"], []).append(
                    entry["t"]
                )
        Profiler.buffer = []

    @staticmethod
    def time_this(func):
        """Decorator: time a function and tag it in device traces."""
        name = func.__qualname__
        tab = "    "

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            if not Profiler.timer_is_on:
                return func(*args, **kwargs)
            Profiler.buffer.append(
                {"msg": f"[timer] {tab * Profiler.counter}{name}() called", "type": "("}
            )
            Profiler.counter += 1
            _sync()
            t0 = perf_counter_ns()
            with torch.profiler.record_function(name):
                ret = func(*args, **kwargs)
            _sync()
            t1 = perf_counter_ns()
            Profiler.counter -= 1
            t_ms = (t1 - t0) / 1e6
            info = f"{tab * Profiler.counter}{name}() return"
            Profiler.buffer.append(
                {
                    "msg": f"[timer] {info:<80s} ({t_ms:.2f} ms)",
                    "type": ")",
                    "fun_name": name,
                    "t": t_ms,
                }
            )
            if Profiler.counter == 0:
                Profiler._flush()
            return ret

        return wrapper


time_this = Profiler.time_this
timer_on = Profiler.timer_on
timer_off = Profiler.timer_off
timer_to_stdout = Profiler.timer_to_stdout
timer_set_threshold = Profiler.timer_set_threshold
saved_times = Profiler.saved_times


@contextlib.contextmanager
def trace(log_dir="torch-trace"):
    """``torch.profiler`` trace of the enclosed work, written as a Chrome
    trace (``trace.json``) into ``log_dir``; yields the profiler, whose
    ``key_averages()`` sums the ranges and kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
