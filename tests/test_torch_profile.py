"""PyTorch port: the call-graph profiler (``utils.profile``) on CPU.

Gates: nested ``time_this`` calls log paired, indented call/return lines
and drop pairs under the threshold (to stdout or to the log file), as
the JAX profiler does on the same call graph; ``saved_times`` keeps each
kept function's readings; each timed call opens a
``torch.profiler.record_function`` range of its name, seen in a CPU
trace, and ``trace`` writes a Chrome trace; with the timer off a
wrapped function runs unlogged; the package exports the timers.
"""

import json
import time

import pytest

import torch_threads  # noqa: F401  (one torch thread per worker)
import pyfem_gpu_testflight_tpu.utils.profile as jprof
import pyfem_gpu_testflight_tpu_torch as pt
from pyfem_gpu_testflight_tpu_torch import compat
from pyfem_gpu_testflight_tpu_torch.utils import profile as prof


@pytest.fixture
def profiler(tmp_path, monkeypatch):
    """Both packages' process-global profiler state, restored after."""
    for P in (prof.Profiler, jprof.Profiler):
        monkeypatch.setattr(P, "timer_is_on", False)
        monkeypatch.setattr(P, "print_to_stdout", False)
        monkeypatch.setattr(P, "t_min", 1.0)
        monkeypatch.setattr(P, "buffer", [])
        monkeypatch.setattr(P, "counter", 0)
        monkeypatch.setattr(P, "log_name", str(tmp_path / "profiler.log"))
        monkeypatch.setattr(P, "old_log_removed", False)
    # saved_times is aliased at module level: empty it in place
    saved = {P: dict(P.saved_times) for P in (prof.Profiler, jprof.Profiler)}
    for P in saved:
        P.saved_times.clear()
    yield prof.Profiler
    for P, old in saved.items():
        P.saved_times.clear()
        P.saved_times.update(old)


def _graph(mod):
    """outer (>= 5 ms) -> inner (>= 5 ms) and quick (~0 ms)."""
    @mod.time_this
    def inner():
        time.sleep(0.005)

    @mod.time_this
    def quick():
        return 1

    @mod.time_this
    def outer():
        inner()
        quick()
        return 3

    return outer


def _shape(line):
    """A log line without its time: indent, name, call/return."""
    return line.split("(")[0].rstrip() + ("()" if "()" in line else "")


def test_pairing_threshold_and_saved_times(profiler, capsys):
    for mod in (prof, jprof):
        mod.timer_on()
        mod.timer_to_stdout()
        mod.timer_set_threshold(2.0)
        assert _graph(mod)() == 3
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 8  # 4 lines of each package
    got, ref = out[:4], out[4:]
    assert [_shape(s) for s in got] == [_shape(s) for s in ref]
    assert "outer() called" in got[0] and "inner() called" in got[1]
    assert got[1].startswith("[timer]     ")  # one indent level
    assert "inner() return" in got[2] and "outer() return" in got[3]
    assert not any("quick" in s for s in got)  # under the threshold
    st = prof.saved_times
    assert sorted(k.rsplit(".", 1)[1] for k in st) == ["inner", "outer"]
    assert all(len(v) == 1 and v[0] >= 5.0 for v in st.values())


def test_log_file_and_timer_off(profiler, tmp_path):
    prof.timer_set_threshold(0.0)
    outer = _graph(prof)
    assert outer() == 3  # timer off: nothing logged or kept
    assert prof.Profiler.buffer == [] and prof.saved_times == {}
    prof.timer_on()
    outer()
    lines = (tmp_path / "profiler.log").read_text().splitlines()
    assert len(lines) == 6  # three pairs, none under a 0 ms threshold
    assert sum("return" in s for s in lines) == 3
    assert len(prof.saved_times) == 3


def test_record_function_ranges_in_trace(profiler, tmp_path):
    prof.timer_on()
    prof.timer_set_threshold(1e9)  # log nothing, still open the ranges
    outer = _graph(prof)
    with prof.trace(str(tmp_path / "trace")) as p:
        outer()
    keys = {e.key for e in p.key_averages()}
    assert any(k.endswith("outer") for k in keys)
    assert any(k.endswith("inner") for k in keys)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    assert any(n.endswith("quick") for n in names)


def test_timer_exports():
    for name in ("time_this", "timer_on", "timer_off", "timer_to_stdout",
                 "timer_set_threshold"):
        assert getattr(pt, name) is getattr(prof, name)
        assert name in pt.__all__
    assert prof.saved_times is prof.Profiler.saved_times
    assert compat.time_this is prof.time_this
    assert set(prof.__all__) == set(jprof.__all__)
