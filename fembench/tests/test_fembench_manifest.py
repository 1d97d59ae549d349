"""BENCHMARK.json keeps the contract, and the harness finds every piece
of a cell by name: configurations, mixes, metric readers, kernel tables
and limits.  A new configuration, mix and metric are new files plus new
entries, picked up with no edit to any file already there."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from fembench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP = ["command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"]


def line_ok(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units():
    assert list(BENCH) == TOP
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"])
        assert line_ok(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("fembench/")
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert line_ok(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    cells = {w["name"] for w in BENCH["workloads"]}
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(cells) == len(BENCH["workloads"])
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= cells
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and line_ok(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_what_it_must():
    for w in BENCH["workloads"]:
        e2e = harness.cell_metrics(BENCH, w, "end_to_end")
        layer = harness.cell_metrics(BENCH, w, "per_layer")
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer
        for m in layer:      # what a per-layer metric moves, the cell reports
            assert m["moves"] in names


def test_check_budget_fits():
    n = 24   # the most cells a later benchmark may have
    total = (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert 1 <= BENCH["run_seconds"] <= 51 and total <= 43200


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_every_piece_is_found_by_name(w):
    cfg = harness.load_config(BENCH, w["config"])
    assert cfg["name"] == w["config"]
    entry = harness.load_entry(harness.load_mix(w["traffic"])["entry"])
    assert all(callable(getattr(entry, f, None))
               for f in ("build", "run", "judge", "calibrate"))
    lim = json.loads((ROOT / "fembench" / "limits" /
                      f"{w['name']}.json").read_text())
    assert lim and all(v["limit"] is not None for v in lim.values())
    for m in harness.cell_metrics(BENCH, w, "per_layer"):
        r = harness.load_reader(m["name"])
        assert (r.LAYER, r.UNIT, r.SOURCE, r.MOVES) == (
            m["layer"], m["unit"], m["source"], m["moves"])
        if hasattr(r, "TABLE"):
            t = harness.load_table(r.TABLE)
            assert t["kernels"] and t["layer"] == m["layer"]


NEW_ENTRY = '''"""A kind of entry new to the harness: the solve loop, marked."""
from fembench.entries import solves
from fembench.entries.solves import build, calibrate, judge  # noqa: F401


def run(*args):
    out = solves.run(*args)
    out["counters"]["kind"] = "pairs"
    return out
'''


def test_a_new_config_mix_entry_and_metric_need_no_edit(tmp_path):
    """Copy the benchmark, add one configuration, one mix, one entry
    module and one metric as new files and entries, and run the new cell
    on the CPU."""
    shutil.copytree(ROOT / "fembench", tmp_path / "fembench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    fb = tmp_path / "fembench"
    cfg = json.loads((fb / "configs" / "cantilever2d.json").read_text())
    cfg.update(name="narrow2d", grid=[33, 9], lengths=[4.0, 1.0])
    (fb / "configs" / "narrow2d.json").write_text(json.dumps(cfg))
    mix = json.loads((fb / "traffic" / "solves.json").read_text())
    mix.update(designs=2, sample=1, entry="pairs")
    (fb / "traffic" / "pairs.json").write_text(json.dumps(mix))
    (fb / "entries" / "pairs.py").write_text(NEW_ENTRY)
    (fb / "metrics" / "solves_done.pairs.py").write_text(
        'LAYER = "model entry"\nUNIT = "solves"\n'
        'SOURCE = "program_counter"\nMOVES = "solve_ms"\n\n\n'
        'def read(ctx):\n    if ctx.counters.get("kind") == "pairs":\n'
        '        return len(ctx.counters["iters"])\n')
    (fb / "limits" / "narrow2d.pairs.json").write_text(
        json.dumps({"resid": {"limit": 1e-2}, "fixed": {"limit": 0.0}}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(name="narrow2d", source="https://x.org/a",
                                 file="fembench/configs/narrow2d.json",
                                 reduced=[], why="a narrow strip"))
    bench["workloads"].append(dict(name="narrow2d.pairs", config="narrow2d",
                                   traffic="pairs", chips=1, why="two"))
    for m in bench["end_to_end"]:
        if "workloads" in m and "block3d.solves" in m["workloads"]:
            m["workloads"].append("narrow2d.pairs")
    bench["per_layer"].append(dict(
        name="solves_done.pairs", unit="solves", better="higher",
        source="program_counter", layer="model entry", moves="solve_ms",
        workloads=["narrow2d.pairs"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, sys, torch\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "from fembench import harness\n"
        "assert harness.HERE.parent == __import__('pathlib').Path("
        f"{str(tmp_path)!r})\n"
        "b = harness.load_benchmark(harness.ROOT)\n"
        "for t in (0, 1):\n"
        "    r = harness.run_cell(b, 'narrow2d.pairs', 5, 0.3, t,\n"
        "                         torch.device('cpu'), 0.0)\n"
        "    print(json.dumps(r))\n")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=tmp_path)
    assert p.returncode == 0, p.stderr[-3000:]
    e2e, layer = (json.loads(s) for s in p.stdout.strip().splitlines()[-2:])
    assert e2e["correct"] and "solve_ms" in e2e["metrics"]
    assert layer["metrics"]["solves_done.pairs"]["value"] >= 1
