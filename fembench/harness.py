"""One run of one cell: set-up, the measured window, the traced segment,
the check against the reference, and the result line.

Everything a cell is made of is found by name from ``BENCHMARK.json``:
the configuration's file (its ``file`` entry), the mix
(``traffic/<traffic>.json``), the entry module the mix names
(``entries/<entry>.py``: the build, the timed call and the judge of its
kind), each per-layer metric's reader (``metrics/<name>.py``), the
kernel tables the readers name (``kernels/<table>.json``) and the cell's
limits (``limits/<cell>.json``).  Adding a configuration, a mix, a kind
of entry or a metric is adding files and entries; nothing here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

from . import check, work

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pyfem_gpu_testflight_tpu")


# -- finding the pieces by name ---------------------------------------------------


def load_benchmark(root=ROOT):
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_config(bench, name, root=ROOT):
    entry = by_name(bench["configs"], name, "configuration")
    return json.loads((Path(root) / entry["file"]).read_text())


def load_mix(name):
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def load_table(name):
    return json.loads((HERE / "kernels" / f"{name}.json").read_text())


def load_entry(name):
    """The entry module a mix names: ``entries/<name>.py``."""
    return importlib.import_module(f"{__package__}.entries.{name}")


def load_reader(name):
    """The reader module of per-layer metric ``name``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "fembench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench, cell, kind):
    """The cell's metrics of ``kind`` ("end_to_end" or "per_layer"): those
    whose ``workloads`` list names it, or that have no such list."""
    return [m for m in bench[kind]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark must not load,
    each compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


class Context:
    """What a per-layer reader reads: the configuration, the mix, the
    counters of the window and of the traced segment, the segment's
    device trace, the kernel tables and the yardstick (``work``)."""

    def __init__(self, cfg, mix, counters, seg):
        self.cfg, self.mix, self.counters, self.seg = cfg, mix, counters, seg
        self.work = work

    def table(self, name):
        return load_table(name)

    def kernel_seconds(self, table):
        """Device seconds of the kernels a table assigns to its layer;
        None where the trace holds none of them."""
        s = self.seg.seconds_of(load_table(table)["kernels"])
        return s if s > 0 else None


# -- the run ------------------------------------------------------------------------------


def device_info(device, peak, count):
    if torch.device(device).type == "cuda":
        kind = torch.cuda.get_device_name(device)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": count,
            "memory_peak_bytes": peak}


def run_cell(bench, cell_name, seed, seconds, trace, device, t0,
             config_override=None, root=ROOT):
    """Run one cell once and return its result object (the contract's
    keys, then ``checks``: each compared number beside its limit)."""
    cell = by_name(bench["workloads"], cell_name, "workload")
    cfg = load_config(bench, cell["config"], root)
    cfg.update(config_override or {})
    mix = load_mix(cell["traffic"])
    limits = check.load_limits(cell_name)
    out = load_entry(mix["entry"]).run(cfg, mix, seed, seconds, trace,
                                       device, t0, list(limits))
    metrics = {}
    if trace:
        ctx = Context(cfg, mix, out["counters"], out["seg"])
        for m in cell_metrics(bench, cell, "per_layer"):
            v = load_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in cell_metrics(bench, cell, "end_to_end"):
            v, unit = out["e2e"][m["name"]]
            metrics[m["name"]] = {"value": float(v), "unit": unit}
    ok, rows = check.judge(out["numbers"], limits)
    result = {
        "correct": bool(ok and not out["failed"]),
        "attempted": int(out["attempted"]),
        "failed": len(out["failed"]),
        "metrics": metrics,
        "device": device_info(device, out["peak"], cell["chips"]),
    }
    seg = out["seg"]
    if trace and seg is not None:
        result["device"].update(busy_s=seg.busy_s, window_s=seg.window_s)
        result["breakdown"] = {"device_ops": seg.device_ops(),
                               "idle_gaps": seg.idle_gaps()}
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in rows}
    for msg in out["failed"][:5]:
        print("fembench: failed:", msg, file=sys.stderr)
    return result
