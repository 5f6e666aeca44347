"""One run of one cell: find it by name, run it as its mix's kind says
(``perfbench/serve.py`` or ``perfbench/train.py``), and print the
result's line.

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, each read by its own reader
(``perfbench/metrics/<name>.py``) from the run's counters, spans and
traced slice.  ``setup_s`` runs from the process's start to the
window's opening.  Each number the correctness check compared is
printed beside its limit, last on standard error and last in the line.
"""
from __future__ import annotations

import json
import math
import sys
import time
from typing import Any, Dict

#: top-level modules that must not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def unit_of(bench, name: str) -> str:
    for kind in ("end_to_end", "per_layer"):
        for m in bench[kind]:
            if m["name"] == name:
                return m["unit"]
    raise KeyError(name)


def result_line(bench, cell, res: Dict[str, Any], trace: bool,
                setup_s: float) -> Dict[str, Any]:
    from perfbench import spec, trace as tr
    import torch
    name = cell["name"]
    if trace:
        vals = spec.read_metrics(bench, name, res["ctx"])
    else:
        vals = dict(res["e2e"])
        vals["setup_s"] = setup_s
        wanted = [m["name"] for m in spec.metrics_of(bench, "end_to_end",
                                                     name)]
        vals = {k: vals[k] for k in wanted if vals.get(k) is not None}
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": cell["chips"], "memory_peak_bytes":
           int(res["memory_peak_bytes"])}
    line = {"correct": bool(res["correct"]),
            "attempted": int(res["attempted"]),
            "failed": int(res["failed"]),
            "metrics": {k: {"value": v, "unit": unit_of(bench, k)}
                        for k, v in vals.items()},
            "device": dev}
    data = res["ctx"].get("slice")
    if trace and data is not None:
        dev["busy_s"] = tr.busy_s(data)
        dev["window_s"] = tr.window_s(data)
        line["breakdown"] = tr.breakdown(data)
    # a number that could not be read (no request finished) prints null
    line["checks"] = {k: {"value": v if math.isfinite(v) else None,
                          "limit": lim} for k, v, lim in res["checks"]}
    return line


def main(args, t_start: float) -> int:
    import torch
    from perfbench import spec
    bench = spec.load_benchmark()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"perfbench: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              ": no result", file=sys.stderr)
        return 2
    doc = spec.config(bench, cell["config"])
    mix = spec.traffic(cell["traffic"])
    limits = spec.limits(cell["name"])
    if mix["kind"] == "serve":
        from perfbench import serve as kind
    elif mix["kind"] == "train":
        from perfbench import train as kind
    else:
        raise ValueError(f"mix kind {mix['kind']!r}: serve or train")
    # load from one process with few threads: the host paces the serving
    # cells, and idle intra-op threads only add to its noise
    torch.set_num_threads(2)
    torch.cuda.reset_peak_memory_stats()
    marks = {}

    def window_opens():
        marks["setup_s"] = time.perf_counter() - t_start
    res = kind.run(doc, mix, limits, args.seed, args.seconds,
                   bool(args.trace), device="cuda", on_window=window_opens)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules loaded that must not be: {bad}: "
              "no result", file=sys.stderr)
        return 3
    line = result_line(bench, cell, res, bool(args.trace), marks["setup_s"])
    for k, v in res.get("notes", {}).items():
        print(f"note {k} {v!r}", file=sys.stderr)
    for k, v, lim in res["checks"]:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0
