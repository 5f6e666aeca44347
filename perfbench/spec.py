"""Everything the harness finds by name: the cell in ``BENCHMARK.json``,
its configuration file, its traffic mix, its correctness limits and the
reader of each per-layer metric.

Each lives in a file of its own, so a later cell, mix or metric is new
files plus new entries in ``BENCHMARK.json``:

    perfbench/configs/<config>.json   sizes, source and cut
    perfbench/traffic/<mix>.json      parameters of the one generator
    perfbench/limits/<cell>.json      limits of the correctness check
    perfbench/metrics/<metric>.py     ``read(ctx)`` -> a number or None
"""
from __future__ import annotations

import importlib.util
import json
import pathlib
from typing import Any, Callable, Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: pathlib.Path = ROOT) -> Dict[str, Any]:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: Dict[str, Any], name: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: Dict[str, Any], name: str,
           root: pathlib.Path = ROOT) -> Dict[str, Any]:
    for c in bench["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, here: pathlib.Path = HERE) -> Dict[str, Any]:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def limits(workload: str, here: pathlib.Path = HERE) -> Dict[str, float]:
    return json.loads((here / "limits" / f"{workload}.json").read_text())


def metrics_of(bench: Dict[str, Any], kind: str,
               workload: str) -> List[Dict[str, Any]]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``workload``
    reports: those that list it, and those without a ``workloads`` key."""
    return [m for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def reader(name: str, here: pathlib.Path = HERE) -> Callable:
    """``read(ctx)`` of ``perfbench/metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    mod_name = "perfbench_metric_" + "".join(
        ch if ch.isalnum() else "_" for ch in name)
    s = importlib.util.spec_from_file_location(mod_name, path)
    if s is None or s.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod.read


def read_metrics(bench: Dict[str, Any], workload: str,
                 ctx: Dict[str, Any]) -> Dict[str, Optional[float]]:
    """Every per-layer metric of ``workload`` that finds something to read
    in ``ctx``; a reader that returns None leaves its metric out."""
    out = {}
    for m in metrics_of(bench, "per_layer", workload):
        v = reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = float(v)
    return out
