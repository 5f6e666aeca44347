"""Everything the harness finds by name: the cell in ``BENCHMARK.json``,
its configuration file, the configuration's family and plain reference,
its traffic mix, its correctness limits and the reader of each
per-layer metric.

Each lives in a file of its own, so a later cell, mix, metric or
configuration of a new family is new files plus new entries in
``BENCHMARK.json``:

    perfbench/configs/<config>.json    sizes, source and cut; names its
                                       ``family`` and ``reference``
    perfbench/families/<family>.py     the port's config, parameters,
                                       seeded weights and work counts of
                                       one family (:data:`FAMILY_HOOKS`)
    perfbench/reference/<name>.py      the plain reference of the check
    perfbench/traffic/<mix>.json       parameters of the one generator
    perfbench/limits/<cell>.json       limits of the correctness check
    perfbench/metrics/<metric>.py      ``read(ctx)`` -> a number or None
"""
from __future__ import annotations

import functools
import importlib.util
import json
import pathlib
import types
from typing import Any, Callable, Dict, List, Optional

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

#: what a family file defines: ``port_config(doc)``, ``port_params(doc,
#: seed, dtype, device)``, ``layer(doc, seed, i, dtype, device)``,
#: ``outer(doc, seed, dtype, device)``, ``pass_gemms(doc, rows, head)``,
#: ``matmul_params(doc)`` and ``train_step_gemms(doc, batch, seq)``
FAMILY_HOOKS = ("port_config", "port_params", "layer", "outer",
                "pass_gemms", "matmul_params", "train_step_gemms")


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


def _module(path: pathlib.Path, prefix: str, name: str) -> types.ModuleType:
    """The Python file at ``path``, loaded as a module of its own."""
    mod_name = prefix + "".join(ch if ch.isalnum() else "_" for ch in name)
    s = importlib.util.spec_from_file_location(mod_name, path)
    if s is None or s.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    return mod


def reader(name: str, here: pathlib.Path = HERE) -> Callable:
    """``read(ctx)`` of ``perfbench/metrics/<name>.py``."""
    return _module(here / "metrics" / f"{name}.py", "perfbench_metric_",
                   name).read


@functools.lru_cache(maxsize=None)
def family(name: str, here: pathlib.Path = HERE) -> types.ModuleType:
    """``perfbench/families/<name>.py``, loaded once a process: what
    depends on a configuration's structure (:data:`FAMILY_HOOKS`)."""
    path = here / "families" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"configuration family {name!r}: no file "
                                f"{path}")
    mod = _module(path, "perfbench_family_", name)
    missing = [h for h in FAMILY_HOOKS if not callable(getattr(mod, h, None))]
    if missing:
        raise AttributeError(f"configuration family {name!r} ({path}) "
                             f"lacks {missing}")
    return mod


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
