"""A traced slice of steady steps: ``torch.profiler`` over the CPU and
the card, read back from its Chrome trace into plain lists, and the
reductions the per-layer readers share.

The harness's own spans (``record_function``) name what the host was
doing: ``perfbench.slice`` around the whole slice (which ends in a
synchronize, so every kernel of the slice lies inside it),
``perfbench.step`` around each step, and ``perfbench.decode`` /
``perfbench.prefill`` around each model call of a serving engine.
Each kernel carries the CPU op that launched it (the innermost one, by
the trace's external id) and that op's input dims, so a GEMM is known
by what it computes, not only by its kernel's name.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import torch

from perfbench import spec

TRACE_DIR = spec.ROOT / "build" / "perfbench"
#: device events that count as the device being busy
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_DENSE_OPS = ("aten::mm", "aten::addmm")


class Slice:
    """``with Slice() as s: ...`` profiles the body; ``s.data`` is then
    {"t0", "t1" (us), "kernels": [{name, ts, dur, op, dims}], "spans":
    [(name, ts, end)]}."""

    def __init__(self, name: str = "trace", cuda: bool = True):
        self.path = TRACE_DIR / f"{name}.json"
        self.cuda = cuda
        self.data: Optional[Dict[str, Any]] = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts,
                                           record_shapes=True)
        self.prof.__enter__()
        self.ann = torch.profiler.record_function("perfbench.slice")
        self.ann.__enter__()
        return self

    def __exit__(self, *exc):
        if self.cuda:
            torch.cuda.synchronize()
        self.ann.__exit__(*exc)
        self.prof.__exit__(*exc)
        if exc[0] is None:
            TRACE_DIR.mkdir(parents=True, exist_ok=True)
            self.prof.export_chrome_trace(str(self.path))
            try:
                self.data = parse(json.loads(self.path.read_text()))
            finally:
                os.remove(self.path)
        return False


def parse(doc: Dict[str, Any]) -> Dict[str, Any]:
    evs = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    ops = {}
    for e in evs:
        if e.get("cat") == "cpu_op":
            xid = e.get("args", {}).get("External id")
            if xid is not None:
                ops[xid] = (e["name"], e["args"].get("Input Dims"))
    kernels, spans = [], []
    t0 = t1 = None
    for e in evs:
        cat = e.get("cat")
        if cat in _DEVICE_CATS:
            op, dims = ops.get(e.get("args", {}).get("External id"),
                               (None, None))
            kernels.append({"name": e["name"], "ts": float(e["ts"]),
                            "dur": float(e.get("dur", 0.0)), "cat": cat,
                            "op": op, "dims": dims})
        elif cat == "user_annotation" and e["name"].startswith("perfbench."):
            ts, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
            spans.append((e["name"], ts, end))
            if e["name"] == "perfbench.slice":
                t0, t1 = ts, end
    if t0 is None:
        raise RuntimeError("the trace holds no perfbench.slice span")
    return {"t0": t0, "t1": t1, "kernels": kernels, "spans": spans}


def busy(data) -> List[Tuple[float, float]]:
    """The union of device-op intervals inside the slice, merged (us)."""
    iv = sorted((max(k["ts"], data["t0"]), min(k["ts"] + k["dur"], data["t1"]))
                for k in data["kernels"])
    out: List[List[float]] = []
    for a, b in iv:
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_s(data) -> float:
    return sum(b - a for a, b in busy(data)) * 1e-6


def window_s(data) -> float:
    return (data["t1"] - data["t0"]) * 1e-6


def _host_label(data, t: float) -> str:
    """The innermost harness span open on the host at ``t``."""
    best = None
    for name, a, b in data["spans"]:
        if a <= t < b and (best is None or a >= best[1]):
            best = (name, a)
    return best[0] if best else "outside"


def breakdown(data, top: int = 10) -> Dict[str, List[List[Any]]]:
    """The device ops that took the most time (seconds, summed by name),
    and the device's idle time summed by what the host was doing when
    each gap began."""
    by_name: Dict[str, float] = {}
    for k in data["kernels"]:
        by_name[k["name"]] = by_name.get(k["name"], 0.0) + k["dur"] * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps: Dict[str, float] = {}
    t = data["t0"]
    for a, b in busy(data) + [(data["t1"], data["t1"])]:
        if a > t:
            lab = _host_label(data, t)
            gaps[lab] = gaps.get(lab, 0.0) + (a - t) * 1e-6
        t = max(t, b)
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n[:200], s] for n, s in ops],
            "idle_gaps": [[n, s] for n, s in idle]}


def is_iaat(k) -> bool:
    return "iaat_gemm_kernel" in k["name"]


def dense_gemm_s(data) -> float:
    """Device seconds of the dense GEMMs: the IAAT kernel's, and every
    kernel a 2-D matmul op (``aten::mm``/``addmm``) launched."""
    return sum(k["dur"] for k in data["kernels"]
               if is_iaat(k) or k["op"] in _DENSE_OPS) * 1e-6
