"""A training cell: the port's train step (``train.loop.make_train_step``)
at the mix's batch, under the ``auto`` policy with the non-GEMM kernels
on the library (they have no backward), as the port's trainer runs it.

Set-up builds one train state from the seed (f32 master weights drawn on
the device, zero AdamW moments), and drives it through its first
``check_steps`` steps with the step the window uses, on batches whose
rows all differ; those steps are its warm-up too.  It keeps what the
check compares: each step's loss, each leaf's norm of the first
gradient as AdamW received it (its first moment after one step over
1 - b1) and each leaf's norm of its change over those steps (against
the seeded weights drawn again).  The same state then trains on for
the window, every step ending in a synchronize (its loss read back).

The plain reference then takes those first steps again from the seed,
in f32, and the check holds the program's numbers against it.  With
``control`` the reference's own steps in fp8 stand in the program's
place, and the check judges theirs.
"""
from __future__ import annotations

import gc
import importlib
import math
import statistics
import time
from typing import Any, Dict

import torch

from perfbench import gen, program, weights
from perfbench import trace as tr


def _seeded_leaves(doc, seed: int, device):
    """(name, the seeded f32 weight) of every leaf, one layer at a time."""
    for k, v in weights.outer(doc, seed, torch.float32, device).items():
        yield k, v
    for i in range(doc["n_layers"]):
        for k, v in weights.layer(doc, seed, i, torch.float32,
                                  device).items():
            yield f"blocks.{i}.{k}", v


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               keep=None) -> float:
    """The worst leaf's gap of norms, |prog - ref| over the larger of the
    reference's norm of that leaf and of the median leaf."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in names)


def compare(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The three numbers the check compares.  Leaves whose reference
    gradient is under a thousandth of the median leaf's move by
    round-off alone and are left out of the change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["loss"],
                                                   ref["loss"]))
    med = statistics.median(ref["grad1"].values())
    moved = {k for k, g in ref["grad1"].items() if g >= 1e-3 * med}
    return {"loss_gap": loss,
            "grad_gap": worst_leaf(prog["grad1"], ref["grad1"]),
            "change_gap": worst_leaf(prog["change"], ref["change"], moved)}


def run(doc: Dict[str, Any], mix: Dict[str, Any], limits: Dict[str, float],
        seed: int, seconds: float, trace: bool, device="cuda",
        control: bool = False, on_window=None) -> Dict[str, Any]:
    from repro_torch import api
    from repro_torch.models import registry
    from repro_torch.train import loop, optimizer
    cuda = torch.device(device).type == "cuda"
    cfg = program.port_config(doc)
    model = registry.build(cfg)
    be = api.install(api.named_policy("auto").replace(kernels="library"))
    if cuda:
        from repro_torch.kernels import build
        build.load()
    params = program.port_params(doc, seed, torch.float32, device)
    state = {"params": params, "opt": optimizer.init_opt_state(params),
             "step": 0}
    oc = optimizer.OptConfig(**mix["optimizer"])
    step_fn = loop.make_train_step(
        model, loop.TrainConfig(opt=oc, z_loss=mix["z_loss"]), be)
    V = doc["vocab"]

    def batch(j):
        return {"tokens": gen.train_batch(mix, seed, j, V, device)}

    prog: Dict[str, Any] = {"loss": []}
    for j in range(mix["check_steps"]):
        state, met = step_fn(state, batch(j))
        prog["loss"].append(float(met["loss"]))
        if j == 0:
            prog["grad1"] = {k: float(m.norm()) / (1.0 - oc.b1) for k, m in
                             state["opt"]["m"].named_parameters()}
    now = dict(state["params"].named_parameters())
    with torch.no_grad():
        prog["change"] = {k: float((now[k] - w).norm())
                          for k, w in _seeded_leaves(doc, seed, device)}
    del now
    from repro_torch import obs
    r0 = obs.ROUTES.kernel_share()
    if on_window is not None:
        on_window()

    t0 = time.perf_counter()
    steps, j, sl, losses = 0, mix["check_steps"], None, []
    while time.perf_counter() - t0 < seconds:
        if trace and sl is None and time.perf_counter() - t0 >= seconds / 2:
            sl = tr.Slice(doc["name"], cuda=cuda)
            with sl:
                for _ in range(mix["trace_steps"]):
                    with torch.profiler.record_function("perfbench.step"):
                        state, met = step_fn(state, batch(j))
                        losses.append(float(met["loss"]))
                    j, steps = j + 1, steps + 1
            continue
        state, met = step_fn(state, batch(j))
        losses.append(float(met["loss"]))
        j, steps = j + 1, steps + 1
    t1 = time.perf_counter()
    r1 = obs.ROUTES.kernel_share()
    win = t1 - t0
    tokens = steps * mix["batch"] * mix["seq"]
    failed = sum(1 for x in losses if not math.isfinite(x))
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = {"kind": "train", "doc": doc, "mix": mix, "window_s": win,
           "steps": steps, "tokens": tokens,
           "slice_steps": mix["trace_steps"] if sl is not None else 0,
           "counters": {"routes_kernel": r1[0] - r0[0],
                        "routes_all": r1[1] - r0[1]},
           "slice": sl.data if sl is not None else None}
    del state, params, step_fn, model
    gc.collect()
    program.free_cuda()

    batches = [gen.train_batch(mix, seed, j, V, device)
               for j in range(mix["check_steps"])]
    reference = importlib.import_module(
        f"perfbench.reference.{doc['reference']}")
    ref = reference.train_steps(doc, seed, batches, mix["optimizer"],
                                mix["z_loss"], device)
    gaps = judged = compare(prog, ref)
    if control:
        # the reference in fp8 stands in the program's place
        low = reference.train_steps(doc, seed, batches, mix["optimizer"],
                                    mix["z_loss"], device, num="fp8")
        judged = compare(low, ref)
    checks = [(k, judged[k], limits[k]) for k in ("loss_gap", "grad_gap",
                                                  "change_gap")]
    checks.append(("failed", float(failed), 0.0))
    return {"correct": all(v <= lim for _, v, lim in checks),
            "attempted": steps, "failed": failed,
            "e2e": {"train_tok_s": tokens / win}, "ctx": ctx,
            "checks": checks, "memory_peak_bytes": peak, "gaps": gaps,
            "control": judged if control else None}
