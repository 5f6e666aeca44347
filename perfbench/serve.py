"""A serving cell: the port's ``PagedEngine`` under a mix of clients.

Set-up builds the model from its configuration file, draws the weights
from the seed on the device, installs the ``auto`` policy (no online
tuner) and starts the engine with what a deployment sizes (``slots``,
``max_len``, ``eos=-1`` so that every request yields its drawn length);
every scheduler setting is the engine's default.  Warm-up is the loop
itself, run until each client has finished one request: every shape the
window uses (one decode step over all slots, one prefill chunk) has run
by then, and the loop is at its steady state when the window opens.

The window drives ``PagedEngine.submit`` / ``step`` for the cell's
seconds; the clients stamp, on the host's clock after each step, when
each request was sent, when its first token and each later token
reached them (the engine hands tokens over as it drains them) and when
it finished.  Every end-to-end number comes from those stamps.

Then, with the engine freed, the plain reference runs once over a sample
of the requests finished in the window, drawn from the seed with the
longest among them, and reads how far each served token's logit lies
below the reference's best at its position.  With ``control`` the
reference in fp8 stands in the program's place: the check judges the
gap of the token it puts first at each of those positions.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from perfbench import gen, program
from perfbench import trace as tr


@dataclasses.dataclass
class Rec:
    """One request as its client sees it."""
    rid: int
    client: int
    prompt: np.ndarray
    n: int
    t_send: float
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    seen: int = 0
    out: Optional[List[int]] = None


def p95(xs: List[float]) -> float:
    """The 95th percentile by nearest rank."""
    s = sorted(xs)
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


class Clients:
    """The traffic's clients around one engine."""

    def __init__(self, engine, traffic: gen.ServeTraffic, request_cls):
        self.engine, self.traffic, self.Request = engine, traffic, request_cls
        self.inflight: Dict[int, Rec] = {}
        self.finished: List[Rec] = []
        self.sent = 0
        self.counting = False          # the window is open
        self.tokens_in_window = 0

    def send(self, client: int, t: float) -> None:
        prompt, n = self.traffic.request(self.sent)
        rec = Rec(self.sent, client, prompt, n, t)
        self.engine.submit(self.Request(rid=rec.rid, prompt=prompt,
                                        max_new=n))
        self.inflight[rec.rid] = rec
        self.sent += 1

    def start(self) -> None:
        now = time.perf_counter()
        for c in range(self.traffic.clients):
            self.send(c, now)

    def _tokens(self, rid: int):
        seq = self.engine.scheduler.live.get(rid)
        if seq is not None:
            return seq.out
        return self.engine.done.get(rid, ())

    def poll(self, now: float) -> List[Rec]:
        """Stamp what reached the clients by ``now``; a client sends its
        next request as its last one finishes."""
        done = []
        for rid, rec in list(self.inflight.items()):
            out = self._tokens(rid)
            new = len(out) - rec.seen
            if new > 0:
                if rec.t_first is None:
                    rec.t_first = now
                if self.counting:
                    self.tokens_in_window += new
                rec.seen = len(out)
            if rid in self.engine.done:
                rec.t_done, rec.out = now, list(self.engine.done[rid])
                del self.inflight[rid]
                self.finished.append(rec)
                done.append(rec)
                self.send(rec.client, now)
        return done


def _wrap(model, log: List[tuple], flags: Dict[str, bool]):
    """The model with the harness's spans around its two serving calls,
    which also keep each call's rows, positions and whether it ran in
    the window or the traced slice (for the work counts)."""
    dec, pre = model.paged_decode, model.paged_prefill

    def paged_decode(params, tokens, ps, tables, pos, active, be):
        with torch.profiler.record_function("perfbench.decode"):
            out = dec(params, tokens, ps, tables, pos, active, be)
        log.append(("decode", pos, active, flags["window"], flags["slice"]))
        return out

    def paged_prefill(params, tokens, ps, tables, pos0, slot, seg_len,
                      n_prompt, be):
        with torch.profiler.record_function("perfbench.prefill"):
            out = pre(params, tokens, ps, tables, pos0, slot, seg_len,
                      n_prompt, be)
        log.append(("prefill", pos0, seg_len, flags["window"],
                    flags["slice"]))
        return out
    return dataclasses.replace(model, paged_decode=paged_decode,
                               paged_prefill=paged_prefill)


def _calls(log: List[tuple], which: int) -> List[np.ndarray]:
    """Positions of the real rows of each logged call (``which``: 3 the
    window, 4 the slice), read back once the calls have run."""
    out = []
    for e in log:
        if not e[which]:
            continue
        if e[0] == "decode":
            pos = e[1].cpu().numpy()
            act = e[2].cpu().numpy().astype(bool)
            out.append(pos[act])
        else:
            p0 = int(e[1].cpu().numpy()[0])
            out.append(p0 + np.arange(int(e[2])))
    return out


def _counters():
    from repro_torch import obs
    from repro_torch.kernels import iaat_gemm
    h = obs.REGISTRY.get("serve.slot_occupancy")
    k, n = obs.ROUTES.kernel_share()
    return {"occupancy_n": h.n if h is not None else 0,
            "occupancy_sum": h.total if h is not None else 0.0,
            "routes_kernel": k, "routes_all": n,
            "iaat_launches": iaat_gemm.launch_count("iaat_gemm")}


def sample(recs: List[Rec], seed: int, check: Dict[str, int]) -> List[Rec]:
    """Finished requests drawn from the seed, the longest first, until
    ``min_served_tokens`` served tokens or ``max_requests`` requests."""
    if not recs:
        return []
    longest = max(recs, key=lambda r: (len(r.out), -r.rid))
    rest = [r for r in recs if r is not longest]
    order = np.random.default_rng([int(seed), 3]).permutation(len(rest))
    out, total = [longest], len(longest.out)
    for i in order:
        if total >= check["min_served_tokens"] or \
                len(out) >= check["max_requests"]:
            break
        out.append(rest[i])
        total += len(rest[i].out)
    return out


def run(doc: Dict[str, Any], mix: Dict[str, Any], limits: Dict[str, float],
        seed: int, seconds: float, trace: bool, device="cuda",
        control: bool = False, on_window=None) -> Dict[str, Any]:
    """One run of a serving cell.  Returns {"correct", "attempted",
    "failed", "e2e", "ctx" (for the per-layer readers), "checks",
    "memory_peak_bytes", "served_tokens", "gaps", "notes" (printed on
    standard error)}."""
    from repro_torch import api
    from repro_torch.models import registry
    from repro_torch.serve.engine import PagedEngine, Request
    cuda = torch.device(device).type == "cuda"
    cfg = program.port_config(doc)
    model = registry.build(cfg)
    be = api.install(api.named_policy("auto"))     # no online tuner
    if cuda:
        from repro_torch.kernels import build
        build.load()
    params = program.port_params(doc, seed, cfg.compute_dtype, device)
    traffic = gen.ServeTraffic(mix, seed, doc["vocab"])
    log: List[tuple] = []
    flags = {"window": False, "slice": False}
    if trace:
        model = _wrap(model, log, flags)
    engine = PagedEngine(model, params, be, slots=mix["slots"],
                         max_len=mix["max_len"], eos=-1, seed=0,
                         device=device)
    clients = Clients(engine, traffic, Request)
    clients.start()

    # warm-up: until every client has finished one request
    done_clients = set()
    while len(done_clients) < traffic.clients:
        engine.step()
        for rec in clients.poll(time.perf_counter()):
            done_clients.add(rec.client)
    if cuda:
        torch.cuda.synchronize()

    # the window
    if on_window is not None:
        on_window()
    c0 = _counters()
    t0 = time.perf_counter()
    clients.counting = flags["window"] = True
    steps, sl, slice_steps = 0, None, 0
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds:
            break
        if trace and sl is None and now - t0 >= seconds / 2:
            sl = tr.Slice(doc["name"], cuda=cuda)
            flags["slice"] = True
            with sl:
                for _ in range(mix["trace_steps"]):
                    with torch.profiler.record_function("perfbench.step"):
                        engine.step()
                        clients.poll(time.perf_counter())
                    slice_steps += 1
            flags["slice"] = False
            steps += slice_steps
            continue
        if engine.step():
            steps += 1
        clients.poll(time.perf_counter())
    t1 = time.perf_counter()
    clients.counting = flags["window"] = False
    c1 = _counters()
    win = t1 - t0

    in_win = [r for r in clients.finished if t0 <= r.t_done <= t1]
    firsts = [r.t_first - r.t_send for r in clients.finished
              + list(clients.inflight.values())
              if r.t_first is not None and t0 <= r.t_first <= t1]
    tpot = [(r.t_done - r.t_first) / (len(r.out) - 1) for r in in_win
            if len(r.out) > 1]
    failed = sum(1 for r in in_win if len(r.out) != r.n)
    attempted = len(in_win) + len(clients.inflight)
    e2e = {"serve_tok_s": clients.tokens_in_window / win}
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    ctx = {"kind": "serve", "doc": doc, "mix": mix, "window_s": win,
           "steps": steps, "slice_steps": slice_steps,
           "tokens": clients.tokens_in_window,
           "requests": len(in_win), "ttft_s": firsts, "tpot_s": tpot,
           "counters": {k: c1[k] - c0[k] for k in c0},
           "window_rows": _calls(log, 3) if trace else None,
           "slice_rows": _calls(log, 4) if trace else None,
           "slice": sl.data if sl is not None else None}

    chosen = sample(in_win, seed, mix["check"])
    served = [(r.prompt, r.out) for r in chosen]
    del engine, params, clients, model, log
    gc.collect()
    program.free_cuda()
    ref = importlib.import_module(f"perfbench.reference.{doc['reference']}")
    gaps = ref.served_gaps(doc, seed, served, device, control=control) \
        if served else {}
    # the control stands in the program's place: its numbers are judged
    judged = {k[len("control_"):]: v for k, v in gaps.items()
              if k.startswith("control_")} if control else gaps
    checks = [(k, judged.get(k, float("inf")), lim)
              for k, lim in limits.items()]
    checks.append(("failed", float(failed), 0.0))
    correct = bool(served) and all(v <= lim for _, v, lim in checks)
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "e2e": e2e, "ctx": ctx, "checks": checks,
           "memory_peak_bytes": peak, "gaps": gaps,
           "served_tokens": sum(len(o) for _, o in served),
           "notes": {"requests": len(in_win), "steps": steps,
                     "ttft_p95_ms": 1e3 * p95(firsts) if firsts else None,
                     "tpot_p95_ms": 1e3 * p95(tpot) if tpot else None}}
    return out
