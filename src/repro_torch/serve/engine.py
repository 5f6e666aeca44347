"""The slot-level paged serving engine (counterpart of
``repro/serve/engine.py::PagedEngine``).

Decode-time projections are (B x d) @ (d x N) GEMMs with tiny B — the
paper's small-GEMM regime.  The engine takes ONE
:class:`repro_torch.api.Policy` at construction.

Per :meth:`PagedEngine.step`: admit queued requests into free slots, run
ONE decode step over every decoding slot (sampling on the device, tokens
drained asynchronously every ``drain_every`` steps by holding the device
tensors in between), and run ONE prefill chunk for the oldest prefilling
request.  Block exhaustion preempts the youngest sequence (recompute
resume).  The step functions run eagerly: PyTorch has no ``jit`` to
stage, and the pools are updated in place instead of donated.

The wave ``ContinuousBatcher`` is not ported yet.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import api, obs
from repro_torch.api import Policy
from repro_torch.models.registry import Model
from repro_torch.serve import sched
from repro_torch.serve.paged import CacheMap, OutOfBlocks, SlotStateStore


def sample(logits, generator: torch.Generator, temperature: float = 0.0):
    """Next tokens from logits (..., V) on their device: argmax at
    temperature 0 (first maximum on ties, as ``jnp.argmax``), else a draw
    from softmax(logits / T) with ``generator``."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    flat = probs.reshape(-1, probs.shape[-1])
    out = torch.multinomial(flat, 1, generator=generator)
    return out.reshape(probs.shape[:-1])


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (S,)
    max_new: int = 32
    out: Optional[List[int]] = None
    t_submit: float = 0.0              # perf_counter stamp set by submit()


def _round_up(n: int, m: int) -> int:
    return -(n // -m) * m


class PagedEngine:
    """Slot-level continuous batching over a paged KV cache (see module
    docstring).  ``device`` defaults to the card; tests pass ``"cpu"``."""

    TICK_SAMPLE = 8

    def __init__(self, model: Model, params, be: Optional[Policy] = None,
                 *, slots: int = 4, max_len: int = 256, eos: int = 2,
                 temperature: float = 0.0, seed: int = 0,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 chunk: int = 32, drain_every: int = 4, device="cuda"):
        be = be if be is not None else api.current_policy()
        self.model, self.params, self.be = model, params, be
        self.device = torch.device(device)
        self.slots, self.max_len, self.eos = slots, max_len, eos
        self.temperature, self.chunk = temperature, chunk
        self.drain_every = max(1, drain_every)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        # table width covers max_len, rounded so prefill pad rows (the
        # chunk tail past the prompt) always have a backing block
        table_len = _round_up(_round_up(max_len, block_size), chunk)
        if num_blocks is None:
            num_blocks = 1 + slots * (table_len // block_size)
        self.cache = CacheMap(num_blocks, block_size, table_len)
        self.state = SlotStateStore(slots)
        self.scheduler = sched.SlotScheduler(self.cache, slots, self.state)
        self.done: Dict[int, List[int]] = {}
        self._decode_steps = 0
        self._ps = model.init_paged_state(num_blocks, block_size, slots,
                                          model.cfg.compute_dtype,
                                          self.device)
        self._cur = torch.zeros((slots,), dtype=torch.long,
                                device=self.device)
        # (token tensor, [(seq, slot)]) per issued decode step, drained in
        # order; holding the device tensors (instead of copying each step
        # to the host) is what lets device steps pipeline
        self._pending: List[tuple] = []

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        """Host array to the engine's device without stalling the stream
        (pinned staging; the caching host allocator keeps the buffer alive
        until the copy has run)."""
        t = torch.from_numpy(arr)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- API -----------------------------------------------------------------

    def submit(self, req: Request) -> None:
        req.t_submit = time.perf_counter()
        if len(req.prompt) + req.max_new > self.max_len:
            raise ValueError(f"request {req.rid} exceeds max_len "
                             f"{self.max_len}")
        obs.counter("serve.requests").inc()
        obs.TRACE.emit("REQ_ARRIVE", rid=req.rid,
                       arg=(len(req.prompt), req.max_new))
        seq = sched.Seq(req=req)
        # worst-case footprint: the longest possible resume target
        # prefilled with a chunk-padded tail
        worst = _round_up(
            max(1, len(req.prompt) + req.max_new - 1), self.chunk)
        self.scheduler.submit(seq, fit_tokens=worst)

    def step(self) -> bool:
        """One scheduler iteration; False when fully idle."""
        worked = False
        now = time.perf_counter()
        for seq in self.scheduler.admit():
            worked = True
            if not seq.admitted_once:
                seq.admitted_once = True
                obs.histogram("serve.admission_wait_us").record(
                    (now - seq.req.t_submit) * 1e6)
        dec = [q for q in self.scheduler.decoding() if q.budget_left > 0]
        for q in list(dec):
            if q.state == sched.DECODE:
                self._ensure(q, q.pos + 1)
        dec = [q for q in self.scheduler.decoding() if q.budget_left > 0]
        if dec:
            self._issue_decode(dec)
            worked = True
        pre = self.scheduler.next_prefill()
        if pre is not None:
            self._prefill_chunk(pre)
            worked = True
        if self._pending and (
                len(self._pending) >= self.drain_every
                or not any(q.budget_left > 0
                           for q in self.scheduler.decoding())):
            self._drain()
        if worked:
            obs.histogram("serve.slot_occupancy").record(
                self.scheduler.active() / self.slots)
            obs.histogram("serve.queue_depth").record(
                len(self.scheduler.queue))
            obs.gauge("serve.blocks_in_use").set(self.cache.blocks_in_use)
        return worked

    def run(self) -> Dict[int, List[int]]:
        stall = 0
        while True:
            if self.step():
                stall = 0
                continue
            if self._pending:
                self._drain()
                continue
            if not self.scheduler.has_work():
                break
            stall += 1
            if stall > 10000:   # fail loudly, never hang
                raise RuntimeError("paged engine stalled: "
                                   f"{self.scheduler.active()} live, "
                                   f"{len(self.scheduler.queue)} queued")
        return self.done

    # -- internals ---------------------------------------------------------

    def _ensure(self, seq: sched.Seq, n_tokens: int) -> bool:
        """Back ``seq`` with blocks for ``n_tokens`` positions, preempting
        (youngest first) on exhaustion.  False when ``seq`` itself was the
        victim (it is re-queued; stop working on it)."""
        drained = False
        while True:
            try:
                self.cache.ensure(seq.rid, n_tokens)
                return True
            except OutOfBlocks:
                if not drained and self._pending:
                    self._drain()      # EOS finishes may free blocks
                    drained = True
                    if seq.state != sched.DECODE and \
                            seq.state != sched.PREFILL:
                        return False   # finished during the drain
                    continue
                self._drain()
                victim = self.scheduler.preempt_victim(seq)
                if victim is None:
                    raise RuntimeError("block pool exhausted with no "
                                       "active sequence to preempt")
                if victim is seq and self.scheduler.active() == 1:
                    raise RuntimeError(
                        "block pool exhausted by a single sequence that "
                        "passed the admission fit check — pool leak?")
                self.scheduler.preempt(victim)
                if victim is seq:
                    return False

    def _issue_decode(self, dec: List[sched.Seq]) -> None:
        bt = np.zeros((self.slots, self.cache.nmax), np.int64)
        pos = np.zeros((self.slots,), np.int64)
        for q in dec:
            bt[q.slot] = self.cache.row(q.rid)
            pos[q.slot] = q.pos
        with torch.no_grad():
            logits = self.model.paged_decode(
                self.params, self._cur[:, None], self._ps, self._dev(bt),
                self._dev(pos), self.be)
            self._cur = sample(logits[:, -1], self.gen, self.temperature)
        self._pending.append((self._cur, [(q, q.slot) for q in dec]))
        self._decode_steps += 1
        if obs.TRACE.on and self._decode_steps % self.TICK_SAMPLE == 0:
            obs.TRACE.emit("DECODE_TICK",
                           arg=(self._decode_steps, len(dec)))
        for q in dec:
            q.pos += 1
            q.inflight += 1

    def _prefill_chunk(self, seq: sched.Seq) -> None:
        p0, C = seq.pos, self.chunk
        if not self._ensure(seq, p0 + C):
            return                      # preempted itself; re-queued
        target = seq.target
        segment = target[p0:p0 + C]
        toks = np.zeros((1, C), np.int64)
        toks[0, :len(segment)] = segment
        final = (p0 + len(segment)) == len(target)
        t_chunk = time.perf_counter()
        with torch.no_grad():
            logits = self.model.paged_prefill(
                self.params, self._dev(toks), self._ps,
                self._dev(self.cache.row(seq.rid)[None].astype(np.int64)),
                self._dev(np.array([p0], np.int64)), len(seq.req.prompt),
                self.be)
        seq.pos = p0 + len(segment)
        obs.counter("serve.prefill_chunks").inc()
        obs.TRACE.emit(
            "PREFILL_CHUNK", rid=seq.rid, slot=seq.slot,
            arg=(p0, len(segment)),
            dur_us=(time.perf_counter() - t_chunk) * 1e6)
        if not final:
            return
        # host-side sample for the prefill boundary token only — every
        # later token is sampled on the device in the decode step
        row = logits[0, len(segment) - 1]
        tok = int(sample(row, self.gen, self.temperature))
        seq.out.append(tok)
        obs.counter("serve.tokens").inc()
        if len(seq.out) == 1:
            obs.histogram("serve.ttft_us").record(
                (time.perf_counter() - seq.req.t_submit) * 1e6)
            obs.TRACE.emit("FIRST_TOKEN", rid=seq.rid, slot=seq.slot)
        # the request's FIRST token is exempt from EOS (a request always
        # yields at least one token); a post-preemption boundary token is
        # an ordinary decode token and does get the EOS check
        if (tok == self.eos and len(seq.out) > 1) \
                or len(seq.out) >= seq.req.max_new:
            self._finish(seq)
        else:
            seq.state = sched.DECODE
            # a new tensor, not an in-place write: earlier decode steps'
            # token tensors may still wait in _pending
            cur = self._cur.clone()
            cur[seq.slot] = tok
            self._cur = cur

    def _drain(self) -> None:
        """Pull every pending decode token to the host in one pass and
        apply EOS / token-budget eviction."""
        pend, self._pending = self._pending, []
        for arr, entries in pend:
            host = arr.cpu().numpy()
            for q, slot in entries:
                q.inflight -= 1
                if q.state != sched.DECODE:
                    continue            # evicted earlier in this drain
                tok = int(host[slot])
                q.out.append(tok)
                obs.counter("serve.tokens").inc()
                if tok == self.eos or len(q.out) >= q.req.max_new:
                    self._finish(q)

    def _finish(self, seq: sched.Seq) -> None:
        self.done[seq.rid] = seq.out
        obs.histogram("serve.e2e_us").record(
            (time.perf_counter() - seq.req.t_submit) * 1e6)
        obs.TRACE.emit("FINISH", rid=seq.rid, slot=seq.slot,
                       arg=len(seq.out))
        self.scheduler.finish(seq)
