"""Deterministic, restart-safe data pipelines (counterpart of
``repro/train/data.py``, a copy in numpy).

* ``SyntheticTokens`` — counter-based RNG (Philox): batch(step) is a pure
  function of (seed, step, host), so a restarted job replays the exact
  token stream from its checkpointed cursor with zero saved state.  The
  same Philox counters as the reference's, so both packages draw the same
  batches bit for bit.
* ``MemmapTokens`` — memory-mapped binary token corpus with a step cursor.
* Both shard rows across hosts by process index; :func:`to_device` moves
  one host's batch to the device, and :func:`make_global_batch` makes
  the ranks' rows one batch-sharded DTensor (the reference's
  ``make_global_batch``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticTokens:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    with_labels: bool = True

    def batch(self, step: int, host: int = 0, num_hosts: int = 1
              ) -> Dict[str, np.ndarray]:
        rows = self.global_batch // num_hosts
        rng = np.random.Generator(np.random.Philox(
            key=self.seed, counter=(step * 1_000_003 + host)))
        toks = rng.integers(0, self.vocab, (rows, self.seq_len + 1),
                            dtype=np.int32)
        out = {"tokens": toks[:, :-1]}
        if self.with_labels:
            out["labels"] = toks[:, 1:]
        return out


@dataclasses.dataclass
class MemmapTokens:
    path: str
    seq_len: int
    global_batch: int
    dtype: str = "int32"
    _mm: Optional[np.memmap] = None

    def __post_init__(self):
        self._mm = np.memmap(self.path, dtype=self.dtype, mode="r")

    def batch(self, step: int, host: int = 0, num_hosts: int = 1
              ) -> Dict[str, np.ndarray]:
        rows = self.global_batch // num_hosts
        span = self.seq_len + 1
        n_tokens = self._mm.shape[0]
        per_step = self.global_batch * span
        base = (step * per_step + host * rows * span) % max(
            n_tokens - per_step, 1)
        flat = np.asarray(self._mm[base:base + rows * span]).astype(np.int32)
        toks = flat.reshape(rows, span)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def to_device(host_batch: Dict[str, np.ndarray],
              device) -> Dict[str, torch.Tensor]:
    """One host's batch on ``device``: token and label ids as int64 (torch
    indexes and gathers by them), anything else in its dtype."""
    out = {}
    for k, v in host_batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def make_global_batch(local_batch: Dict[str, torch.Tensor], mesh,
                      placements: Dict[str, tuple]
                      ) -> Dict[str, torch.Tensor]:
    """Each rank's rows (``to_device`` of ``batch(step, host, num_hosts)``
    with ``host, num_hosts = spmd.shard_coordinate(mesh, placements[k])``)
    as one global batch DTensor a key, laid out by ``placements`` (the
    rules' ``data_shardings``): the global batch is the ranks' rows in
    order of their batch coordinate.  No collective: each rank's shard is
    its own rows."""
    from repro_torch.parallel import spmd
    out = {}
    for k, v in local_batch.items():
        pl = placements[k]
        n = spmd.shard_coordinate(mesh, pl)[1]
        shape = (v.shape[0] * n,) + tuple(v.shape[1:])
        out[k] = spmd.from_local(v, mesh, pl, shape)
    return out
