"""The one traffic generator: it reads a mix's parameters
(``perfbench/traffic/<mix>.json``) and the seed, and nothing else.

Serving mixes (``"kind": "serve"``).  Prompt and output lengths are
log-normal with a stated mean and standard deviation, cut to
``[lo, hi]``; they come from a pool of ``pool`` pairs whose lengths are
the pool's quantiles of those distributions, each list in its own order
drawn from the seed: every seed gets the same set of sizes, in another
order, so the seed changes which request comes when, not how much work
a window holds.  Request ``j`` takes pair ``j mod pool`` and a prompt of
token ids uniform over the vocabulary, drawn from (seed, j).  Arrivals
are a closed loop: ``clients`` clients, each sending its next request
when its last one finishes.

Training mixes (``"kind": "train"``).  Step ``j`` takes a batch of
``batch`` x ``seq`` token ids uniform over the vocabulary, drawn on the
device from (seed, j): every row of every step differs.
"""
from __future__ import annotations

import math
import statistics
from typing import Any, Dict, Tuple

import numpy as np
import torch

from perfbench import weights

_TRAIN_TAG = 10_000_000


def _quantiles(dist: Dict[str, Any], n: int) -> np.ndarray:
    """The ``n`` mid-quantiles of a log-normal of the stated ``mean`` and
    ``sd``, rounded and cut to ``[lo, hi]``."""
    if dist["dist"] != "lognormal":
        raise ValueError(f"length distribution {dist['dist']!r}: lognormal")
    sigma = math.sqrt(math.log1p((dist["sd"] / dist["mean"]) ** 2))
    mu = math.log(dist["mean"]) - sigma ** 2 / 2
    z = np.array([statistics.NormalDist().inv_cdf((i + 0.5) / n)
                  for i in range(n)])
    v = np.exp(mu + sigma * z)
    return np.clip(np.rint(v), dist["lo"], dist["hi"]).astype(np.int64)


class ServeTraffic:
    """Requests of a serving mix for one seed."""

    def __init__(self, mix: Dict[str, Any], seed: int, vocab: int):
        if mix["kind"] != "serve":
            raise ValueError(f"not a serving mix: {mix['kind']!r}")
        self.mix, self.seed, self.vocab = mix, int(seed), int(vocab)
        rng = np.random.default_rng([self.seed, 0])
        n = mix["pool"]
        self.prompt_len = rng.permutation(_quantiles(mix["prompt_len"], n))
        self.output_len = rng.permutation(_quantiles(mix["output_len"], n))
        if int((self.prompt_len + self.output_len).max()) > mix["max_len"]:
            raise ValueError("a request of the mix exceeds its max_len")
        self.clients = int(mix["clients"])

    def request(self, j: int) -> Tuple[np.ndarray, int]:
        """(prompt token ids, output length) of request ``j``."""
        i = j % len(self.prompt_len)
        rng = np.random.default_rng([self.seed, 2, j])
        prompt = rng.integers(0, self.vocab, int(self.prompt_len[i]),
                              dtype=np.int64)
        return prompt, int(self.output_len[i])


def train_batch(mix: Dict[str, Any], seed: int, j: int, vocab: int,
                device) -> torch.Tensor:
    """Step ``j``'s (batch, seq) token ids, made on ``device``."""
    g = weights.generator(seed, _TRAIN_TAG + j, device)
    return torch.randint(0, vocab, (mix["batch"], mix["seq"]), generator=g,
                         device=device, dtype=torch.long)
