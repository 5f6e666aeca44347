"""Operations and bytes of the work a cell's traffic needs, from shapes
alone: what every roofline share and every ``mfu`` number divides by.

A GEMM of (M, K) by (K, N) needs 2 M K N operations and moves each
input byte once and each output byte once: (M K + K N + M N) elements of
the configuration's dtype.  Its least time on the card is the larger of
operations over the peak rate and bytes over the memory rate
(``peaks.json``).  The count is of the work, whatever implements it: a
GEMM that moves from one kernel to another keeps its count.
"""
from __future__ import annotations

import json
import pathlib
from typing import List, Tuple

import numpy as np

PEAKS = json.loads((pathlib.Path(__file__).resolve().parent
                    / "peaks.json").read_text())

Gemm = Tuple[int, int, int]                      # (M, K, N)

_ELT = {"bfloat16": 2, "float16": 2, "float32": 4}


def elt(doc) -> int:
    return _ELT[doc["dtype"]]


def gemm_flops(M: int, K: int, N: int) -> float:
    return 2.0 * M * K * N


def gemm_bytes(M: int, K: int, N: int, e: int) -> float:
    return float(M * K + K * N + M * N) * e


def bound_s(flops: float, nbytes: float, peaks=PEAKS) -> float:
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])


def layer_projections(doc) -> List[Tuple[int, int]]:
    """(K, N) of one layer's dense projections: q, k, v, o, and the MLP's
    gate, up and down."""
    d, H, Hkv, hd, ff = (doc["d_model"], doc["n_heads"], doc["n_kv_heads"],
                         doc["head_dim"], doc["d_ff"])
    return [(d, H * hd), (d, Hkv * hd), (d, Hkv * hd), (H * hd, d),
            (d, ff), (d, ff), (ff, d)]


def pass_gemms(doc, rows: int, head: bool = True) -> List[Gemm]:
    """The dense GEMMs of one model pass over ``rows`` token rows: every
    layer's projections, then the vocabulary head."""
    per = layer_projections(doc)
    g = [(rows, K, N) for _ in range(doc["n_layers"]) for K, N in per]
    if head:
        g.append((rows, doc["d_model"], doc["vocab_rows"]))
    return g


def gemms_bound_s(gemms: List[Gemm], e: int) -> float:
    return sum(bound_s(gemm_flops(*g), gemm_bytes(*g, e)) for g in gemms)


def gemms_flops(gemms: List[Gemm]) -> float:
    return sum(gemm_flops(*g) for g in gemms)


def gemms_weight_bytes(gemms: List[Gemm], e: int) -> float:
    return sum(float(K * N) * e for _, K, N in gemms)


def matmul_params(doc) -> float:
    """Parameters one token multiplies: every layer's projections and the
    head."""
    n = sum(K * N for K, N in layer_projections(doc)) * doc["n_layers"]
    return float(n + doc["d_model"] * doc["vocab_rows"])


def tokens_flops(doc, pos) -> float:
    """Forward operations of the tokens at positions ``pos`` (an array):
    two a multiplied parameter, and attention's score and value products
    (4 H hd a key; a token at position p sees p + 1 keys, at most the
    window)."""
    pos = np.asarray(pos, dtype=np.int64)
    w = doc["attn"].get("window")
    keys = pos + 1 if w is None else np.minimum(pos + 1, w)
    return float(len(pos) * 2.0 * matmul_params(doc) + 4.0 * doc["n_layers"]
                 * doc["n_heads"] * doc["head_dim"] * float(keys.sum()))


def train_step_flops(doc, batch: int, seq: int) -> float:
    """Model operations of one train step, recompute not counted: three
    times the forward (forward, and the backward's two products)."""
    fwd = batch * tokens_flops(doc, np.arange(seq))
    return 3.0 * fwd


def train_step_gemms(doc, batch: int, seq: int) -> List[Gemm]:
    """Every dense GEMM one train step needs at B x S token rows: each
    layer's forward projections twice (the forward and, under remat,
    its recompute), each projection's two backward products (the input's
    gradient, M x N x K, and the weight's, K x M x N), and the head's
    forward and two backward products."""
    M = batch * seq
    out: List[Gemm] = []
    layers = [(K, N) for _ in range(doc["n_layers"])
              for K, N in layer_projections(doc)]
    times = 2 if doc["remat"] == "full" else 1
    for K, N in layers:
        out += [(M, K, N)] * times + [(M, N, K), (K, M, N)]
    d, V = doc["d_model"], doc["vocab_rows"]
    out += [(M, d, V), (M, V, d), (d, M, V)]
    return out
