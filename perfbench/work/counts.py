"""Operations and bytes of the work a cell's traffic needs, from shapes
alone: what every roofline share and every ``mfu`` number divides by.

A GEMM of (M, K) by (K, N) needs 2 M K N operations and moves each
input byte once and each output byte once: (M K + K N + M N) elements of
the configuration's dtype.  Its least time on the card is the larger of
operations over the peak rate and bytes over the memory rate
(``peaks.json``).  The count is of the work, whatever implements it: a
GEMM that moves from one kernel to another keeps its count.  Which GEMMs
a pass or a train step needs is the configuration's family's
(``perfbench/families/<family>.py``); the arithmetic on them is here.
"""
from __future__ import annotations

import json
import pathlib
from typing import List, Tuple

import numpy as np

from perfbench import spec

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


def pass_gemms(doc, rows: int, head: bool = True) -> List[Gemm]:
    """The GEMMs of one model pass over ``rows`` token rows, as the
    configuration's family counts them."""
    return spec.family(doc["family"]).pass_gemms(doc, rows, head)


def gemms_bound_s(gemms: List[Gemm], e: int) -> float:
    return sum(bound_s(gemm_flops(*g), gemm_bytes(*g, e)) for g in gemms)


def gemms_flops(gemms: List[Gemm]) -> float:
    return sum(gemm_flops(*g) for g in gemms)


def gemms_weight_bytes(gemms: List[Gemm], e: int) -> float:
    return sum(float(K * N) * e for _, K, N in gemms)


def matmul_params(doc) -> float:
    """Parameters one token multiplies, as the configuration's family
    counts them."""
    return spec.family(doc["family"]).matmul_params(doc)


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
    """Every GEMM one train step needs at B x S token rows, as the
    configuration's family counts them."""
    return spec.family(doc["family"]).train_step_gemms(doc, batch, seq)
