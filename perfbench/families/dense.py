"""The dense decoder family (OLMo): [attention + SwiGLU MLP] blocks.

Everything of the harness that depends on this structure: the port's
``ModelConfig`` and its ``lm.DenseLM`` parameter tree, the seeded
weights of one layer and of the embedding and head, and the GEMMs one
pass and one train step need.  ``spec.family`` finds this file by the
configuration's ``family`` key; ``program``, ``weights`` and
``work/counts`` call it under their own names.

Nothing of the program is imported at module level: the plain
reference draws its weights through this file too.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from perfbench import weights
from perfbench.work.counts import Gemm


def port_config(doc: Dict[str, Any]):
    """The configuration file as the port's ``ModelConfig``."""
    from repro_torch.configs.base import AttentionPattern, ModelConfig
    cfg = ModelConfig(
        name=doc["name"], family=doc["family"], n_layers=doc["n_layers"],
        d_model=doc["d_model"], n_heads=doc["n_heads"],
        n_kv_heads=doc["n_kv_heads"], head_dim=doc["head_dim"],
        d_ff=doc["d_ff"], vocab=doc["vocab"],
        attn=AttentionPattern(**doc["attn"]),
        rope_theta=doc["rope_theta"], norm_eps=doc["norm_eps"],
        parametric_norm=doc["parametric_norm"],
        tie_embeddings=doc["tie_embeddings"], dtype=doc["dtype"],
        param_dtype=doc["param_dtype"], remat=doc["remat"])
    if cfg.vocab_padded != doc["vocab_rows"]:
        raise ValueError(f"{doc['name']}: the port pads the vocabulary to "
                         f"{cfg.vocab_padded} rows, the file says "
                         f"{doc['vocab_rows']}")
    return cfg


def port_params(doc: Dict[str, Any], seed: int, dtype, device):
    """The seeded weights (:func:`layer`/:func:`outer`) as the port's
    ``DenseLM``: matrices in ``dtype`` (the compute dtype to serve, f32
    for a trainer's master copy), norm weights in f32."""
    from repro_torch.models import lm
    blocks = []
    for i in range(doc["n_layers"]):
        w = layer(doc, seed, i, dtype, device)
        attn = lm.Attention(w["attn.wq"], w["attn.wk"], w["attn.wv"],
                            w["attn.wo"])
        blocks.append(lm.Block(attn, lm.MLP(w["mlp.wg"], w["mlp.wu"],
                                            w["mlp.wd"]),
                               w.get("ln1"), w.get("ln2")))
    o = outer(doc, seed, dtype, device)
    return lm.DenseLM(o["embed"], blocks, o.get("final_norm"),
                      o.get("unembed"))


# -- seeded weights ---------------------------------------------------------

def layer_shapes(doc) -> weights.Shapes:
    """(name, shape, std) of one layer's matrices, in drawing order."""
    d, H, Hkv, hd = (doc["d_model"], doc["n_heads"], doc["n_kv_heads"],
                     doc["head_dim"])
    L = doc["n_layers"]
    s = 1.0 / math.sqrt(d)
    so = 1.0 / math.sqrt(H * hd) / math.sqrt(2.0 * L)
    out = [("attn.wq", (d, H * hd), s), ("attn.wk", (d, Hkv * hd), s),
           ("attn.wv", (d, Hkv * hd), s), ("attn.wo", (H * hd, d), so)]
    ff = doc["d_ff"]
    sd = 1.0 / math.sqrt(ff) / math.sqrt(2.0 * L)
    return out + [("mlp.wg", (d, ff), s), ("mlp.wu", (d, ff), s),
                  ("mlp.wd", (ff, d), sd)]


def outer_shapes(doc) -> weights.Shapes:
    d, V = doc["d_model"], doc["vocab_rows"]
    out = [("embed", (V, d), d ** -0.5)]
    if not doc["tie_embeddings"]:
        out.append(("unembed", (d, V), 1.0 / math.sqrt(d)))
    return out


def layer(doc, seed: int, i: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights: matrices in ``dtype``, norm weights (f32
    ones) where the configuration has them."""
    out = weights.draw(layer_shapes(doc),
                       weights.generator(seed, i + 1, device), dtype, device)
    if doc["parametric_norm"]:
        for name in ("ln1", "ln2"):
            out[name] = torch.ones(doc["d_model"], dtype=torch.float32,
                                   device=device)
    return out


def outer(doc, seed: int, dtype, device) -> Dict[str, torch.Tensor]:
    """The embedding, the untied head and the final norm's weight."""
    out = weights.draw(outer_shapes(doc), weights.generator(seed, 0, device),
                       dtype, device)
    if doc["parametric_norm"]:
        out["final_norm"] = torch.ones(doc["d_model"], dtype=torch.float32,
                                       device=device)
    return out


# -- work counts ------------------------------------------------------------

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


def matmul_params(doc) -> float:
    """Parameters one token multiplies: every layer's projections and the
    head."""
    n = sum(K * N for K, N in layer_projections(doc)) * doc["n_layers"]
    return float(n + doc["d_model"] * doc["vocab_rows"])


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
