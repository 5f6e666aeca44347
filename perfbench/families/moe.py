"""The sparse-expert decoder family (Mixtral): [attention + MoE] blocks.

Everything of the harness that depends on this structure: the port's
``ModelConfig`` (with its ``MoEConfig``) and its ``lm.DenseLM`` parameter
tree of ``lm.Block(attention, None, ln1, ln2, lm.MoE(...))``, the
seeded weights of one layer and of the embedding and untied head, the
GEMMs of a pass and of a train step, and the expert work that
``expert_roofline.serve`` divides by.  ``spec.family`` finds this file by
the configuration's ``family`` key.

Each layer draws from its own generator, in this order: the bf16
matrices (q, k, v, o, then the experts' gate, up and down) into one
buffer, then the f32 ones (the router, then the two norm gains, drawn as
1 + 0.1 N(0, 1) so that a dropped gain shows in the check).  Nothing of
the program is imported at module level: the plain reference draws its
weights through this file too.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from perfbench import weights
from perfbench.work.counts import Gemm

#: the spread of a norm gain about 1
GAIN_STD = 0.1


def port_config(doc: Dict[str, Any]):
    """The configuration file as the port's ``ModelConfig``."""
    from repro_torch.configs.base import (AttentionPattern, ModelConfig,
                                          MoEConfig)
    m = doc["moe"]
    cfg = ModelConfig(
        name=doc["name"], family=doc["family"], n_layers=doc["n_layers"],
        d_model=doc["d_model"], n_heads=doc["n_heads"],
        n_kv_heads=doc["n_kv_heads"], head_dim=doc["head_dim"],
        d_ff=m["d_expert"], vocab=doc["vocab"],
        attn=AttentionPattern(**doc["attn"]),
        moe=MoEConfig(num_experts=m["num_experts"], top_k=m["top_k"],
                      d_expert=m["d_expert"], dropless=m["dropless"]),
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
    ``DenseLM``: matrices and experts in ``dtype``, the router and the
    norm gains in f32 (as the port keeps them)."""
    from repro_torch.models import lm
    blocks = []
    for i in range(doc["n_layers"]):
        w = layer(doc, seed, i, dtype, device)
        attn = lm.Attention(w["attn.wq"], w["attn.wk"], w["attn.wv"],
                            w["attn.wo"])
        moe = lm.MoE(w["moe.router"], w["moe.w_gate"], w["moe.w_up"],
                     w["moe.w_down"])
        blocks.append(lm.Block(attn, None, w["ln1"], w["ln2"], moe))
    o = outer(doc, seed, dtype, device)
    return lm.DenseLM(o["embed"], blocks, o["final_norm"], o["unembed"])


# -- seeded weights ---------------------------------------------------------

def layer_shapes(doc) -> weights.Shapes:
    """(name, shape, std) of one layer's matrices in the compute dtype,
    in drawing order: the port's init scales (``layers.init_moe``)."""
    d, H, Hkv, hd = (doc["d_model"], doc["n_heads"], doc["n_kv_heads"],
                     doc["head_dim"])
    E, f = doc["moe"]["num_experts"], doc["moe"]["d_expert"]
    L = doc["n_layers"]
    s = 1.0 / math.sqrt(d)
    so = 1.0 / math.sqrt(H * hd) / math.sqrt(2.0 * L)
    sd = 1.0 / math.sqrt(f) / math.sqrt(2.0 * L)
    return [("attn.wq", (d, H * hd), s), ("attn.wk", (d, Hkv * hd), s),
            ("attn.wv", (d, Hkv * hd), s), ("attn.wo", (H * hd, d), so),
            ("moe.w_gate", (E, d, f), s), ("moe.w_up", (E, d, f), s),
            ("moe.w_down", (E, f, d), sd)]


def f32_shapes(doc) -> weights.Shapes:
    """(name, shape, std) of one layer's f32 tensors, drawn after the
    matrices: the router, then the norm gains' spread about 1."""
    d, E = doc["d_model"], doc["moe"]["num_experts"]
    return [("moe.router", (d, E), 1.0 / math.sqrt(d)),
            ("ln1", (d,), GAIN_STD), ("ln2", (d,), GAIN_STD)]


def outer_shapes(doc) -> weights.Shapes:
    d, V = doc["d_model"], doc["vocab_rows"]
    return [("embed", (V, d), d ** -0.5), ("unembed", (d, V),
                                           1.0 / math.sqrt(d))]


def _gains(out: Dict[str, torch.Tensor], names) -> None:
    for n in names:
        out[n].add_(1.0)


def layer(doc, seed: int, i: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights: matrices and experts in ``dtype``, the
    router and the norm gains in f32."""
    g = weights.generator(seed, i + 1, device)
    out = weights.draw(layer_shapes(doc), g, dtype, device)
    extra = weights.draw(f32_shapes(doc), g, torch.float32, device)
    _gains(extra, ("ln1", "ln2"))
    out.update(extra)
    return out


def outer(doc, seed: int, dtype, device) -> Dict[str, torch.Tensor]:
    """The embedding, the untied head (in ``dtype``) and the final norm's
    gain (f32)."""
    g = weights.generator(seed, 0, device)
    out = weights.draw(outer_shapes(doc), g, dtype, device)
    extra = weights.draw([("final_norm", (doc["d_model"],), GAIN_STD)], g,
                         torch.float32, device)
    _gains(extra, ("final_norm",))
    out.update(extra)
    return out


# -- work counts ------------------------------------------------------------

def layer_projections(doc) -> List[Tuple[int, int]]:
    """(K, N) of one layer's dense GEMMs: q, k, v, o and the router (an
    f32 GEMM; counted here and timed as an ``aten::mm``)."""
    d, H, Hkv, hd = (doc["d_model"], doc["n_heads"], doc["n_kv_heads"],
                     doc["head_dim"])
    return [(d, H * hd), (d, Hkv * hd), (d, Hkv * hd), (H * hd, d),
            (d, doc["moe"]["num_experts"])]


def expert_matrices(doc) -> List[Tuple[int, int]]:
    """(K, N) of one expert's gate, up and down."""
    d, f = doc["d_model"], doc["moe"]["d_expert"]
    return [(d, f), (d, f), (f, d)]


def pass_gemms(doc, rows: int, head: bool = True) -> List[Gemm]:
    """The dense GEMMs of one model pass over ``rows`` token rows: every
    layer's projections and router, then the vocabulary head.  The
    experts are not here: ``expert_work`` counts them."""
    per = layer_projections(doc)
    g = [(rows, K, N) for _ in range(doc["n_layers"]) for K, N in per]
    if head:
        g.append((rows, doc["d_model"], doc["vocab_rows"]))
    return g


def matmul_params(doc) -> float:
    """Parameters one token multiplies: every layer's projections and
    router, its top-k experts' three matrices, and the head."""
    k = doc["moe"]["top_k"]
    per = sum(K * N for K, N in layer_projections(doc)) + \
        k * sum(K * N for K, N in expert_matrices(doc))
    return float(per * doc["n_layers"] + doc["d_model"] * doc["vocab_rows"])


def expert_work(doc, pairs: int, touched: int, e: int) -> Tuple[float,
                                                                  float]:
    """(operations, bytes) of the expert FFN over ``pairs`` routed (token,
    expert) rows that reached ``touched`` experts (summed over calls):
    each touched expert's three matrices read once; each row's gate and
    up read its input and write their outputs, down reads the SwiGLU's
    output and writes its own; 2 K N operations a row and matrix.  The
    same work whatever layout computes it."""
    mats = expert_matrices(doc)
    d, f = doc["d_model"], doc["moe"]["d_expert"]
    flops = 2.0 * pairs * sum(K * N for K, N in mats)
    weight = float(touched) * sum(K * N for K, N in mats)
    rows = float(pairs) * (2 * d + 2 * f + f + d)
    return flops, (weight + rows) * e


def train_step_gemms(doc, batch: int, seq: int) -> List[Gemm]:
    """Every GEMM one train step needs at B x S token rows: each layer's
    dense GEMMs forward twice (remat ``full``) and their two backward
    products, the experts' as E GEMMs of B S k / E rows each (the routed
    rows, spread evenly) likewise, and the head's forward and backward
    products."""
    M = batch * seq
    m = doc["moe"]
    rows = M * m["top_k"] // m["num_experts"]
    times = 2 if doc["remat"] == "full" else 1
    out: List[Gemm] = []
    for _ in range(doc["n_layers"]):
        mats = [(M, K, N) for K, N in layer_projections(doc)] + \
            [(rows, K, N) for _ in range(m["num_experts"])
             for K, N in expert_matrices(doc)]
        for R, K, N in mats:
            out += [(R, K, N)] * times + [(R, N, K), (K, R, N)]
    d, V = doc["d_model"], doc["vocab_rows"]
    out += [(M, d, V), (M, V, d), (d, M, V)]
    return out
