"""The program under test, ``repro_torch``, reached through its public
entry points: ``registry.build`` on a ``ModelConfig`` made from the
configuration file, the seeded weights placed into its parameter tree
(``lm.DenseLM``).  Nothing the reference compares against comes from
here."""
from __future__ import annotations

from typing import Any, Dict

import torch

from perfbench import weights


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
    """The seeded weights (``weights.layer``/``weights.outer``) as the
    port's ``DenseLM``: matrices in ``dtype`` (the compute dtype to
    serve, f32 for a trainer's master copy), norm weights in f32."""
    from repro_torch.models import lm
    blocks = []
    for i in range(doc["n_layers"]):
        w = weights.layer(doc, seed, i, dtype, device)
        attn = lm.Attention(w["attn.wq"], w["attn.wk"], w["attn.wv"],
                            w["attn.wo"])
        blocks.append(lm.Block(attn, lm.MLP(w["mlp.wg"], w["mlp.wu"],
                                            w["mlp.wd"]),
                               w.get("ln1"), w.get("ln2")))
    o = weights.outer(doc, seed, dtype, device)
    return lm.DenseLM(o["embed"], blocks, o.get("final_norm"),
                      o.get("unembed"))


def free_cuda():
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
