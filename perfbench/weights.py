"""Weights from the seed, made on the device, one layer at a time.

Each layer's matrices are drawn into one flat buffer in the dtype they
are used in, by a ``torch.Generator`` seeded from (seed, layer), one
``normal_`` call a matrix; norm weights are ones.  So the program's set-up draws every layer once,
and the plain reference draws any layer again, alone, with the same
values, after the program's state is freed.  Scales are the
repository's (``assumed`` in each configuration file).

Imports torch only: the reference uses it.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

Shapes = List[Tuple[str, Tuple[int, ...], float]]


def generator(seed: int, tag: int, device) -> torch.Generator:
    """A generator for (seed, tag); seeds may pass 32 bits."""
    s = ((int(seed) % (1 << 61)) * 1_000_003 + int(tag) * 7_919 + 17) \
        % ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(s)


def layer_shapes(doc) -> Shapes:
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


def outer_shapes(doc) -> Shapes:
    d, V = doc["d_model"], doc["vocab_rows"]
    out = [("embed", (V, d), d ** -0.5)]
    if not doc["tie_embeddings"]:
        out.append(("unembed", (d, V), 1.0 / math.sqrt(d)))
    return out


def _draw(shapes: Shapes, g: torch.Generator, dtype,
          device) -> Dict[str, torch.Tensor]:
    n = sum(math.prod(shape) for _, shape, _ in shapes)
    flat = torch.empty(n, dtype=dtype, device=device)
    out, at = {}, 0
    for name, shape, std in shapes:
        k = math.prod(shape)
        out[name] = flat[at:at + k].view(shape).normal_(0.0, std,
                                                        generator=g)
        at += k
    return out


def layer(doc, seed: int, i: int, dtype, device) -> Dict[str, torch.Tensor]:
    """Layer ``i``'s weights: matrices in ``dtype``, norm weights (f32
    ones) where the configuration has them."""
    out = _draw(layer_shapes(doc), generator(seed, i + 1, device), dtype,
                device)
    if doc["parametric_norm"]:
        for name in ("ln1", "ln2"):
            out[name] = torch.ones(doc["d_model"], dtype=torch.float32,
                                   device=device)
    return out


def outer(doc, seed: int, dtype, device) -> Dict[str, torch.Tensor]:
    """The embedding, the untied head and the final norm's weight."""
    out = _draw(outer_shapes(doc), generator(seed, 0, device), dtype,
                device)
    if doc["parametric_norm"]:
        out["final_norm"] = torch.ones(doc["d_model"], dtype=torch.float32,
                                       device=device)
    return out
