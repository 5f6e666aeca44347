"""Weights from the seed, made on the device, one layer at a time.

Each layer's matrices are drawn into one flat buffer in the dtype they
are used in, by a ``torch.Generator`` seeded from (seed, layer), one
``normal_`` call a matrix (:func:`draw`); norm weights are ones.  So the
program's set-up draws every layer once, and the plain reference draws
any layer again, alone, with the same values, after the program's state
is freed.  Which matrices a layer has, their shapes, scales and drawing
order are the family's (``perfbench/families/<family>.py``); scales are
the repository's (``assumed`` in each configuration file).

Imports torch and nothing of the program (nor does a family file at
module level): the reference draws its weights here too.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from perfbench import spec

Shapes = List[Tuple[str, Tuple[int, ...], float]]


def generator(seed: int, tag: int, device) -> torch.Generator:
    """A generator for (seed, tag); seeds may pass 32 bits."""
    s = ((int(seed) % (1 << 61)) * 1_000_003 + int(tag) * 7_919 + 17) \
        % ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(s)


def draw(shapes: Shapes, g: torch.Generator, dtype,
         device) -> Dict[str, torch.Tensor]:
    """Tensors of ``shapes`` (name, shape, std), normal about 0, drawn
    from ``g`` in order into one flat buffer of ``dtype``."""
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
    """Layer ``i``'s weights, as the configuration's family draws them."""
    return spec.family(doc["family"]).layer(doc, seed, i, dtype, device)


def outer(doc, seed: int, dtype, device) -> Dict[str, torch.Tensor]:
    """The weights outside the layers (embedding, head, final norm), as
    the configuration's family draws them."""
    return spec.family(doc["family"]).outer(doc, seed, dtype, device)
